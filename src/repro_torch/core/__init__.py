"""Blocks, topology and the per-block runtime."""
