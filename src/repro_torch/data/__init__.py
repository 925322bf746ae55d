"""Deterministic synthetic data (numpy)."""
