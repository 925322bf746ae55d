"""Autostep execution engine — daemon-side stepping of RUNNING blocks.

The paper's public cluster runs jobs through per-user daemons: once a
block is RUNNING, the *cluster* makes it progress — the user only watches
(openPC, arXiv:1012.2499, gives the daemon full ownership of job
execution).  Before this package the repo's daemon only ticked: RUNNING
blocks advanced solely when a client POSTed ``/steps``.  The
``AutostepEngine`` closes that gap: an opt-in per-block autostep loop
driven from the ``ClusterDaemon`` pump thread (or inline, deterministically,
for tests) that keeps each enabled block's in-flight dispatch window fed,
paced by a pluggable ``PacingPolicy``.
"""
from repro_torch.engine.autostep import AutostepConfig, AutostepEngine
from repro_torch.engine.pacing import BlockView, PacingPolicy

__all__ = ["AutostepConfig", "AutostepEngine", "BlockView", "PacingPolicy"]
