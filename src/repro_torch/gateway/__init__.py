"""Web gateway — the paper's "integrated system to fully control and
monitor the whole system over web" (see also arXiv:0711.0528, the
web-based interface companion paper).

Stdlib-only HTTP/JSON front-end over a ``ClusterDaemon``: per-user session
profiles with token auth and user-specific defaults (``profiles``), a
request router exposing the full block lifecycle (``handlers``), and a
threaded HTTP server (``server``).  No third-party dependencies — the
container's toolchain is the ceiling.
"""
from repro_torch.gateway.profiles import ProfileStore, UserProfile
from repro_torch.gateway.server import GatewayServer

__all__ = ["GatewayServer", "ProfileStore", "UserProfile"]
