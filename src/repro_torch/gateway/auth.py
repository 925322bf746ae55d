"""Gateway authentication/authorization helpers.

Two token kinds exist and must not be confused: the *session* token in the
``Authorization: Bearer`` header identifies the user (their profile), and
the *block capability* token minted with each grant (the paper's
``MPD_SECRETWORD``) authorizes the confirm step for one specific block.
This module handles only the former; handlers compare the latter.
"""
from __future__ import annotations

from typing import Mapping, Optional

from repro_torch.gateway.profiles import ProfileStore, UserProfile


class AuthError(Exception):
    """401 (who are you) / 403 (not yours)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def bearer_token(headers: Mapping[str, str]) -> Optional[str]:
    auth = headers.get("Authorization") or headers.get("authorization")
    if not auth or not auth.startswith("Bearer "):
        return None
    return auth[len("Bearer "):].strip()


def require_user(headers: Mapping[str, str],
                 store: ProfileStore,
                 query: Optional[Mapping[str, str]] = None) -> UserProfile:
    """Resolve the session.  The bearer header is canonical; an
    ``access_token`` query parameter is accepted too because the browser
    ``EventSource`` API (the dashboard's SSE client) cannot set request
    headers."""
    token = bearer_token(headers)
    if token is None and query is not None:
        token = query.get("access_token")
    profile = store.authenticate(token)
    if profile is None:
        raise AuthError(401, "missing or unknown bearer token")
    return profile


def require_admin(profile: UserProfile) -> UserProfile:
    if not profile.admin:
        raise AuthError(403, f"{profile.user} is not an administrator")
    return profile


def require_owner(profile: UserProfile, owner: str) -> UserProfile:
    """Block-level access: the owner or an admin."""
    if profile.user != owner and not profile.admin:
        raise AuthError(403,
                        f"{profile.user} does not own this block")
    return profile
