"""Per-user session profiles — the paper's "different configuration files
specified for each user".

Each public-cluster user gets a profile holding their auth token and their
user-specific scheduling configuration: default priority, per-user quota
(held-chip cap and chip-second budget), default SLO deadline and default
usage period.  ``apply_quotas`` installs the quota half into the
scheduler's ``SchedulingPolicy`` so admission enforces it; the request
defaults are applied by the gateway handlers when a submission omits the
field — a user never has to restate their own configuration per request.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, Optional


@dataclasses.dataclass
class UserProfile:
    user: str
    token: str                             # gateway auth (bearer) token
    priority: int = 0                      # default admission priority
    max_chips: Optional[int] = None        # quota: concurrent held chips
    max_chip_seconds: Optional[float] = None  # quota: compute budget
    deadline_s: Optional[float] = None     # default SLO deadline
    duration_s: float = 3600.0             # default usage period
    admin: bool = False                    # may review/preempt/resume any
                                           # block and read global feeds

    def public(self) -> Dict:
        """JSON view without the token (served back to the caller)."""
        d = dataclasses.asdict(self)
        del d["token"]
        return d


class ProfileStore:
    """Token -> profile lookup plus policy wiring."""

    def __init__(self, profiles: Iterable[UserProfile] = ()):
        self._by_token: Dict[str, UserProfile] = {}
        self._by_user: Dict[str, UserProfile] = {}
        for p in profiles:
            self.add(p)

    def add(self, profile: UserProfile) -> UserProfile:
        if profile.token in self._by_token:
            raise ValueError(f"duplicate token for {profile.user}")
        self._by_token[profile.token] = profile
        self._by_user[profile.user] = profile
        return profile

    def authenticate(self, token: Optional[str]) -> Optional[UserProfile]:
        if not token:
            return None
        return self._by_token.get(token)

    def for_user(self, user: str) -> Optional[UserProfile]:
        return self._by_user.get(user)

    def __iter__(self):
        return iter(self._by_user.values())

    def __len__(self) -> int:
        return len(self._by_user)

    def apply_quotas(self, policy) -> None:
        """Install every profile's quota into the SchedulingPolicy (the
        enforcement point — the gateway itself never checks quotas)."""
        for p in self._by_user.values():
            if p.max_chips is not None or p.max_chip_seconds is not None:
                policy.set_quota(p.user, max_chips=p.max_chips,
                                 max_chip_seconds=p.max_chip_seconds)

    # ------------------------------------------------------------ persistence
    def snapshot(self) -> list:
        """Full profile dump (tokens included) for the registry-backed
        session store — what lets a restarted gateway keep authenticating
        the same sessions."""
        return [dataclasses.asdict(p) for p in self._by_user.values()]

    def rehydrate(self, dicts: Iterable[Dict]) -> int:
        """Re-add stored profiles that this store doesn't already define.
        Profiles passed to the constructor win (an operator's fresh config
        overrides the snapshot); unknown fields are dropped so older
        snapshots keep loading after UserProfile grows."""
        fields = {f.name for f in dataclasses.fields(UserProfile)}
        n = 0
        for d in dicts or ():
            d = {k: v for k, v in dict(d).items() if k in fields}
            if not d.get("user") or not d.get("token"):
                continue
            if d["user"] in self._by_user or d["token"] in self._by_token:
                continue
            self.add(UserProfile(**d))
            n += 1
        return n

    @classmethod
    def from_file(cls, path: str) -> "ProfileStore":
        """Load profiles from a JSON list of UserProfile field dicts."""
        with open(path) as f:
            return cls(UserProfile(**d) for d in json.load(f))
