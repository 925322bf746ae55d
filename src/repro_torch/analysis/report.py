"""Findings, fingerprints and the baseline diff.

A :class:`Finding` is one analyzer hit.  Its *fingerprint* deliberately
excludes the line number — baselines must survive unrelated edits above a
grandfathered site — and keys on ``(rule, path, symbol)`` plus the detail
discriminator, so two distinct violations inside one function still get
distinct fingerprints only when the analyzer gives them distinct symbols.

The baseline file is a JSON list of fingerprint objects.  The repo's
checked-in baseline is empty: core/gateway findings were *fixed*, not
grandfathered, and the CI gate fails on any new finding.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Finding:
    rule: str          # e.g. "lock-discipline", "lock-order-cycle"
    path: str          # file the finding anchors to (repo-relative if possible)
    line: int          # 1-indexed; 0 when the finding is whole-file/global
    symbol: str        # qualified symbol, e.g. "Monitor.heartbeat:last_heartbeat"
    message: str
    severity: str = "error"      # "error" gates CI; "warning" is advisory

    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, _norm(self.path), self.symbol)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.severity}: {self.message}"


def _norm(path: str) -> str:
    """Normalize to a stable repo-relative form so fingerprints match no
    matter what directory the CLI was invoked from."""
    p = path.replace(os.sep, "/")
    for marker in ("src/repro_torch/", "tests/"):
        i = p.find(marker)
        if i >= 0:
            return p[i:]
    return p.lstrip("./")


class Report:
    """Accumulates findings across passes; diffs against a baseline."""

    def __init__(self) -> None:
        self.findings: List[Finding] = []

    def add(self, rule: str, path: str, line: int, symbol: str,
            message: str, severity: str = "error") -> None:
        self.findings.append(Finding(rule, path, line, symbol, message,
                                     severity))

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def new_findings(self, baseline: List[Tuple[str, str, str]]
                     ) -> List[Finding]:
        """Errors not covered by the baseline (warnings never gate)."""
        pool = list(baseline)
        out = []
        for f in self.errors():
            fp = f.fingerprint()
            if fp in pool:
                pool.remove(fp)      # multiset semantics: one entry, one hit
            else:
                out.append(f)
        return out

    def to_json(self) -> str:
        return json.dumps([f.to_dict() for f in self.findings], indent=2,
                          sort_keys=True) + "\n"


def load_baseline(path: Optional[str]) -> List[Tuple[str, str, str]]:
    if not path or not os.path.exists(path):
        return []
    with open(path) as f:
        raw = json.load(f)
    return [(e["rule"], _norm(e["path"]), e["symbol"]) for e in raw]


def dump_baseline(path: str, findings: List[Finding]) -> None:
    entries = [{"rule": f.rule, "path": _norm(f.path), "symbol": f.symbol}
               for f in findings]
    with open(path, "w") as f:
        json.dump(entries, f, indent=2, sort_keys=True)
        f.write("\n")
