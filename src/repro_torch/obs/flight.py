"""Flight recorder — a bounded ring of recent events + spans that dumps
a postmortem JSON artifact when something dies.

The recorder is a passive EventBus subscriber (``install(bus)``): it
mirrors the last N events globally and per-block, costs one deque append
per event, and mutates nothing in the control plane — deterministic
inline mode is unaffected by its presence.

A dump fires automatically on

* a block entering FAILED (``state`` event with ``state == "failed"``),
* pod death (``ClusterController.fail_pod`` calls ``dump()`` after
  computing the victim set, so the victims' final preempted/state events
  and spans are already in the ring), and
* a daemon pump-loop crash (the daemon's tick exception handler).

Artifacts are written crash-safely (mkstemp in the target directory,
fsync, ``os.replace``) because the typical dump happens exactly when the
process is least healthy.  Each dump also publishes a ``postmortem``
event so dashboards and SSE watchers learn an artifact exists.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Deque, Dict, List, Optional

from repro_torch.obs.trace import TRACER

#: retained artifact files (oldest pruned beyond this)
MAX_ARTIFACTS = 16


class FlightRecorder:
    """Bounded event/span ring with crash-safe postmortem dumps."""

    def __init__(self, max_events: int = 2048, max_per_app: int = 256):
        self._lock = threading.Lock()
        self._ring: Deque[Dict] = collections.deque(maxlen=max_events)
        self._per_app: Dict[str, Deque[Dict]] = {}
        self._max_per_app = max_per_app
        self._dumps: List[Dict] = []        # newest last, bounded
        self._bus = None
        self.dir: Optional[str] = None
        self._seq = 0

    # ------------------------------------------------------------- wiring
    def configure(self, dir: Optional[str] = None) -> "FlightRecorder":
        """Point artifact output at a directory (daemon passes
        ``<ckpt_root>/postmortems``).  Without one, dumps stay in-memory
        only — still visible to tests and ``GET /v1/postmortems``."""
        if dir is not None:
            self.dir = dir
        return self

    def install(self, bus) -> "FlightRecorder":
        """Mirror every event on ``bus`` and auto-dump on block FAILED."""
        self._bus = bus
        bus.subscribe(self._on_event)
        return self

    def _on_event(self, ev) -> None:
        d = ev.to_dict()
        app_id = d.get("app_id")
        with self._lock:
            self._ring.append(d)
            if app_id:
                ring = self._per_app.get(app_id)
                if ring is None:
                    if len(self._per_app) >= 4096:
                        self._per_app.pop(next(iter(self._per_app)))
                    ring = self._per_app[app_id] = collections.deque(
                        maxlen=self._max_per_app)
                ring.append(d)
        if ev.kind == "state" and d.get("state") == "failed":
            self.dump("block_failed", apps=[app_id] if app_id else None,
                      now=d.get("t"))

    # --------------------------------------------------------------- dump
    def dump(self, reason: str, apps: Optional[List[str]] = None,
             now: Optional[float] = None, detail: Optional[Dict] = None,
             ) -> Dict:
        """Snapshot recent events + the victims' spans into a postmortem
        artifact.  ``apps`` names the victims (None = whole-plane dump,
        e.g. a pump crash)."""
        t = now if now is not None else time.time()
        with self._lock:
            self._seq += 1
            name = f"postmortem-{self._seq:04d}-{reason}"
            events = list(self._ring)
            per_app = {a: list(self._per_app.get(a, ()))
                       for a in (apps or []) if a}
        spans = []
        for a in (apps or []):
            if a:
                spans.extend(s.to_dict() for s in TRACER.spans(app_id=a))
        if not apps:
            spans = [s.to_dict() for s in TRACER.spans()]
        artifact = {"name": name, "reason": reason, "t": t,
                    "apps": [a for a in (apps or []) if a],
                    "detail": detail or {},
                    "n_events": len(events), "n_spans": len(spans),
                    "events": events, "per_app_events": per_app,
                    "spans": spans}
        path = self._write(name, artifact)
        meta = {"name": name, "reason": reason, "t": t,
                "apps": artifact["apps"], "n_events": len(events),
                "n_spans": len(spans), "path": path}
        with self._lock:
            self._dumps.append({"meta": meta, "artifact": artifact})
            while len(self._dumps) > MAX_ARTIFACTS:
                self._dumps.pop(0)
        if self._bus is not None:
            try:
                self._bus.publish("postmortem", block_id=artifact["apps"][0]
                                  if artifact["apps"] else None, now=t,
                                  reason=reason, name=name,
                                  n_events=len(events), n_spans=len(spans))
            except Exception:
                pass            # a dying plane must still get its artifact
        return meta

    def _write(self, name: str, artifact: Dict) -> Optional[str]:
        if self.dir is None:
            return None
        try:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"{name}.json")
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(artifact, f, indent=1, default=str)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self._prune()
            return path
        except OSError:
            return None         # dump must never take the plane down

    def _prune(self) -> None:
        try:
            files = sorted(f for f in os.listdir(self.dir)
                           if f.startswith("postmortem-")
                           and f.endswith(".json"))
            for stale in files[:-MAX_ARTIFACTS]:
                os.unlink(os.path.join(self.dir, stale))
        except OSError:
            pass

    # --------------------------------------------------------------- reads
    def dumps(self) -> List[Dict]:
        """Newest-first artifact metadata (gateway listing)."""
        with self._lock:
            return [d["meta"] for d in reversed(self._dumps)]

    def read(self, name: str) -> Optional[Dict]:
        with self._lock:
            for d in self._dumps:
                if d["meta"]["name"] == name:
                    return d["artifact"]
        return None

    @property
    def last(self) -> Optional[Dict]:
        with self._lock:
            return self._dumps[-1]["artifact"] if self._dumps else None

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._per_app.clear()
            self._dumps.clear()
            self._seq = 0


#: the process-global recorder the daemon installs on its bus
RECORDER = FlightRecorder()
