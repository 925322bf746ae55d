"""Gateway request handlers: the HTTP/JSON surface of the block lifecycle.

Routes (all JSON in/out, ``Authorization: Bearer <session token>``):

  ``POST /v1/register``              step (1): register an application
  ``POST /v1/submit``                register + automated admission
  ``POST /v1/gangs``                 atomic multi-block (gang) submission
  ``POST /v1/blocks/<id>/review``    step (2), admin: assign a block
  ``POST /v1/blocks/<id>/confirm``   step (3): reconfirm w/ capability token
  ``POST /v1/blocks/<id>/activate``  step (4): boot the runtime (job spec)
  ``POST /v1/blocks/<id>/run``       step (5): start the job
  ``POST /v1/blocks/<id>/steps``     drive N steps (event-driven dispatch)
  ``POST /v1/blocks/<id>/autostep``  daemon-side stepping: enable/disable/
                                     pace the autostep engine for the block
  ``GET  /v1/blocks/<id>``           step (6): monitor one block
  ``GET  /v1/blocks/<id>/events``    step (6): long-poll live event feed
  ``GET  /v1/blocks/<id>/events/stream``  the same feed as Server-Sent
                                     Events (``text/event-stream``)
  ``GET  /v1/blocks/<id>/download``  step (7): collect results
  ``POST /v1/blocks/<id>/preempt``   admin: evict (checkpoint + release)
  ``POST /v1/blocks/<id>/resume``    admin: re-admit a preempted block
  ``POST /v1/blocks/<id>/resize``    admin: elastic grow/shrink
  ``POST /v1/blocks/<id>/expire``    owner/admin: end the usage period
  ``GET  /v1/blocks``                my blocks (admin: everyone's)
  ``GET  /v1/cluster``               pod inventory + monitor reports
  ``GET  /v1/pods``                  federation pod directory
  ``POST /v1/pods``                  admin: attach a pod at runtime
  ``POST /v1/pods/<id>/drain``       admin: stop placing on a pod
  ``POST /v1/pods/<id>/detach``      admin: remove a pod (``force`` evicts)
  ``POST /v1/pods/<id>/heartbeat``   pod agent liveness beat
  ``GET  /v1/events``                admin: global event feed (long-poll)
  ``GET  /v1/events/stream``         admin: cluster-wide SSE stream
  ``GET  /v1/profile``               who am I / my session configuration
  ``GET  /v1/profile/cursors``       my persisted event-feed cursors
  ``GET  /metrics``                  Prometheus text exposition (no auth)
  ``GET  /v1/trace``                 admin: Chrome-trace JSON of all spans
  ``GET  /v1/blocks/<id>/trace``     owner: one block's trace
  ``GET  /v1/postmortems``           admin: flight-recorder artifact index
  ``GET  /v1/postmortems/<name>``    admin: one postmortem dump
  ``GET  /v1/access``                admin: recent gateway access log
  ``GET  /ui`` (+ ``/ui/<asset>``)   the browser dashboard (static, no auth
                                     for the assets — data calls need a
                                     session token)

Request defaults (priority, deadline, duration) come from the caller's
session profile when a submission omits them — the paper's per-user
configuration files.  Job specs are dicts: ``{"kind": "sim", "step_s":
0.01}`` boots the device-free simulator; ``{"kind": "train"|"serve",
"arch": "xlstm_350m", ...}`` builds a real ``JobSpec``.

Feed cursors: every served feed page (long-poll or SSE) records the
session's ``next_after`` in the registry-backed session store, and a feed
request may pass ``after=resume`` to continue from the stored cursor —
so a gateway restart (or a browser reopening the dashboard) picks up
where the session left off instead of replaying or skipping events.

This module is a twin of the JAX package's ``gateway/handlers.py``, not a
copy: it imports the port's modules, and ``parse_job`` answers an arch
whose model family the port has not ported (``configs.get`` raises
``NotImplementedError`` for an arch listed in ``configs._NOT_PORTED``;
none is listed now that every family is ported) with a 501 that names
the family, where the reference, which has every family, never meets
that error.  Without
it the error would reach the server's catch-all and come back as a 500.
Everything else is the reference's, line for line.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.partition import AllocationError
from repro_torch.core.runtime import JobSpec, SimJobSpec
from repro_torch.gateway import auth
from repro_torch.gateway.auth import AuthError
from repro_torch.gateway.profiles import ProfileStore, UserProfile
from repro_torch.gateway.ratelimit import RateLimiter
from repro_torch.obs.flight import RECORDER
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER

MAX_LONGPOLL_S = 30.0
MAX_SSE_S = 3600.0          # hard per-connection cap on an SSE stream
SSE_HEARTBEAT_S = 10.0      # comment frame cadence (detects dead clients)
STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "static")
_CTYPES = {".html": "text/html; charset=utf-8",
           ".js": "text/javascript; charset=utf-8",
           ".css": "text/css; charset=utf-8",
           ".svg": "image/svg+xml"}


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def parse_job(spec: Optional[Dict]):
    """Job-spec dict -> SimJobSpec / JobSpec (None passes through: the
    block is admitted without auto-activation)."""
    if spec is None:
        return None
    if not isinstance(spec, dict) or "kind" not in spec:
        raise ApiError(400, "job must be a dict with a 'kind'")
    kind = spec["kind"]
    if kind == "sim":
        return SimJobSpec(step_s=float(spec.get("step_s", 0.001)),
                          ckpt_every=int(spec.get("ckpt_every", 0)))
    if kind not in ("train", "serve"):
        raise ApiError(400, f"unknown job kind {kind!r}")
    # real runtimes: resolve the architecture config lazily (importing the
    # model zoo is heavy; sim-only deployments never pay it)
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    arch = spec.get("arch")
    if not arch:
        raise ApiError(400, f"{kind} job needs an 'arch'")
    try:
        cfg = (configs.get_smoke(arch) if spec.get("smoke", True)
               else configs.get(arch))
    except KeyError:
        raise ApiError(400, f"unknown arch {arch!r}")
    except NotImplementedError as e:
        # a known arch of a family the port has not ported yet
        raise ApiError(501, str(e))
    shape = ShapeConfig(
        spec.get("shape_name", "gw"),
        "train" if kind == "train" else "serve",
        seq_len=int(spec.get("seq_len", 128)),
        global_batch=int(spec.get("global_batch", 4)),
        microbatch=int(spec.get("microbatch", 1)))
    opt = OptConfig(lr=float(spec.get("lr", 3e-4)),
                    warmup_steps=int(spec.get("warmup_steps", 2)),
                    total_steps=int(spec.get("total_steps", 100)))
    extra = {}
    if kind == "serve":
        # continuous-batching data plane: paged serve jobs expose the
        # generate endpoint (slot batch + shared page pool)
        extra = dict(paged=bool(spec.get("paged", False)),
                     page_size=int(spec.get("page_size", 16)),
                     n_pages=int(spec.get("n_pages", 0)),
                     max_slots=int(spec.get("max_slots", 8)),
                     max_seq_len=int(spec.get("max_seq_len", 0)),
                     decode_sample=bool(spec.get("decode_sample", False)))
    return JobSpec(cfg, shape, kind=kind, opt=opt,
                   seed=int(spec.get("seed", 0)), **extra)


def _grant_dict(grant) -> Optional[Dict]:
    if grant is None:
        return None
    return {"block_id": grant.block_id, "coords": list(grant.coords),
            "mesh_shape": list(grant.mesh_shape), "token": grant.token,
            "expires_at": grant.expires_at}


class StaticFile:
    """A non-JSON response body (the dashboard's assets).  The HTTP server
    recognizes this return type and writes the bytes verbatim."""

    def __init__(self, data: bytes, content_type: str):
        self.data = data
        self.content_type = content_type


class SSEStream:
    """A Server-Sent Events response: the HTTP server hands ``serve`` the
    socket and the stream pushes every matching bus event as one
    ``id:``/``event:``/``data:`` frame until the client disconnects, the
    gateway shuts down, or ``max_s`` elapses.  ``id`` is the bus cursor,
    so a reconnecting ``EventSource`` resumes exactly where it dropped
    (the browser re-sends it as ``Last-Event-ID``)."""

    def __init__(self, daemon, after: int, app_id: Optional[str] = None,
                 kinds=None, max_s: float = MAX_SSE_S,
                 heartbeat_s: float = SSE_HEARTBEAT_S,
                 closing: Optional[threading.Event] = None,
                 on_cursor=None, match=None, until=None):
        self.daemon = daemon
        self.after = after
        self.app_id = app_id
        self.kinds = kinds
        self.max_s = max_s
        self.heartbeat_s = heartbeat_s
        self.closing = closing or threading.Event()
        self.on_cursor = on_cursor          # cursor persistence callback
        self.match = match                  # event predicate (None = all);
                                            # the cursor still advances over
                                            # filtered-out events
        self.until = until                  # sent-event predicate: True
                                            # ends the stream (generate:
                                            # the session's final token)

    def serve(self, wfile) -> None:
        end = time.monotonic() + self.max_s
        next_beat = time.monotonic() + self.heartbeat_s
        after = self.after
        REGISTRY.add_gauge("repro_sse_streams", 1)
        try:
            # an immediate comment flushes headers so EventSource fires
            # its `open` event before the first real event arrives
            wfile.write(b": stream open\n\n")
            wfile.flush()
            while not self.closing.is_set():
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return
                # short waits keep shutdown + heartbeat latency bounded
                evs = self.daemon.wait_events(
                    after, app_id=self.app_id, kinds=self.kinds,
                    timeout=min(1.0, remaining), limit=500)
                if evs:
                    send = [ev for ev in evs
                            if self.match is None or self.match(ev)]
                    chunks = []
                    done = False
                    for ev in send:
                        data = json.dumps(ev.to_dict(), default=str)
                        chunks.append(f"id: {ev.seq}\nevent: {ev.kind}\n"
                                      f"data: {data}\n\n")
                        if self.until is not None and self.until(ev):
                            done = True
                            break
                    if chunks:
                        wfile.write("".join(chunks).encode())
                        wfile.flush()
                        REGISTRY.inc("repro_sse_frames_total",
                                     len(chunks))
                    after = evs[-1].seq
                    if self.on_cursor is not None:
                        self.on_cursor(after)
                    if done:
                        return
                elif time.monotonic() >= next_beat:
                    wfile.write(b": keep-alive\n\n")
                    wfile.flush()
                    next_beat = time.monotonic() + self.heartbeat_s
        except (BrokenPipeError, ConnectionResetError, OSError):
            return      # client went away: normal end of stream
        finally:
            REGISTRY.add_gauge("repro_sse_streams", -1)


class GatewayApi:
    """Routes HTTP requests onto the ClusterDaemon's typed command API.

    Stateless between requests: the daemon serializes every mutation
    through its command queue, so concurrent users are safe by
    construction; handlers only decide *who may ask for what*.
    """

    ROUTES: List[Tuple[str, "re.Pattern", str]] = [
        (m, re.compile(p), fn) for m, p, fn in [
            ("GET", r"^/v1/ping$", "ping"),
            ("GET", r"^/v1/profile$", "profile"),
            ("GET", r"^/v1/profile/cursors$", "profile_cursors"),
            ("GET", r"^/v1/cluster$", "cluster"),
            ("GET", r"^/v1/pods$", "pods"),
            ("POST", r"^/v1/pods$", "attach_pod"),
            ("POST", r"^/v1/pods/(?P<pod_id>\d+)/drain$", "drain_pod"),
            ("POST", r"^/v1/pods/(?P<pod_id>\d+)/detach$", "detach_pod"),
            ("POST", r"^/v1/pods/(?P<pod_id>\d+)/heartbeat$",
             "pod_heartbeat"),
            ("POST", r"^/v1/register$", "register"),
            ("POST", r"^/v1/submit$", "submit"),
            ("POST", r"^/v1/gangs$", "submit_gang"),
            ("GET", r"^/v1/blocks$", "list_blocks"),
            ("GET", r"^/v1/blocks/(?P<app_id>[\w-]+)$", "block_status"),
            ("GET", r"^/v1/blocks/(?P<app_id>[\w-]+)/events$",
             "block_events"),
            ("GET", r"^/v1/blocks/(?P<app_id>[\w-]+)/events/stream$",
             "block_events_stream"),
            ("GET", r"^/v1/blocks/(?P<app_id>[\w-]+)/download$",
             "download"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/review$", "review"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/confirm$",
             "confirm"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/activate$",
             "activate"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/run$", "run"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/steps$", "steps"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/autostep$",
             "autostep"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/generate$",
             "generate"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/preempt$",
             "preempt"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/resume$", "resume"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/resize$", "resize"),
            ("POST", r"^/v1/blocks/(?P<app_id>[\w-]+)/expire$", "expire"),
            ("GET", r"^/v1/events$", "global_events"),
            ("GET", r"^/v1/events/stream$", "global_events_stream"),
            ("GET", r"^/metrics$", "metrics"),
            ("GET", r"^/v1/trace$", "trace_export"),
            ("GET", r"^/v1/blocks/(?P<app_id>[\w-]+)/trace$",
             "block_trace"),
            ("GET", r"^/v1/postmortems$", "postmortems"),
            ("GET", r"^/v1/postmortems/(?P<name>[\w.\-]+)$",
             "postmortem_get"),
            ("GET", r"^/v1/access$", "access_log_report"),
            ("GET", r"^/ui/?$", "ui_index"),
            ("GET", r"^/ui/(?P<asset>[\w][\w.\-]*)$", "ui_asset"),
        ]
    ]

    #: routes served without a session (liveness probe + dashboard assets
    #: — the dashboard's *data* calls all authenticate normally; /metrics
    #: follows scrape-agent convention: no auth, but no secrets either —
    #: metric values and low-cardinality labels only)
    NO_AUTH = frozenset({"ping", "ui_index", "ui_asset", "metrics"})

    #: bounded in-memory access log (newest last)
    ACCESS_LOG_SIZE = 512

    #: the only routes that accept ?access_token= (EventSource cannot set
    #: headers); everywhere else the token must ride the Authorization
    #: header so it never lands in URLs/access logs
    QUERY_TOKEN_OK = frozenset({"block_events_stream",
                                "global_events_stream"})

    #: minimum interval between full session-snapshot writes: cursor
    #: updates ride the event hot path, and every store is a whole
    #: registry persist (fsync) — throttle, and flush on close
    SESSION_FLUSH_S = 1.0

    def __init__(self, daemon, profiles: ProfileStore,
                 rate_limiter: Optional[RateLimiter] = None,
                 static_dir: str = STATIC_DIR):
        self.daemon = daemon
        self.profiles = profiles
        self.rate_limiter = rate_limiter
        self.static_dir = static_dir
        #: set by the server on shutdown so parked SSE streams drain fast
        self.closing = threading.Event()
        # per-request access log: the HTTP server reports every finished
        # request here (status + wall latency + correlation id)
        self._access_lock = threading.Lock()
        self._access: Deque[Dict] = deque(maxlen=self.ACCESS_LOG_SIZE)
        # registry-backed session persistence: a rebuilt gateway over the
        # same daemon (or a daemon rebooted from its state snapshot)
        # rehydrates stored profiles and event-feed cursors, so sessions
        # survive the restart instead of every token going dark
        self._cursor_lock = threading.Lock()
        # serializes snapshot+store pairs: without it two persists could
        # commit out of order and leave the older snapshot on disk
        self._persist_lock = threading.Lock()
        self._sessions_dirty = False
        self._last_session_flush = float("-inf")
        stored = daemon.registry.session_snapshot()
        profiles.rehydrate(stored.get("profiles", ()))
        self._cursors: Dict[str, Dict[str, int]] = {
            t: dict(c) for t, c in (stored.get("cursors") or {}).items()}
        # the paper's per-user configuration becomes live policy
        profiles.apply_quotas(daemon.scheduler.policy)
        self._persist_sessions(force=True)

    # ------------------------------------------------------- rate limiting
    def _rate_limited(self, key: Optional[str]) -> Optional[Tuple[int,
                                                                  Dict]]:
        """Spend one token for ``key`` (None = the shared anonymous
        bucket).  Returns the 429 response when exhausted, else None."""
        if self.rate_limiter is None:
            return None
        ok, retry = self.rate_limiter.allow(key)
        if ok:
            return None
        who = "this session" if key else "unauthenticated requests"
        REGISTRY.inc("repro_http_429_total",
                     labels={"who": "session" if key else "anonymous"})
        return 429, {"error": f"rate limit exceeded for {who}",
                     "retry_after_s": round(retry, 3)}

    # ------------------------------------------------------- access logging
    def record_access(self, method: str, path: str, status: int,
                      dt_s: float, request_id: str) -> None:
        """Called by the HTTP server after every response is written.
        Never raises: a logging bug must not kill the connection
        thread."""
        try:
            with self._access_lock:
                self._access.append({
                    "t": time.time(), "method": method, "path": path,
                    "status": int(status), "ms": round(dt_s * 1e3, 3),
                    "request_id": request_id})
        except Exception:
            pass

    def access_log(self, limit: int = 100) -> List[Dict]:
        """Newest-first slice of the bounded access log."""
        with self._access_lock:
            entries = list(self._access)
        return entries[::-1][:max(1, int(limit))]

    # ----------------------------------------------------- session storage
    def _persist_sessions(self, force: bool = False) -> None:
        """Store the session state in the registry.  The snapshot handed
        over is a deep copy taken under the cursor lock — the registry
        json-serializes it later under its *own* lock, and a live
        reference would race concurrent cursor inserts.  Writes are
        throttled (every store is a full registry persist + fsync);
        ``flush_sessions`` forces the final one."""
        now = time.monotonic()
        with self._persist_lock:
            with self._cursor_lock:
                if not force and now - self._last_session_flush < \
                        self.SESSION_FLUSH_S:
                    self._sessions_dirty = True
                    return
                snap = {t: dict(c) for t, c in self._cursors.items()}
                self._sessions_dirty = False
                self._last_session_flush = now
            self.daemon.registry.store_sessions(
                {"profiles": self.profiles.snapshot(), "cursors": snap})

    def flush_sessions(self) -> None:
        """Write any throttled session state now (gateway shutdown)."""
        with self._cursor_lock:
            dirty = self._sessions_dirty
        if dirty:
            self._persist_sessions(force=True)

    def _remember_cursor(self, token: str, feed: str, after: int) -> None:
        with self._cursor_lock:
            cur = self._cursors.setdefault(token, {})
            if cur.get(feed) == after:
                return
            cur[feed] = after
        self._persist_sessions()

    def _resolve_after(self, profile: UserProfile, feed: str,
                       query: Dict[str, str]) -> int:
        raw = query.get("after", "0")
        if raw == "resume":
            with self._cursor_lock:
                return int(self._cursors.get(profile.token, {})
                           .get(feed, 0))
        try:
            return int(raw)
        except ValueError:
            raise ApiError(400, f"bad cursor {raw!r}")

    # --------------------------------------------------------------- router
    def handle(self, method: str, path: str, query: Dict[str, str],
               headers: Dict[str, str], body: bytes) -> Tuple[int, Dict]:
        try:
            payload = json.loads(body.decode() or "{}") if method == "POST" \
                else {}
        except (ValueError, UnicodeDecodeError):
            return 400, {"error": "request body is not valid JSON"}
        for m, pat, name in self.ROUTES:
            if m != method:
                continue
            match = pat.match(path)
            if match is None:
                continue
            try:
                if name == "ping":           # liveness probe: no auth
                    return 200, {"ok": True}
                if name in self.NO_AUTH:
                    # unauthenticated surfaces share the anonymous bucket
                    # — an asset flood is throttled like any other
                    hit = self._rate_limited(None)
                    if hit is not None:
                        return hit
                    return getattr(self, name)(None, match.groupdict(),
                                               payload, query)
                # browsers resume an SSE stream with Last-Event-ID; fold
                # it into the cursor query the feed handlers already read
                last_id = (headers.get("Last-Event-ID")
                           or headers.get("last-event-id"))
                if last_id and "after" not in query:
                    query = dict(query, after=last_id)
                try:
                    profile = auth.require_user(
                        headers, self.profiles,
                        query=(query if name in self.QUERY_TOKEN_OK
                               else None))
                except AuthError:
                    # a bad-token spray shares ONE anonymous bucket (a
                    # flood of invented tokens can neither fill the
                    # bucket table nor dodge the limiter via 401s)
                    hit = self._rate_limited(None)
                    if hit is not None:
                        return hit
                    raise
                hit = self._rate_limited(profile.token)
                if hit is not None:
                    return hit
                return getattr(self, name)(profile, match.groupdict(),
                                           payload, query)
            except (AuthError, ApiError) as e:
                return e.status, {"error": e.message}
            except KeyError as e:
                return 404, {"error": f"unknown application {e}"}
            except (AllocationError, ValueError, PermissionError,
                    AssertionError) as e:
                # AllocationError: pod-full is an expected, retryable
                # conflict, not an internal error
                return 409, {"error": str(e)}
        return 404, {"error": f"no route for {method} {path}"}

    # ---------------------------------------------------------- block access
    def _owned_block(self, profile: UserProfile, app_id: str):
        blk = self.daemon.registry.get(app_id)      # KeyError -> 404
        auth.require_owner(profile, blk.request.user)
        return blk

    def _status_for(self, profile: UserProfile, app_id: str) -> Dict:
        blk = self._owned_block(profile, app_id)
        st = self.daemon.status(app_id)
        # the block capability token is part of the owner's view (they
        # need it for the confirm step) but never anyone else's
        st["token"] = blk.grant.token if blk.grant else None
        return st

    # ------------------------------------------------------------- handlers
    def profile(self, profile, path_args, body, query):
        return 200, {"profile": profile.public()}

    def profile_cursors(self, profile, path_args, body, query):
        """The session's persisted event-feed cursors (feed key -> last
        served seq) — what ``after=resume`` continues from."""
        with self._cursor_lock:
            return 200, {"cursors":
                         dict(self._cursors.get(profile.token, {}))}

    def cluster(self, profile, path_args, body, query):
        return 200, self.daemon.cluster_report()

    # ------------------------------------------------------------ federation
    def pods(self, profile, path_args, body, query):
        return 200, {"pods": self.daemon.list_pods()}

    def attach_pod(self, profile, path_args, body, query):
        auth.require_admin(profile)
        try:
            pod_x = int(body["pod_x"])
            pod_y = int(body["pod_y"])
        except (KeyError, TypeError, ValueError):
            raise ApiError(400, "attach needs integer pod_x and pod_y")
        if not (1 <= pod_x <= 64 and 1 <= pod_y <= 64):
            raise ApiError(400, "pod_x/pod_y must be in [1, 64]")
        budget = body.get("power_budget_chips")
        try:
            budget = None if budget is None else float(budget)
        except (TypeError, ValueError):
            raise ApiError(400, "bad power_budget_chips")
        name = body.get("name")
        pod = self.daemon.attach_pod(
            pod_x, pod_y, name=(None if name is None else str(name)),
            power_budget_chips=budget)
        return 201, {"pod": pod}

    def _pod_id(self, path_args) -> int:
        return int(path_args["pod_id"])

    def drain_pod(self, profile, path_args, body, query):
        auth.require_admin(profile)
        pid = self._pod_id(path_args)
        try:
            return 200, {"pod": self.daemon.drain_pod(pid)}
        except KeyError:
            raise ApiError(404, f"unknown pod {pid}")

    def detach_pod(self, profile, path_args, body, query):
        auth.require_admin(profile)
        pid = self._pod_id(path_args)
        try:
            # residents + no force -> ValueError -> 409 via the router
            return 200, self.daemon.detach_pod(
                pid, force=bool(body.get("force", False)))
        except KeyError:
            raise ApiError(404, f"unknown pod {pid}")

    def pod_heartbeat(self, profile, path_args, body, query):
        auth.require_admin(profile)
        pid = self._pod_id(path_args)
        try:
            return 200, {"pod": self.daemon.pod_heartbeat(pid)}
        except KeyError:
            raise ApiError(404, f"unknown pod {pid}")

    def _submission_kwargs(self, profile: UserProfile, body: Dict) -> Dict:
        """Merge the request with the user's profile defaults.  All values
        are coerced (a JSON string where a number belongs must fail *this*
        request, not poison the waitlist for everyone), and a non-admin
        cannot outrank their own profile's priority — the profile is the
        per-user configuration the gateway enforces, not a suggestion."""
        priority = int(body.get("priority", profile.priority))
        if not profile.admin:
            priority = min(priority, profile.priority)
        deadline_s = (body["deadline_s"] if "deadline_s" in body
                      else profile.deadline_s)
        est_steps = body.get("est_steps")
        try:
            return {
                "priority": priority,
                "duration_s": float(body.get("duration_s",
                                             profile.duration_s)),
                "deadline_s": (None if deadline_s is None
                               else float(deadline_s)),
                "est_steps": (None if est_steps is None
                              else int(est_steps)),
            }
        except (TypeError, ValueError) as e:
            raise ApiError(400, f"bad submission field: {e}")

    def register(self, profile, path_args, body, query):
        if "n_chips" not in body:
            raise ApiError(400, "n_chips is required")
        kw = self._submission_kwargs(profile, body)
        app_id = self.daemon.register(
            profile.user, body.get("job_description", ""),
            int(body["n_chips"]), arch=body.get("arch", ""), **kw)
        return 201, {"app_id": app_id,
                     "state": self.daemon.status(app_id)["state"]}

    def submit(self, profile, path_args, body, query):
        if "n_chips" not in body:
            raise ApiError(400, "n_chips is required")
        kw = self._submission_kwargs(profile, body)
        auto = body.get("autostep")
        auto_kw = None
        if isinstance(auto, dict) and auto.get("enabled", True):
            # coerce *before* submitting: a malformed autostep field must
            # fail this request outright, not 400 after the block was
            # already admitted (an orphan holding chips under an app_id
            # the caller never received)
            auto_kw = self._autostep_kwargs(auto)
        app_id, grant = self.daemon.submit(
            profile.user, body.get("job_description", ""),
            int(body["n_chips"]), job=parse_job(body.get("job")), **kw)
        st = self.daemon.status(app_id)
        if auto_kw is not None and st["state"] not in ("denied", "expired"):
            # arm the engine at submission: the block autosteps from the
            # moment it is RUNNING (now, or whenever the pump admits it)
            self.daemon.autostep_enable(app_id, **auto_kw)
            st = self.daemon.status(app_id)
        return 201, {"app_id": app_id, "admitted": grant is not None,
                     "grant": _grant_dict(grant),
                     "state": st["state"],
                     "autostep": st["autostep"]}

    def submit_gang(self, profile, path_args, body, query):
        members = body.get("members")
        if not members or not isinstance(members, list):
            raise ApiError(400, "members must be a non-empty list")
        tuples = []
        for m in members:
            if "n_chips" not in m:
                raise ApiError(400, "every gang member needs n_chips")
            tuples.append((m.get("job_description", ""),
                           int(m["n_chips"]), parse_job(m.get("job"))))
        kw = self._submission_kwargs(profile, body)
        kw.pop("est_steps", None)         # gang-level estimate unsupported
        app_ids, grants = self.daemon.submit_gang(profile.user, tuples,
                                                  **kw)
        return 201, {
            "app_ids": app_ids, "admitted": grants is not None,
            "grants": ({a: _grant_dict(g) for a, g in grants.items()}
                       if grants else None)}

    def list_blocks(self, profile, path_args, body, query):
        user = None if profile.admin else profile.user
        return 200, {"blocks": self.daemon.list_apps(user=user)}

    def block_status(self, profile, path_args, body, query):
        return 200, self._status_for(profile, path_args["app_id"])

    def review(self, profile, path_args, body, query):
        auth.require_admin(profile)
        grant = self.daemon.review(
            path_args["app_id"], approve=bool(body.get("approve", True)),
            n_chips=body.get("n_chips"), pod=body.get("pod"))
        return 200, {"approved": grant is not None,
                     "grant": _grant_dict(grant)}

    def confirm(self, profile, path_args, body, query):
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        if "token" not in body:
            raise ApiError(400, "confirm needs the block capability token")
        self.daemon.confirm(app_id, body["token"])
        return 200, {"state": self.daemon.status(app_id)["state"]}

    def activate(self, profile, path_args, body, query):
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        job = parse_job(body.get("job"))
        if job is None:
            raise ApiError(400, "activate needs a job spec")
        self.daemon.activate(app_id, job)
        return 200, {"state": self.daemon.status(app_id)["state"]}

    def run(self, profile, path_args, body, query):
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        self.daemon.run(app_id)
        return 200, {"state": self.daemon.status(app_id)["state"]}

    def steps(self, profile, path_args, body, query):
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        rounds = int(body.get("rounds", 1))
        if rounds < 1 or rounds > 10000:
            raise ApiError(400, "rounds must be in [1, 10000]")
        out = self.daemon.run_steps({app_id: rounds},
                                    max_inflight=body.get("max_inflight"))
        recs = out.get(app_id, [])
        return 200, {"completed": len(recs),
                     "records": recs[-10:],
                     "steps": self.daemon.status(app_id)["steps"]}

    @staticmethod
    def _autostep_kwargs(body: Dict) -> Dict:
        """Coerce an autostep config object; raises a 400 ``ApiError``
        without touching the daemon."""
        try:
            return dict(
                max_rate_hz=(None if body.get("max_rate_hz") is None
                             else float(body["max_rate_hz"])),
                until_steps=(None if body.get("until_steps") is None
                             else int(body["until_steps"])),
                until_t=(None if body.get("until_t") is None
                         else float(body["until_t"])),
                stop_at_deadline=bool(body.get("stop_at_deadline", False)),
                ckpt_every=int(body.get("ckpt_every", 0)))
        except (TypeError, ValueError) as e:
            raise ApiError(400, f"bad autostep field: {e}")

    def autostep(self, profile, path_args, body, query):
        """Daemon-side stepping controls: ``{"enabled": true, ...config}``
        arms (or re-configures) the engine for the block, ``{"enabled":
        false}`` disarms, ``{"max_rate_hz": X}`` alone re-paces a running
        drive.  The owner controls their own block; admins any."""
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        enabled = bool(body.get("enabled", True))
        if not enabled:
            self.daemon.autostep_disable(
                app_id, reason=f"disabled by {profile.user}")
            return 200, {"autostep": None}
        kw = self._autostep_kwargs(body)         # 400 on malformed fields
        if set(body) == {"max_rate_hz"}:
            # a bare pace re-paces a *running* drive only — it must never
            # silently arm a fresh unbounded drive on a disarmed block
            if not self.daemon.engine.enabled(app_id):
                raise ApiError(409, "autostep is not enabled for this "
                                    "block; POST a full config to arm it")
            cfg = self.daemon.autostep_pace(app_id, kw["max_rate_hz"])
            return 200, {"autostep": cfg}
        # a terminal-state block raises ValueError -> 409 via the router
        return 200, {"autostep": self.daemon.autostep_enable(app_id, **kw)}

    def generate(self, profile, path_args, body, query):
        """Submit a generate session to a paged serve block.  Default is
        an SSE stream of the session's ``generate``/``session`` events
        (token-by-token, ending at the final token); ``{"stream": false}``
        long-polls the bus and returns the whole completion as JSON."""
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           and t >= 0 for t in prompt)):
            raise ApiError(400, "prompt must be a non-empty list of "
                                "non-negative token ids")
        try:
            max_new = int(body.get("max_new_tokens", 16))
        except (TypeError, ValueError):
            raise ApiError(400, "bad max_new_tokens")
        if not 1 <= max_new <= 100000:
            raise ApiError(400, "max_new_tokens must be in [1, 100000]")
        eos = body.get("eos_id")
        eos = None if eos is None else int(eos)
        # cursor taken BEFORE submission: the session's first tokens can
        # land the moment the pump's next engine round runs, and a cursor
        # taken after the submit would lose them
        cursor = self.daemon.bus.latest_seq
        sid = self.daemon.generate(app_id, prompt, max_new_tokens=max_new,
                                   eos_id=eos)   # ValueError -> 409
        if not self.daemon.engine.enabled(app_id):
            # nothing decodes without a drive: arm daemon-side stepping
            self.daemon.autostep_enable(app_id)
        own = {"generate", "session"}

        def match(ev):
            return ev.payload.get("session") == sid

        def until(ev):
            return ((ev.kind == "generate" and ev.payload.get("done"))
                    or (ev.kind == "session"
                        and ev.payload.get("action") == "finished"))

        if bool(body.get("stream", True)):
            max_s = min(float(body.get("max_s", MAX_SSE_S)), MAX_SSE_S)
            return 200, SSEStream(self.daemon, cursor, app_id=app_id,
                                  kinds=own, max_s=max_s,
                                  closing=self.closing,
                                  match=match, until=until)
        timeout = min(float(body.get("timeout_s", MAX_LONGPOLL_S)),
                      MAX_LONGPOLL_S)
        deadline = time.monotonic() + timeout
        after, tokens, done = cursor, [], False
        while not done:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            evs = self.daemon.wait_events(after, app_id=app_id, kinds=own,
                                          timeout=min(1.0, remaining))
            if not evs:
                continue
            after = evs[-1].seq
            for ev in evs:
                if not match(ev):
                    continue
                if ev.kind == "generate":
                    tokens.append(ev.payload["token"])
                done = done or until(ev)
        return 200, {"session": sid, "tokens": tokens, "done": done}

    def preempt(self, profile, path_args, body, query):
        auth.require_admin(profile)
        self.daemon.preempt(path_args["app_id"],
                            reason=body.get("reason",
                                            f"admin {profile.user}"))
        return 200, {"state": self.daemon.status(
            path_args["app_id"])["state"]}

    def resume(self, profile, path_args, body, query):
        auth.require_admin(profile)
        grant = self.daemon.resume(path_args["app_id"],
                                   n_chips=body.get("n_chips"))
        return 200, {"grant": _grant_dict(grant)}

    def resize(self, profile, path_args, body, query):
        auth.require_admin(profile)
        if "n_chips" not in body:
            raise ApiError(400, "resize needs n_chips")
        self.daemon.resize(path_args["app_id"], int(body["n_chips"]))
        return 200, self.daemon.status(path_args["app_id"])

    def expire(self, profile, path_args, body, query):
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        self.daemon.expire(app_id)
        return 200, {"state": self.daemon.status(app_id)["state"]}

    def download(self, profile, path_args, body, query):
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        return 200, self.daemon.download(app_id)

    # ------------------------------------------------------------ event feed
    def _feed(self, profile: UserProfile, query: Dict[str, str],
              app_id: Optional[str]) -> Tuple[int, Dict]:
        feed_key = app_id or "*"
        after = self._resolve_after(profile, feed_key, query)
        timeout = min(float(query.get("timeout_s", 0.0)), MAX_LONGPOLL_S)
        kinds = (set(query["kinds"].split(","))
                 if query.get("kinds") else None)
        if timeout > 0:
            evs = self.daemon.wait_events(after, app_id=app_id,
                                          kinds=kinds, timeout=timeout)
        else:
            evs = self.daemon.events_since(after, app_id=app_id,
                                           kinds=kinds)
        # no events -> cursor unchanged: advancing past unmatched seqs
        # could skip a matching event racing the poll
        next_after = evs[-1].seq if evs else after
        if evs:
            self._remember_cursor(profile.token, feed_key, next_after)
        return 200, {"events": [e.to_dict() for e in evs],
                     "next_after": next_after}

    def _stream(self, profile: UserProfile, query: Dict[str, str],
                app_id: Optional[str]) -> Tuple[int, SSEStream]:
        feed_key = app_id or "*"
        after = self._resolve_after(profile, feed_key, query)
        kinds = (set(query["kinds"].split(","))
                 if query.get("kinds") else None)
        max_s = min(float(query.get("max_s", MAX_SSE_S)), MAX_SSE_S)
        token = profile.token
        return 200, SSEStream(
            self.daemon, after, app_id=app_id, kinds=kinds, max_s=max_s,
            closing=self.closing,
            on_cursor=lambda seq: self._remember_cursor(token, feed_key,
                                                        seq))

    def block_events(self, profile, path_args, body, query):
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        return self._feed(profile, query, app_id)

    def block_events_stream(self, profile, path_args, body, query):
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        return self._stream(profile, query, app_id)

    def global_events(self, profile, path_args, body, query):
        auth.require_admin(profile)
        return self._feed(profile, query, None)

    def global_events_stream(self, profile, path_args, body, query):
        auth.require_admin(profile)
        return self._stream(profile, query, None)

    # -------------------------------------------------------- observability
    def metrics(self, profile, path_args, body, query):
        """Prometheus text exposition of the process-global registry."""
        return 200, StaticFile(
            REGISTRY.render().encode(),
            "text/plain; version=0.0.4; charset=utf-8")

    def trace_export(self, profile, path_args, body, query):
        """Chrome-trace JSON of every recorded span (open it in
        chrome://tracing or Perfetto)."""
        auth.require_admin(profile)
        return 200, TRACER.chrome_trace()

    def block_trace(self, profile, path_args, body, query):
        """One block's spans — the owner's view of their request's
        journey through the control plane."""
        app_id = path_args["app_id"]
        self._owned_block(profile, app_id)
        return 200, TRACER.chrome_trace(app_id=app_id)

    def postmortems(self, profile, path_args, body, query):
        auth.require_admin(profile)
        return 200, {"postmortems": RECORDER.dumps()}

    def postmortem_get(self, profile, path_args, body, query):
        auth.require_admin(profile)
        dump = RECORDER.read(path_args["name"])
        if dump is None:
            raise ApiError(404,
                           f"no postmortem {path_args['name']!r}")
        return 200, dump

    def access_log_report(self, profile, path_args, body, query):
        auth.require_admin(profile)
        try:
            limit = int(query.get("limit", 100))
        except ValueError:
            raise ApiError(400, "bad limit")
        return 200, {"access": self.access_log(limit)}

    # ------------------------------------------------------------ dashboard
    def _static(self, name: str) -> Tuple[int, object]:
        if "/" in name or ".." in name:
            raise ApiError(404, "no such asset")
        path = os.path.join(self.static_dir, name)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            raise ApiError(404, f"no such asset {name!r}")
        ctype = _CTYPES.get(os.path.splitext(name)[1],
                            "application/octet-stream")
        return 200, StaticFile(data, ctype)

    def ui_index(self, profile, path_args, body, query):
        return self._static("index.html")

    def ui_asset(self, profile, path_args, body, query):
        return self._static(path_args["asset"])
