"""Threaded stdlib HTTP server hosting the GatewayApi.

``ThreadingHTTPServer`` gives each connection its own thread, which is
what makes the long-poll event feed *and* the Server-Sent Events streams
workable: a client parked on ``GET /v1/blocks/<id>/events?timeout_s=20``
or holding ``/v1/events/stream`` open occupies only its own thread while
other users' requests proceed.  Mutations are safe regardless of thread
count because every one funnels into the ClusterDaemon's command queue
and executes on the single pump thread.

Hardening knobs (all constructor parameters):

* ``max_body_bytes`` — requests with a larger declared body are refused
  with 413 before the body is read (the connection is closed, so an
  oversized upload cannot occupy the socket);
* ``rate_limit_rps`` / ``rate_limit_burst`` — per-session token-bucket
  rate limiting; an exhausted session gets 429 with a retry hint
  (``None`` disables the limiter).
"""
from __future__ import annotations

import json
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.gateway.handlers import GatewayApi, SSEStream, StaticFile
from repro_torch.gateway.profiles import ProfileStore
from repro_torch.gateway.ratelimit import RateLimiter
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import TRACER


class _Handler(BaseHTTPRequestHandler):
    api: GatewayApi = None            # injected by GatewayServer
    max_body_bytes: int = 1 << 20     # injected by GatewayServer
    protocol_version = "HTTP/1.1"     # keep-alive (Content-Length always set)
    quiet = True

    def log_message(self, fmt, *args):   # noqa: D102 - silence per-request
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send_json(self, status: int, obj) -> None:
        data = json.dumps(obj, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Request-ID", self._rid)
        self.end_headers()
        self.wfile.write(data)

    def _dispatch(self, method: str) -> None:
        # correlation id: honor the client's X-Request-ID, mint one
        # otherwise; echoed on every response and carried into the trace
        # context (and, through it, into event payloads)
        self._rid = (self.headers.get("X-Request-ID")
                     or f"req-{uuid.uuid4().hex[:12]}")
        t0 = time.perf_counter()
        parsed = urllib.parse.urlsplit(self.path)
        with TRACER.span(f"http.{method}:{parsed.path}", cat="http",
                         request_id=self._rid):
            status = self._serve_one(method, parsed)
        dt = time.perf_counter() - t0
        REGISTRY.inc("repro_http_requests_total",
                     labels={"method": method, "status": str(status)})
        REGISTRY.observe("repro_http_request_seconds", dt,
                         labels={"method": method})
        self.api.record_access(method, parsed.path, status, dt, self._rid)

    def _serve_one(self, method: str, parsed) -> int:
        """Handle one request; returns the response status (for the
        access log / metrics — the response itself is already written)."""
        query = {k: v[0] for k, v in
                 urllib.parse.parse_qs(parsed.query).items()}
        length = int(self.headers.get("Content-Length") or 0)
        if length > self.max_body_bytes:
            # refuse before reading: an oversized body never transits the
            # socket; close the connection (the unread body would otherwise
            # be parsed as the next pipelined request)
            self.close_connection = True
            REGISTRY.inc("repro_http_413_total", labels={"method": method})
            self._send_json(413, {
                "error": f"request body {length} bytes exceeds the "
                         f"{self.max_body_bytes}-byte cap"})
            return 413
        body = self.rfile.read(length) if length else b""
        try:
            status, obj = self.api.handle(method, parsed.path, query,
                                          dict(self.headers), body)
        except Exception as e:          # defensive: a handler bug must not
            status, obj = 500, {"error": f"internal error: {e}"}
        if isinstance(obj, SSEStream):
            # hand the socket to the stream: frames flow until the client
            # disconnects or the gateway shuts down.  No Content-Length,
            # so the connection cannot be reused afterwards.
            self.close_connection = True
            self.send_response(status)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.send_header("X-Request-ID", self._rid)
            self.end_headers()
            obj.serve(self.wfile)
            return status
        if isinstance(obj, StaticFile):
            self.send_response(status)
            self.send_header("Content-Type", obj.content_type)
            self.send_header("Content-Length", str(len(obj.data)))
            self.send_header("X-Request-ID", self._rid)
            self.end_headers()
            self.wfile.write(obj.data)
            return status
        self._send_json(status, obj)
        return status

    def do_GET(self) -> None:
        self._dispatch("GET")

    def do_POST(self) -> None:
        self._dispatch("POST")


class GatewayServer:
    """Bind-and-serve wrapper: ``GatewayServer(daemon, profiles).start()``.

    ``port=0`` binds an ephemeral port (tests/benchmarks); read ``url``
    after construction.  ``stop()`` shuts the listener down, unparks any
    open SSE streams and joins the serving thread; the daemon is left
    running (the caller owns it).
    """

    def __init__(self, daemon, profiles: ProfileStore,
                 host: str = "127.0.0.1", port: int = 0,
                 max_body_bytes: int = 1 << 20,
                 rate_limit_rps: Optional[float] = None,
                 rate_limit_burst: Optional[int] = None):
        limiter = (RateLimiter(rate_limit_rps, burst=rate_limit_burst)
                   if rate_limit_rps else None)
        self.api = GatewayApi(daemon, profiles, rate_limiter=limiter)
        handler = type("GatewayHandler", (_Handler,),
                       {"api": self.api,
                        "max_body_bytes": int(max_body_bytes)})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "GatewayServer":
        if self._thread is None or not self._thread.is_alive():
            self.api.closing.clear()
            self._thread = threading.Thread(
                target=self.httpd.serve_forever, name="gateway-http",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self.api.closing.set()         # drain parked SSE streams
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self.api.flush_sessions()      # write any throttled cursor state

    def __enter__(self) -> "GatewayServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
