"""Stdlib HTTP plumbing for serving processes (port of
``repro/serving/observability/httpd.py``).

Two layers:

  * ``BackgroundHTTPServer`` — a reusable ``ThreadingHTTPServer`` wrapper
    (daemon handler threads, background accept loop, explicit start/stop
    or context manager).  ``port=0`` binds an ephemeral port and the bound
    port is read back onto ``.port``/``.url`` at construction time —
    callers (tests, the fleet router, CI on shared runners) never race on
    a fixed port.  ``repro_torch.serving.transport.server`` builds the
    fold front-end on this same base.
  * ``MetricsServer`` — the scrape endpoint: serves a FoldClient's
    metrics registry (``/metrics`` Prometheus text, ``/metrics.json``,
    ``/healthz`` liveness).

``parse_hostport`` parses ``HOST:PORT`` listen specs (``--listen`` /
``--metrics-port``-style flags).  Zero dependencies; one short-lived
handler thread per request reading thread-safe state — a scrape or status
poll can never block the serving pump.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.serving.observability.registry import PROMETHEUS_CONTENT_TYPE


def parse_hostport(spec: str, *, default_host: str = "127.0.0.1",
                   ) -> tuple[str, int]:
    """Parse a ``HOST:PORT`` (or bare ``PORT``) listen spec.

    Port 0 is legal and means "bind an ephemeral port" — the server
    reports the real one back.  Raises ValueError with a usable message
    on malformed specs.
    """
    spec = spec.strip()
    host, sep, port_s = spec.rpartition(":")
    if not sep:
        host, port_s = default_host, spec
    host = host or default_host
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"invalid listen spec {spec!r}: port {port_s!r} "
                         f"is not an integer") from None
    if not 0 <= port <= 65535:
        raise ValueError(f"invalid listen spec {spec!r}: port {port} "
                         f"out of range")
    return host, port


class QuietHandler(BaseHTTPRequestHandler):
    """Request handler base: no per-request stderr spam, JSON/text send
    helpers, and a catch-all that turns handler bugs into 500s instead of
    killing the connection thread mid-header."""

    # HTTP/1.1 keeps CI curl loops on one connection; Content-Length is
    # always sent so this is safe with persistent connections
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):          # quiet: no per-request spam
        pass

    def _send(self, code: int, content_type: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, payload: dict) -> None:
        self._send(code, "application/json",
                   json.dumps(payload).encode("utf-8"))


class _ThreadingServer(ThreadingHTTPServer):
    """Daemon handler threads, and a listen backlog for a burst of clients:
    ``socketserver``'s default of 5 drops the SYNs of a sixth concurrent
    connect, which the client's kernel resends only after a second."""
    daemon_threads = True
    request_queue_size = 128


class BackgroundHTTPServer:
    """A ThreadingHTTPServer on a background daemon thread.

    Binds in ``__init__`` — ``port=0`` resolves to the kernel-assigned
    ephemeral port immediately, so ``.port``/``.url`` are always the real
    address (what tests and the http-serving CI job read to avoid port
    collisions on shared runners).  Subclasses pass their handler class;
    per-request daemon threads mean a stuck consumer (e.g. an abandoned
    SSE stream) can never wedge shutdown.
    """

    def __init__(self, handler_cls, port: int = 0,
                 host: str = "127.0.0.1", *, name: str = "httpd"):
        self._server = _ThreadingServer((host, port), handler_cls)
        self.host = host
        #: the BOUND port — with ``port=0`` this is the ephemeral port the
        #: kernel actually assigned, never the 0 that was asked for
        self.port = int(self._server.server_address[1])
        self._name = name
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._server.serve_forever, name=self._name,
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class MetricsServer(BackgroundHTTPServer):
    """Serve a FoldClient's metrics registry over HTTP.

    ``port=0`` (the default) binds an ephemeral port (read it back from
    ``.port`` — what tests and CI use on shared runners).  Start/stop
    explicitly or use as a context manager.
    """

    def __init__(self, client, port: int = 0, host: str = "127.0.0.1"):
        self.client = client
        outer = self

        class Handler(QuietHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200, PROMETHEUS_CONTENT_TYPE,
                                   outer.client.metrics_text()
                                   .encode("utf-8"))
                    elif path == "/metrics.json":
                        self._send_json(200, outer.client.metrics_json())
                    elif path == "/healthz":
                        self._send_json(200, {
                            "ok": True,
                            "driving": bool(getattr(outer.client,
                                                    "driving", False)),
                            "pending": int(getattr(outer.client,
                                                   "pending", 0)),
                        })
                    else:
                        self._send(404, "text/plain", b"not found\n")
                except Exception as e:   # a scrape bug must not kill serving
                    self._send(500, "text/plain", repr(e).encode("utf-8"))

        super().__init__(Handler, port, host, name="metrics-httpd")
