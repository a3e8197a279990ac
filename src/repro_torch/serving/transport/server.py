"""HTTP front-end over a ``FleetRouter``: the network serving surface (port
of ``repro/serving/transport/server.py``, the same routes and bodies).

Stdlib ``http.server`` only (the same zero-dep approach as the metrics
endpoint, built on the shared ``BackgroundHTTPServer`` base), so
anything that can speak HTTP — curl, a browser, a Prometheus scraper —
can drive the fold engine:

    POST   /v1/fold               submit {"sequence", "priority",
                                  "deadline_s"} -> {"id", "state", ...}
    GET    /v1/fold/<id>          status; the result (coords base64,
                                  bitwise-lossless) rides along once
                                  terminal; ``?distogram=1`` additionally
                                  materializes + returns the distogram
                                  (plain polls never trigger that
                                  device->host transfer)
    GET    /v1/fold/<id>/events   Server-Sent-Events stream of the typed
                                  progress events; replays history, then
                                  follows live until the terminal event
    DELETE /v1/fold/<id>          cancel -> {"cancelled", "state"}
    POST   /v1/generate           LM-decode submit {"prompt",
                                  "max_new_tokens", "priority",
                                  "deadline_s"} (requires an LM-workload
                                  fleet); same 202 + events_url contract
    GET    /v1/generate/<id>[/events] and DELETE /v1/generate/<id> are
                                  the same record machinery as /v1/fold —
                                  ids share one fleet namespace, so either
                                  prefix addresses either workload; SSE
                                  additionally carries per-token ``token``
                                  events; ``?logits=1`` returns the
                                  first-token logits on terminal status
    GET    /healthz               fleet liveness + per-replica health
    GET    /v1/fleet              fleet topology
    GET    /metrics               fleet registry, Prometheus text
    GET    /metrics.json          fleet registry, JSON
    GET    /metrics/replica/<i>   replica i's own engine registry

Handler threads are daemonic and only touch thread-safe router state, so
a slow or abandoned consumer (including a parked SSE stream) never blocks
the serving pump or shutdown.  They never read a device buffer a later
graph replay can overwrite: results are host arrays, and a ``?distogram=1``
status materializes the request's ``LazyDistogram`` from the copy the
engine made of its batch's output right after the replay.
``/v1/generate`` on a fleet of ``LMClient`` replicas decodes; on a fold
fleet it submits the prompt as a fold, as the reference's fold fleet does.
"""
from __future__ import annotations

import json
import re

from repro_torch.serving import events as ev
from repro_torch.serving.observability.httpd import (BackgroundHTTPServer,
                                                     QuietHandler)
from repro_torch.serving.observability.registry import PROMETHEUS_CONTENT_TYPE
from repro_torch.serving.transport import protocol
from repro_torch.serving.transport.fleet import FleetRouter

_FOLD_RE = re.compile(r"^/v1/(?:fold|generate)/(\d+)(/events)?$")
_REPLICA_RE = re.compile(r"^/metrics/replica/(\d+)$")

#: SSE follow-mode wakeup period: bounds how long a stream waiter can
#: outlive a vanished record and paces liveness comments to the consumer
SSE_POLL_S = 5.0


class FoldHTTPServer(BackgroundHTTPServer):
    """Serve a ``FleetRouter`` over HTTP.

    ``port=0`` (default) binds an ephemeral port; read ``.port``/``.url``
    back.  Start/stop explicitly or use as a context manager — stopping
    the server does NOT stop the router (the owner does that; the CLI
    wires both)."""

    def __init__(self, router: FleetRouter, port: int = 0,
                 host: str = "127.0.0.1"):
        self.router = router
        outer = self

        class Handler(QuietHandler):
            # -- routing --
            def do_POST(self):
                self._guard(self._post)

            def do_GET(self):
                self._guard(self._get)

            def do_DELETE(self):
                self._guard(self._delete)

            def _guard(self, fn) -> None:
                try:
                    fn()
                except protocol.ProtocolError as e:
                    self._send_json(e.http_status, {"error": str(e)})
                except BrokenPipeError:      # consumer went away mid-write
                    pass
                except Exception as e:   # a handler bug must not kill serving
                    try:
                        self._send_json(500, {"error": repr(e)})
                    except Exception:
                        pass

            # -- helpers --
            def _record_or_404(self, request_id: int):
                rec = outer.router.get(request_id)
                if rec is None:
                    raise protocol.ProtocolError(
                        f"unknown request id {request_id}", http_status=404)
                return rec

            def _query(self) -> dict[str, str]:
                _, _, qs = self.path.partition("?")
                out = {}
                for part in qs.split("&"):
                    if part:
                        k, _, v = part.partition("=")
                        out[k] = v
                return out

            # -- verbs --
            def _post(self) -> None:
                path = self.path.split("?", 1)[0]
                if path not in ("/v1/fold", "/v1/generate"):
                    self._send_json(404, {"error": "not found"})
                    return
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length)
                if path == "/v1/fold":
                    seq, priority, deadline_s = protocol.parse_submit(raw)
                    mnt = None
                else:
                    seq, priority, deadline_s, mnt = \
                        protocol.parse_generate(raw)
                try:
                    rec = outer.router.submit(seq, priority=priority,
                                              deadline_s=deadline_s,
                                              max_new_tokens=mnt)
                except RuntimeError as e:    # no healthy replicas
                    self._send_json(503, {"error": str(e)})
                    return
                body = protocol.encode_status(rec)
                body["events_url"] = f"{path}/{rec.request_id}/events"
                self._send_json(202, body)

            def _get(self) -> None:
                path = self.path.split("?", 1)[0]
                m = _FOLD_RE.match(path)
                if m:
                    rec = self._record_or_404(int(m.group(1)))
                    if m.group(2):                       # /events -> SSE
                        self._stream_events(rec)
                    else:
                        q = self._query()
                        # one wire knob for either workload's heavy
                        # optional payload: fold's distogram / LM's
                        # first-token logits
                        want = (q.get("distogram") in ("1", "true")
                                or q.get("logits") in ("1", "true"))
                        self._send_json(200, protocol.encode_status(
                            rec, include_distogram=want))
                    return
                m = _REPLICA_RE.match(path)
                if m:
                    i = int(m.group(1))
                    if not 0 <= i < len(outer.router.replicas):
                        self._send_json(404, {"error": f"no replica {i}"})
                        return
                    self._send(200, PROMETHEUS_CONTENT_TYPE,
                               outer.router.replica_metrics_text(i)
                               .encode("utf-8"))
                    return
                if path == "/healthz":
                    self._send_json(200, outer.router.healthz())
                elif path == "/v1/fleet":
                    self._send_json(200, outer.router.describe())
                elif path == "/metrics":
                    self._send(200, PROMETHEUS_CONTENT_TYPE,
                               outer.router.metrics_text().encode("utf-8"))
                elif path == "/metrics.json":
                    self._send_json(200, outer.router.metrics_json())
                else:
                    self._send_json(404, {"error": "not found"})

            def _delete(self) -> None:
                m = _FOLD_RE.match(self.path.split("?", 1)[0])
                if not m or m.group(2):
                    self._send_json(404, {"error": "not found"})
                    return
                rec = self._record_or_404(int(m.group(1)))
                cancelled = outer.router.cancel(rec.request_id)
                self._send_json(200, {
                    "id": rec.request_id, "cancelled": cancelled,
                    "state": rec.handle.status if rec.handle else "UNKNOWN",
                })

            # -- SSE --
            def _stream_events(self, rec) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                sent = 0
                while True:
                    for e in rec.events_since(sent):
                        self.wfile.write(protocol.sse_frame(e))
                        sent += 1
                        if e.kind in ev.TERMINAL_EVENTS:
                            self.wfile.flush()
                            return           # stream is complete
                    self.wfile.flush()
                    if not rec.wait_event(sent, timeout=SSE_POLL_S):
                        # liveness comment; also how we notice a consumer
                        # that hung up (write raises -> _guard swallows)
                        self.wfile.write(b": keepalive\n\n")
                        self.wfile.flush()

        super().__init__(Handler, port, host, name="fold-httpd")

    def describe(self) -> dict:
        return {"url": self.url, **self.router.describe()}


def request_json(url: str, *, method: str = "GET",
                 body: dict | None = None, timeout: float = 30.0) -> dict:
    """Tiny stdlib JSON-over-HTTP helper (examples, benches, tests)."""
    from urllib.request import Request, urlopen
    data = None if body is None else json.dumps(body).encode("utf-8")
    req = Request(url, data=data, method=method,
                  headers={"Content-Type": "application/json"})
    with urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))
