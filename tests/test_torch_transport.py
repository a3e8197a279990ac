"""The port's HTTP transport (``repro_torch/serving/transport``: the wire
protocol, the fleet router, the HTTP front-end) and its scrape endpoint
(``observability/httpd.py``) on the CPU, against the JAX reference.

Gates:
  * the wire format is byte-compatible: arrays, results, status bodies,
    LM results, events and SSE frames encode to identical bytes in both
    packages, each decodes the other's bitwise, and malformed payloads
    raise the same ``ProtocolError`` (message and HTTP status);
  * the router routes by the replicas' own registry gauges, requeues a
    failed replica's queued requests under their global ids, raises with
    every replica dead, and with ``max_restarts`` rebuilds the replica
    (without the router lock, so the healthy replica serves meanwhile) and
    releases the old client's engine;
  * over a real socket (ephemeral ports): submit, status, cancel, the SSE
    order, the lazy distogram, ``/metrics`` and ``/healthz``; a 2-replica
    fleet's results bitwise equal to an in-process ``FoldClient`` (one
    torch thread, so no matmul's summation order depends on its batch);
    ``/v1/generate`` on a fold fleet answers what the reference's fold
    fleet answers (status code and body);
  * the CLI's ``--listen``/``--replicas`` server and ``--metrics-port``.
"""
import functools
import json
import os
import subprocess
import sys
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import reduce_ppm_config as jax_reduce_cfg  # noqa: E402
from repro.models.ppm import init_ppm as jax_init_ppm  # noqa: E402
from repro.serving import events as jev  # noqa: E402
from repro.serving.client import FoldClient as JaxFoldClient  # noqa: E402
from repro.serving.lm import LMResult as JaxLMResult  # noqa: E402
from repro.serving.observability.httpd import parse_hostport as jax_parse_hostport  # noqa: E402
from repro.serving.transport import protocol as jproto  # noqa: E402
from repro.serving.transport.fleet import FleetRouter as JaxFleetRouter  # noqa: E402
from repro.serving.transport.server import FoldHTTPServer as JaxFoldHTTPServer  # noqa: E402
from repro.serving.types import FoldResult as JaxFoldResult  # noqa: E402
from repro_torch.configs import reduce_ppm_config  # noqa: E402
from repro_torch.data.pipeline import ProteinSampler  # noqa: E402
from repro_torch.models.ppm import init_ppm  # noqa: E402
from repro_torch.serving import (FleetRouter, FoldClient, FoldHTTPServer,  # noqa: E402
                                 MetricsRegistry, MetricsServer, check_request_order)
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.observability.httpd import parse_hostport  # noqa: E402
from repro_torch.serving.transport import protocol  # noqa: E402
from repro_torch.serving.transport.server import request_json  # noqa: E402
from repro_torch.serving.types import FoldResult, LMResult  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = reduce_ppm_config()
RNG = np.random.default_rng(13)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes at once, and
    a matmul's summation order then does not depend on its row count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _params():
    return init_ppm(CFG, seed=0, device="cpu")


def _seq(length: int) -> np.ndarray:
    return RNG.integers(0, 20, length).astype(np.int32)


def _client(**kw) -> FoldClient:
    kw.setdefault("buckets", (32,))
    kw.setdefault("max_tokens_per_batch", 64)
    kw.setdefault("max_batch", 2)
    return FoldClient(_params(), CFG, "lightnobel_aaq", device="cpu", **kw)


def _router(n: int = 2, *, autostart: bool = False, max_restarts: int = 0,
            **kw) -> FleetRouter:
    return FleetRouter(lambda i: _client(**kw), n, autostart=autostart,
                       max_restarts=max_restarts)


def _get_raw(url: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(url, timeout=30.0) as resp:
        return resp.status, resp.read()


def _answer(url: str, *, method: str = "GET", body: dict | None = None):
    """(HTTP status, JSON body) of one request, error statuses included."""
    data = None if body is None else json.dumps(body).encode("utf-8")
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30.0) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# --------------------------------------------------------------------------
# protocol: the wire bytes of both packages (no sockets, no engine)
# --------------------------------------------------------------------------
def _dumps(d) -> bytes:
    return json.dumps(d).encode("utf-8")


def _fold_result(cls, status: str = "ok"):
    rng = np.random.default_rng(5)
    return cls(request_id=3, length=5, status=status, reason="", bucket=32, batch_size=2,
               coords=rng.standard_normal((5, 3)).astype(np.float32),
               distogram=rng.standard_normal((5, 5, 4)).astype(np.float32),
               tm_vs_fp=0.975, priority=1, queue_wait_ms=1.25, compile_ms=0.0,
               run_ms=12.5, launched_batch=2, occupancy=0.40625, kernel_backend="auto:ref",
               placement="single", chunk_size=0)


def _lm_result(cls):
    return cls(request_id=9, prompt_len=4, tokens=np.array([5, 1, 7], np.int32),
               max_new_tokens=3, priority=2, queue_wait_ms=0.5, compile_ms=1.0, run_ms=3.0,
               steps=3, slot=1, kv_bytes=4096, kernel_backend="auto:ref",
               scheme="lightnobel_aaq",
               logits_first=np.linspace(-1, 1, 11, dtype=np.float32))


def _record(result, state: str, done: bool):
    handle = types.SimpleNamespace(status=state, done=done, length=5, priority=1,
                                   deadline_s=2.5, _result=result)
    return types.SimpleNamespace(request_id=7, replica_index=1, requeues=1,
                                 events=[0, 1, 2], handle=handle)


def _events(mod):
    return [mod.FoldEvent(seq=7, kind=mod.SUBMITTED, request_id=3, t=1.0,
                          data={"length": 20, "priority": 0, "deadline_s": None}),
            mod.FoldEvent(seq=9, kind=mod.BATCH_START, request_id=3, t=2.0,
                          data={"request_ids": (3, 4), "bucket": 32}),
            mod.FoldEvent(seq=12, kind=mod.COMPLETED, request_id=3, t=3.5, data={})]


@pytest.mark.parametrize("kind", ["array", "result", "status", "lm_result", "event"])
def test_wire_bytes_match_reference_both_directions(kind):
    if kind == "array":
        for arr in (np.linspace(-3, 7, 12, dtype=np.float32).reshape(4, 3),
                    np.arange(6, dtype=np.int32), np.array([True, False]),
                    RNG.standard_normal((2, 5, 5)).astype(np.float64)):
            mine, ref = protocol.encode_array(arr), jproto.encode_array(arr)
            assert _dumps(mine) == _dumps(ref)
            for back in (protocol.decode_array(ref), jproto.decode_array(mine)):
                assert back.dtype == arr.dtype and back.shape == arr.shape
                assert back.tobytes() == arr.tobytes()
    elif kind == "result":
        mine, ref = _fold_result(FoldResult), _fold_result(JaxFoldResult)
        for dist in (False, True):
            a = protocol.encode_result(mine, include_distogram=dist)
            b = jproto.encode_result(ref, include_distogram=dist)
            assert _dumps(a) == _dumps(b)
        back, jback = protocol.decode_result(b), jproto.decode_result(a)
        assert isinstance(back, FoldResult) and isinstance(jback, JaxFoldResult)
        for r in (back, jback):
            assert r.coords.tobytes() == mine.coords.tobytes()
            assert r.distogram.tobytes() == mine.distogram.tobytes()
            assert (r.tm_vs_fp, r.run_ms, r.placement) == (0.975, 12.5, "single")
    elif kind == "status":
        cases = [((None, None), "QUEUED", False),
                 ((_fold_result(FoldResult), _fold_result(JaxFoldResult)), "DONE", True),
                 ((_fold_result(FoldResult, "rejected"),
                   _fold_result(JaxFoldResult, "rejected")), "REJECTED", True),
                 ((_lm_result(LMResult), _lm_result(JaxLMResult)), "DONE", True)]
        for (mine, ref), state, done in cases:
            for heavy in (False, True):
                a = protocol.encode_status(_record(mine, state, done), include_distogram=heavy)
                b = jproto.encode_status(_record(ref, state, done), include_distogram=heavy)
                assert _dumps(a) == _dumps(b)
    elif kind == "lm_result":
        mine, ref = _lm_result(LMResult), _lm_result(JaxLMResult)
        for logits in (False, True):
            a = protocol.encode_lm_result(mine, include_logits=logits)
            b = jproto.encode_lm_result(ref, include_logits=logits)
            assert _dumps(a) == _dumps(b)
        back, jback = protocol.decode_lm_result(b), jproto.decode_lm_result(a)
        for r in (back, jback):
            assert r.tokens.dtype == np.int32 and r.tokens.tolist() == [5, 1, 7]
            assert r.logits_first.tobytes() == mine.logits_first.tobytes()
            assert (r.steps, r.kv_bytes, r.new_tokens, r.ok) == (3, 4096, 3, True)
    else:
        mine, ref = _events(ev), _events(jev)
        for a, b in zip(mine, ref):
            assert _dumps(protocol.encode_event(a)) == _dumps(jproto.encode_event(b))
            assert protocol.sse_frame(a) == jproto.sse_frame(b)
        body = b"".join(protocol.sse_frame(e) for e in mine)
        jbody = b"".join(jproto.sse_frame(e) for e in ref)
        assert body == jbody and body.startswith(b"id: 7\nevent: submitted\ndata: ")
        for parsed in (protocol.parse_sse(jbody), jproto.parse_sse(body)):
            assert [(e.seq, e.kind, e.request_id, e.t) for e in parsed] == \
                [(e.seq, e.kind, e.request_id, e.t) for e in mine]
            assert parsed[1].data["request_ids"] == [3, 4]     # tuple -> list on wire


def _error(fn, arg):
    try:
        fn(arg)
    except Exception as e:          # noqa: BLE001 - the error itself is compared
        return type(e).__name__, str(e), getattr(e, "http_status", None)
    return None


_BAD = {
    "decode_array": [{"shape": [3], "dtype": "float32"},
                     {"shape": [4], "dtype": "nope", "b64": "AA=="},
                     {"shape": [5], "dtype": "float32", "b64": "AAAA"}],
    "parse_sequence": ["", "AB1", [], [0, 21], [[0, 1]], 42, [0.5], [-1]],
    "parse_submit": [b"not json", b"[1,2]", b"\xff\xfe",
                     _dumps({"priority": 1}), _dumps({"sequence": "A", "bogus": 1}),
                     _dumps({"sequence": "A", "priority": "hi"}),
                     _dumps({"sequence": "A", "priority": True}),
                     _dumps({"sequence": "A", "deadline_s": -2}),
                     _dumps({"sequence": "A", "deadline_s": "soon"})],
    "parse_generate": [b"not json", b"[1]", _dumps({"max_new_tokens": 3}),
                       _dumps({"prompt": []}), _dumps({"prompt": "abc"}),
                       _dumps({"prompt": [1.5]}), _dumps({"prompt": [[1, 2]]}),
                       _dumps({"prompt": [-1]}), _dumps({"prompt": [1], "max_new_tokens": 0}),
                       _dumps({"prompt": [1], "max_new_tokens": True}),
                       _dumps({"prompt": [1], "extra": 1})],
    "decode_event": [{"kind": "submitted"}, {"seq": "x", "kind": "k", "request_id": 1, "t": 0}],
    "decode_result": [{"request_id": 1}, {"request_id": 1, "length": 2, "coords": {"b64": 1}}],
}


@pytest.mark.parametrize("parser", sorted(_BAD))
def test_malformed_payloads_raise_the_same_errors(parser):
    for bad in _BAD[parser]:
        mine = _error(getattr(protocol, parser), bad)
        ref = _error(getattr(jproto, parser), bad)
        assert mine is not None and mine[0] == "ProtocolError", (bad, mine)
        assert mine == ref, (bad, mine, ref)


def test_parse_hostport_matches_reference():
    for spec in ("127.0.0.1:8080", "9090", "0.0.0.0:0", " localhost:17 ", ":5"):
        assert parse_hostport(spec) == jax_parse_hostport(spec) != ()
    for bad in ("", "host:", "host:abc", "host:70000", "host:-1"):
        assert _error(parse_hostport, bad) == _error(jax_parse_hostport, bad)
        with pytest.raises(ValueError):
            parse_hostport(bad)


# --------------------------------------------------------------------------
# the scrape endpoint
# --------------------------------------------------------------------------
class _RegistryOwner:
    """The surface MetricsServer scrapes (a FoldClient stand-in)."""
    driving = False
    pending = 0

    def __init__(self, reg: MetricsRegistry):
        self.reg = reg

    def metrics_text(self) -> str:
        return self.reg.prometheus_text()

    def metrics_json(self) -> dict:
        return self.reg.as_dict()


def test_metrics_server_binds_ephemeral_port_and_reports_it():
    reg = MetricsRegistry()
    reg.counter("demo_total", "demo").inc()
    with MetricsServer(_RegistryOwner(reg), port=0) as srv:
        assert srv.port != 0 and f":{srv.port}" in srv.url
        status, body = _get_raw(f"{srv.url}/metrics")
        assert status == 200 and b"demo_total 1" in body
        assert request_json(f"{srv.url}/metrics.json")["demo_total"]
        status, body = _get_raw(f"{srv.url}/healthz")
        assert status == 200 and json.loads(body) == {"ok": True, "driving": False,
                                                      "pending": 0}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get_raw(f"{srv.url}/nope")
        assert ei.value.code == 404


# --------------------------------------------------------------------------
# fleet router: telemetry-driven routing + failure isolation (no HTTP)
# --------------------------------------------------------------------------
def test_router_prefers_idle_replica_by_injected_telemetry():
    router = _router(2)
    try:
        r0, r1 = router.replicas
        r0.registry.gauge("fold_queue_depth").set(5)
        assert router.pick_replica() is r1
        r0.registry.gauge("fold_queue_depth").set(0)
        r1.registry.gauge("fold_queue_depth").set(3)
        assert router.pick_replica() is r0
        r1.registry.gauge("fold_queue_depth").set(0)
        assert router.pick_replica() is r0            # ties: the lowest index
        r0.registry.gauge("fold_inflight_batches").set(2)
        assert router.pick_replica() is r1            # in-flight is the second key
    finally:
        router.stop()


def _assert_one_legal_stream(recs):
    for rec in recs:
        check_request_order(rec.events)
        kinds = [e.kind for e in rec.events]
        assert kinds.count(ev.SUBMITTED) == 1 and kinds[-1] == ev.COMPLETED
        assert all(e.request_id == rec.request_id for e in rec.events)


def test_replica_failure_requeues_queued_requests_under_their_ids():
    router = _router(2)
    try:
        recs = [router.submit(_seq(16 + i), priority=i % 2) for i in range(3)]
        assert [r.request_id for r in recs] == [0, 1, 2]
        assert recs[0].replica_index == 0
        assert all(r.handle.status == "QUEUED" for r in recs)
        router.replicas[0].mark_failed()
        requeued = router.check_health()
        victims = [r for r in recs if r.requeues]
        assert requeued and {r.request_id for r in victims} == set(requeued)
        assert all(r.replica_index == 1 for r in recs)
        # the same global id on the healthy replica
        assert all(r.handle.request_id == r.request_id for r in recs)
        assert router.registry.get("fleet_requeued_total").total() == len(victims)
        router.start()
        assert not router.replicas[0].started
        assert all(r.handle.result(timeout=300.0).ok for r in recs)
        _assert_one_legal_stream(recs)
    finally:
        router.stop()


def test_router_with_all_replicas_dead_raises():
    router = _router(1)
    router.replicas[0].mark_failed()
    assert router.check_health() == []
    with pytest.raises(RuntimeError, match="no healthy replicas"):
        router.submit(_seq(8))
    assert router.healthz()["ok"] is False


def test_max_restarts_rebuilds_replica_and_releases_old_client():
    router = _router(2, max_restarts=1, fidelity=False)
    try:
        first = router.submit(_seq(20))
        old = router.replicas[0].client
        assert first.replica_index == 0
        old.drive()                                   # replica 0 serves one batch
        assert first.handle.result().ok and old.core._executables
        recs = [router.submit(_seq(16 + i)) for i in range(3)]
        on_old = [r for r in recs if r.replica_index == 0]
        assert on_old
        router.replicas[0].mark_failed()
        requeued = router.check_health()
        assert sorted(requeued) == sorted(r.request_id for r in on_old)
        r0 = router.replicas[0]
        assert r0.healthy and r0.restarts == 1 and r0.client is not old
        router.join_released(timeout=60.0)
        assert router.released == [old]
        assert old.core._executables == {} and not old.driving and old.events.closed
        assert router.registry.get("fleet_replica_restarts_total").total() == 1
        router.start()
        assert all(r.handle.result(timeout=300.0).ok for r in recs)
        _assert_one_legal_stream(recs)
        assert [r.requeues for r in recs] == [int(r in on_old) for r in recs]
        # the budget is spent: a second failure leaves the replica dead
        router.replicas[0].mark_failed()
        router.check_health()
        assert not router.replicas[0].healthy and router.replicas[0].restarts == 1
    finally:
        router.stop()


def test_restart_builds_the_replica_without_the_router_lock():
    """A restart's factory (on the card, a warm-up capturing a graph per
    key) runs without the router lock: while it is held up, the healthy
    replica takes submits and serves them, healthz answers, and a second
    caller builds nothing."""
    import threading
    entered, gate = threading.Event(), threading.Event()
    built = []

    def factory(i):
        if len(built) >= 2:                           # the restart
            entered.set()
            assert gate.wait(120.0)
        built.append(i)
        return _client(fidelity=False)

    router = FleetRouter(factory, 2, autostart=True, max_restarts=1)
    try:
        router.replicas[0].mark_failed()
        rebuild = threading.Thread(target=router.check_health)
        rebuild.start()
        assert entered.wait(60.0)
        routed = []                                   # a held lock would block it
        submit = threading.Thread(target=lambda: routed.append(router.submit(_seq(16))))
        submit.start()
        submit.join(60.0)
        assert routed, "submit waited for the restart"
        rec = routed[0]
        assert rec.replica_index == 1
        assert rec.handle.result(timeout=300.0).ok
        assert [r["healthy"] for r in router.healthz()["replicas"]] == [False, True]
        assert router.check_health() == [] and built == [0, 1]
        gate.set()
        rebuild.join(60.0)
        assert not rebuild.is_alive()
        r0 = router.replicas[0]
        assert r0.healthy and r0.restarts == 1 and not r0.rebuilding and built == [0, 1, 0]
        _assert_one_legal_stream([rec])
    finally:
        gate.set()
        router.stop()


# --------------------------------------------------------------------------
# HTTP over a real socket
# --------------------------------------------------------------------------
def test_http_submit_status_result_bitwise_and_lazy_distogram():
    client = _client(fidelity=False)
    seq = _seq(24)
    ref = client.submit(seq).result()
    router = FleetRouter.wrap(client, autostart=True)
    try:
        with FoldHTTPServer(router) as srv:
            assert srv.port != 0
            resp = request_json(f"{srv.url}/v1/fold", method="POST",
                                body={"sequence": seq.tolist(), "priority": 1})
            rid = resp["id"]
            assert resp["v"] == protocol.PROTOCOL_VERSION
            assert resp["events_url"] == f"/v1/fold/{rid}/events"
            rec = router.get(rid)
            rec.handle.result(timeout=300.0)
            status = request_json(f"{srv.url}/v1/fold/{rid}")
            assert status["state"] == "DONE" and status["done"]
            coords = protocol.decode_array(status["result"]["coords"])
            assert coords.tobytes() == ref.coords.tobytes()
            # plain polls never ship (or materialize) the distogram
            assert status["result"]["distogram"] is None
            assert rec.handle._result.distogram.materialized is False
            with_dist = request_json(f"{srv.url}/v1/fold/{rid}?distogram=1")
            dist = protocol.decode_array(with_dist["result"]["distogram"])
            assert rec.handle._result.distogram.materialized is True
            np.testing.assert_array_equal(dist, np.asarray(rec.handle._result.distogram))
            np.testing.assert_array_equal(dist, np.asarray(ref.distogram))
            restored = protocol.decode_result(with_dist["result"])
            assert restored.ok and restored.coords.tobytes() == ref.coords.tobytes()
            assert _answer(f"{srv.url}/v1/fold/999999")[0] == 404
            code, body = _answer(f"{srv.url}/v1/fold", method="POST", body={"sequence": "AB1"})
            assert code == 400 and "unknown amino-acid" in body["error"]
            assert _answer(f"{srv.url}/v1/nothing", method="POST", body={})[0] == 404
    finally:
        router.stop()


def test_http_cancel_and_sse_stream_order():
    router = _router(1)                               # nothing runs until start()
    try:
        with FoldHTTPServer(router) as srv:
            rid = request_json(f"{srv.url}/v1/fold", method="POST",
                               body={"sequence": _seq(16).tolist()})["id"]
            resp = request_json(f"{srv.url}/v1/fold/{rid}", method="DELETE")
            assert resp == {"id": rid, "cancelled": True, "state": "CANCELLED"}
            status = request_json(f"{srv.url}/v1/fold/{rid}")
            assert status["state"] == "CANCELLED" and status["done"]
            assert status["result"]["status"] == "cancelled"
            resp = request_json(f"{srv.url}/v1/fold/{rid}", method="DELETE")
            assert resp["cancelled"] is False
            _, body = _get_raw(f"{srv.url}/v1/fold/{rid}/events")
            events = protocol.parse_sse(body)
            check_request_order(events)
            assert [e.kind for e in events] == [ev.SUBMITTED, ev.CANCELLED]
            assert all(e.request_id == rid for e in events)
    finally:
        router.stop()


def test_http_fleet_endpoints_and_metrics():
    router = _router(2)
    try:
        with FoldHTTPServer(router) as srv:
            hz = request_json(f"{srv.url}/healthz")
            assert hz["ok"] and len(hz["replicas"]) == 2 and hz["live_requests"] == 0
            fleet = request_json(f"{srv.url}/v1/fleet")
            assert fleet["replicas"] == 2 and fleet["healthy"] == 2
            assert fleet["workloads"] == ["fold", "fold"]
            assert srv.describe()["url"] == srv.url
            status, body = _get_raw(f"{srv.url}/metrics")
            text = body.decode()
            assert status == 200
            for series in ("fleet_replica_healthy", "fleet_live_records",
                           "fleet_replica_queue_depth"):
                assert series in text
            assert "fleet_replica_healthy" in request_json(f"{srv.url}/metrics.json")
            _, body = _get_raw(f"{srv.url}/metrics/replica/1")
            assert b"fold_queue_depth" in body
            assert _answer(f"{srv.url}/metrics/replica/7")[0] == 404
    finally:
        router.stop()


def test_fleet_http_end_to_end_bitwise_vs_inprocess():
    sampler = ProteinSampler(seed=11, min_len=20, max_len=32)
    trace = [sampler.sample(i) for i in range(8)]
    priorities = [1 - (i % 2) for i in range(8)]
    reference = _client(fidelity=False)
    handles = [reference.submit(s, priority=p) for s, p in zip(trace, priorities)]
    reference.drive()
    ref_results = [h.result() for h in handles]
    router = _router(2, autostart=True, fidelity=False)
    try:
        with FoldHTTPServer(router) as srv:
            ids = [request_json(f"{srv.url}/v1/fold", method="POST",
                                body={"sequence": s.tolist(), "priority": p})["id"]
                   for s, p in zip(trace, priorities)]
            router.drain_wait(timeout=300.0)
            statuses = [request_json(f"{srv.url}/v1/fold/{rid}") for rid in ids]
            # SSE of a terminal request replays its whole history and closes
            for rid in ids:
                _, body = _get_raw(f"{srv.url}/v1/fold/{rid}/events")
                events = protocol.parse_sse(body)
                check_request_order(events)
                assert events[-1].kind == ev.COMPLETED
        for st, ref in zip(statuses, ref_results):
            assert st["state"] == "DONE"
            got = protocol.decode_array(st["result"]["coords"])
            assert got.tobytes() == ref.coords.tobytes()
            assert st["result"]["priority"] == ref.priority
        assert router.registry.get("fleet_routed_total").total() == len(trace)
        for rid in ids:
            rec = router.get(rid)
            check_request_order(rec.events)
            assert [e.kind for e in rec.events][-1] == ev.COMPLETED
    finally:
        router.stop()


def test_generate_on_a_fold_fleet_answers_as_the_reference():
    """The port has no LM tenant; ``/v1/generate`` on a fold fleet gives
    the reference fold fleet's status code and body for a valid prompt, a
    prompt longer than every bucket, a malformed body, and the status poll."""
    jcfg = jax_reduce_cfg()
    jparams = jax_init_ppm(jax.random.PRNGKey(0), jcfg)
    kw = dict(buckets=(32,), max_tokens_per_batch=64, max_batch=2)
    jrouter = JaxFleetRouter(lambda i: JaxFoldClient(jparams, jcfg, "lightnobel_aaq", **kw),
                             1, autostart=False)
    router = _router(1)
    bodies = [{"prompt": [1, 2, 3], "max_new_tokens": 4, "priority": 1},
              {"prompt": [0] * 40, "deadline_s": 5.0},
              {"prompt": []}, {"prompt": [1], "max_new_tokens": 0}, {"sequence": "A"}]
    try:
        with FoldHTTPServer(router) as srv, JaxFoldHTTPServer(jrouter) as jsrv:
            for body in bodies:
                mine = _answer(f"{srv.url}/v1/generate", method="POST", body=body)
                ref = _answer(f"{jsrv.url}/v1/generate", method="POST", body=body)
                assert mine == ref, (body, mine, ref)
            for path in ("/v1/generate/0", "/v1/generate/1", "/v1/fold/1?logits=1"):
                assert _answer(srv.url + path) == _answer(jsrv.url + path), path
            assert _answer(f"{srv.url}/v1/generate/0", method="DELETE") == \
                _answer(f"{jsrv.url}/v1/generate/0", method="DELETE")
    finally:
        router.stop()
        jrouter.stop()


# --------------------------------------------------------------------------
# the CLI: --listen/--replicas/--max-restarts and --metrics-port
# --------------------------------------------------------------------------
def _launch(argv: list[str]) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", "--mode", "ppm",
                             "--device", "cpu", *argv], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _read_until(proc: subprocess.Popen, marker: str) -> list[str]:
    lines = []
    for line in proc.stdout:
        lines.append(line.rstrip("\n"))
        if line.startswith(marker):
            return lines
    raise AssertionError(f"no {marker!r} line; output: {lines}")


def test_cli_listen_serves_a_fleet_and_shuts_down_with_replica_summaries():
    proc = _launch(["--listen", "127.0.0.1:0", "--replicas", "2", "--max-restarts", "1",
                    "--buckets", "32,48", "--no-fidelity", "--serve-for-s", "240"])
    try:
        banner = _read_until(proc, "# listening ")[-1]
        url = banner.split()[2]
        assert "replicas=2" in banner and "buckets=32,48" in banner
        assert "kernels=auto:ref" in banner
        ids = [request_json(f"{url}/v1/fold", method="POST",
                            body={"sequence": "MKTAYIAKQRQISFVKSHFSRQ"})["id"],
               request_json(f"{url}/v1/fold", method="POST",
                            body={"sequence": _seq(40).tolist(), "priority": 1})["id"]]
        for rid in ids:
            _, body = _get_raw(f"{url}/v1/fold/{rid}/events")   # follows to the end
            assert protocol.parse_sse(body)[-1].kind == ev.COMPLETED
            assert request_json(f"{url}/v1/fold/{rid}")["result"]["status"] == "ok"
        hz = request_json(f"{url}/healthz")
        assert hz["ok"] and [r["restarts"] for r in hz["replicas"]] == [0, 0]
        proc.terminate()                              # SIGTERM: the graceful drain
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = out.splitlines()
    assert proc.returncode == 0, out
    summaries = [ln for ln in lines if ln.startswith("# replica=")]
    assert [ln.split()[1] for ln in summaries] == ["replica=0", "replica=1"]
    served = sum(int(ln.split()[2].split("=")[1].split("/")[0]) for ln in summaries)
    assert served == 2
    assert lines[0] == "# shutting down" and lines[-1] == "# fleet shutdown complete"


def test_cli_metrics_port_serves_the_engine_registry():
    proc = _launch(["--n", "2", "--buckets", "32,48", "--max-batch", "2",
                    "--metrics-port", "0", "--metrics-hold-s", "120"])
    try:
        lines = _read_until(proc, "# metrics endpoint holding")
        url = next(ln.split()[3] for ln in lines if ln.startswith("# metrics endpoint http"))
        assert url.endswith("/metrics")
        status, body = _get_raw(url)
        assert status == 200 and b"fold_queue_depth" in body
        ok = [ln for ln in body.decode().splitlines()
              if ln.startswith('fold_requests_total{status="ok"')]
        assert sum(float(ln.split()[-1]) for ln in ok) == 2
        assert request_json(url.replace("/metrics", "/healthz"))["ok"] is True
    finally:
        proc.kill()
        proc.communicate()
    assert any(ln.startswith("# served=2/2") for ln in lines), lines
