"""The port's LM decode tenant on the CPU: the reference's LM serving tests
mirrored (continuous per-token batching, priority seating, KV-bytes
admission, token events, the fleet's replica restart, ``/v1/generate`` over
HTTP), admission held exactly to the reference's, and the port's
``LMClient`` against the reference's on the same prompts and bridged
parameters.

Gates against the reference:
  * ``LMKVAdmission``: bytes per request and every verdict equal;
  * ``baseline_fp16`` and ``lightnobel_aaq`` (INT4 KV ring): identical
    token streams, ``logits_first`` allclose 1e-4 (float32 sums in another
    order; ~1e-6 read under both);
  * the CLI's AAQ-vs-fp16 ``kv_drift``: above 0 and within 0.25, the
    reference example's gate.
Bitwise assertions run with one torch thread.
"""
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import LMClient as JLMClient  # noqa: E402
from repro_torch.bridge import lm_params_from_numpy  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.serving import (ADMIT, DEFER, REJECT, FleetRouter,  # noqa: E402
                                 FoldHTTPServer, LMClient, check_request_order)
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.transport.server import request_json  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_FIELDS = dict(name="tiny-lm", kind="dense", layers=2, d_model=32, n_heads=2,
               n_kv_heads=2, d_ff=64, vocab=61, dtype="float32")
CFG = ArchConfig(**_FIELDS)
JCFG = JArchConfig(**_FIELDS)
JPARAMS = jlm.init_params(jax.random.PRNGKey(0), JCFG)
PARAMS = lm_params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, device="cpu")
RNG = np.random.default_rng(7)

#: per-request KV footprint at window=32 under each scheme:
#: layers*2*window*heads*hd*bits/8 = 2*2*32*2*16*{16,6}/8
FP16_KV_BYTES = 8192
AAQ_KV_BYTES = 3072


def _prompt(n: int) -> np.ndarray:
    return RNG.integers(0, CFG.vocab, n).astype(np.int32)


def _client(scheme: str = "lightnobel_aaq", **kw) -> LMClient:
    kw.setdefault("window", 32)
    kw.setdefault("max_slots", 2)
    kw.setdefault("default_max_new_tokens", 5)
    return LMClient(PARAMS, CFG, scheme, device="cpu", **kw)


# --------------------------------------------------------------------------
# continuous batching: solo == batched, per token and per logit
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["baseline_fp16", "lightnobel_aaq"])
def test_joining_and_leaving_mid_decode_keeps_streams_bitwise(scheme):
    """Three requests with different generation lengths share two slots:
    request 2 joins after request 0 retires (mid-decode for request 1), so
    every slot-composition transition happens, and every request's token
    stream and first-token logits must equal its solo run."""
    prompts = [_prompt(4), _prompt(9), _prompt(6)]
    lengths = [3, 8, 5]

    solo = []
    for p, n in zip(prompts, lengths):
        r = _client(scheme).run([p], max_new_tokens=n)[0]
        assert r.ok
        solo.append(r)

    client = _client(scheme)
    for p, n in zip(prompts, lengths):
        client.submit(p, max_new_tokens=n)
    batched = client.run([], reset_metrics=False)
    assert [r.request_id for r in batched] == [0, 1, 2]
    assert {r.slot for r in batched[:2]} == {0, 1}   # both slots used
    for s, b in zip(solo, batched):
        assert b.ok and b.new_tokens == s.new_tokens
        assert np.array_equal(s.tokens, b.tokens)
        assert s.logits_first.tobytes() == b.logits_first.tobytes()
    # one executable shape -> exactly one capture, zero steady-state
    assert client.metrics.summary()["compiles"] == 1


def test_priority_orders_seating_when_slots_are_scarce():
    client = _client(max_slots=1)
    events = []
    client.subscribe(events.append)
    h_lo = client.submit(_prompt(4), priority=0, max_new_tokens=2)
    h_hi = client.submit(_prompt(4), priority=5, max_new_tokens=2)
    client.drive()
    assert h_lo.result().ok and h_hi.result().ok
    # the later-submitted high-priority request was seated first
    seated = [e.request_id for e in events if e.kind == ev.SCHEDULED]
    assert seated == [h_hi.request_id, h_lo.request_id]


# --------------------------------------------------------------------------
# admission: KV bytes at the scheme's bits-per-value
# --------------------------------------------------------------------------
def test_kv_admission_prices_quantized_cache_cheaper():
    """One budget, two schemes: 5 KB per request fits the AAQ cache
    (6 bits/value) but not fp16 (16 bits/value)."""
    budget_mb = 5000 / 1e6                     # engine MB = 1e6 bytes
    fp16 = _client("baseline_fp16", mem_budget_mb=budget_mb)
    assert fp16.core.admission.bytes_per_request == FP16_KV_BYTES
    h = fp16.submit(_prompt(4), max_new_tokens=2)
    assert h.status == "REJECTED"
    r = h.result()
    assert not r.ok and "bits/value" in r.reason

    aaq = _client("lightnobel_aaq", mem_budget_mb=budget_mb)
    assert aaq.core.admission.bytes_per_request == AAQ_KV_BYTES
    r = aaq.submit(_prompt(4), max_new_tokens=2).result()
    assert r.ok and r.kv_bytes == AAQ_KV_BYTES


def test_kv_admission_flips_from_reject_to_admit_with_budget():
    below = _client(mem_budget_mb=(AAQ_KV_BYTES - 1) / 1e6)
    assert below.submit(_prompt(4)).status == "REJECTED"
    assert below.core.admission.admit(32, 1).verdict == REJECT
    at = _client(mem_budget_mb=AAQ_KV_BYTES / 1e6)
    assert at.core.admission.admit(32, 1).verdict == ADMIT
    assert at.submit(_prompt(4), max_new_tokens=2).result().ok


def test_kv_admission_defers_second_request_until_a_slot_frees():
    """Budget for exactly one resident cache: the second request DEFERs
    (with the decision's telemetry on the event), then serves once the
    first retires: backpressure, not rejection."""
    client = _client(mem_budget_mb=AAQ_KV_BYTES * 1.5 / 1e6)
    assert client.core.admission.admit(32, 2).verdict == DEFER
    events = []
    client.subscribe(events.append)
    h1 = client.submit(_prompt(4), max_new_tokens=3)
    h2 = client.submit(_prompt(4), max_new_tokens=3)
    client.drive()
    assert h1.result().ok and h2.result().ok
    deferred = [e for e in events if e.kind == ev.DEFERRED]
    assert deferred and deferred[0].request_id == h2.request_id
    assert deferred[0].data["est_mb"] == 2 * AAQ_KV_BYTES / 1e6
    assert deferred[0].data["estimator"] == "kv_bytes"


@pytest.mark.parametrize("scheme", ["baseline_fp16", "lightnobel_aaq"])
@pytest.mark.parametrize("budget_bytes", [AAQ_KV_BYTES - 1, 5000, 2 * FP16_KV_BYTES],
                         ids=["below-aaq", "between", "two-fp16"])
def test_kv_admission_equals_the_reference(scheme, budget_bytes):
    """Bytes per request, bits per value and every verdict (with its byte
    estimate and reason) are the reference's, for 1-3 slots."""
    mb = budget_bytes / 1e6
    ours = LMClient(PARAMS, CFG, scheme, window=32, max_slots=2,
                    mem_budget_mb=mb, device="cpu").core.admission
    ref = JLMClient(JPARAMS, JCFG, scheme, window=32, max_slots=2,
                    mem_budget_mb=mb).core.admission
    assert ours.bytes_per_request == ref.bytes_per_request
    assert ours.bits_per_value == ref.bits_per_value
    for batch in (1, 2, 3):
        a, b = ours.admit(32, batch), ref.admit(32, batch)
        assert (a.verdict, a.est_bytes, a.budget_bytes, a.reason, a.estimator) == \
            (b.verdict, b.est_bytes, b.budget_bytes, b.reason, b.estimator)
        assert ours.max_batch_for(32, 4) == ref.max_batch_for(32, 4)
        assert ours.explain(32, batch) == ref.explain(32, batch)


# --------------------------------------------------------------------------
# the port against the reference, same prompts and parameters
# --------------------------------------------------------------------------
def _trace():
    rng = np.random.default_rng(11)            # the reference example's trace
    return [rng.integers(0, CFG.vocab, size=int(rng.integers(4, 17))).astype(np.int32)
            for _ in range(4)]


@pytest.mark.parametrize("scheme", ["baseline_fp16", "lightnobel_aaq"])
def test_client_matches_the_reference_client(scheme, capsys):
    prompts = _trace()
    kw = dict(window=32, max_slots=2, default_max_new_tokens=6)
    ours = LMClient(PARAMS, CFG, scheme, device="cpu", **kw).run(prompts)
    ref = JLMClient(JPARAMS, JCFG, scheme, **kw).run(prompts)
    assert [r.request_id for r in ours] == [r.request_id for r in ref]
    assert all(r.ok for r in ours) and all(r.ok for r in ref)
    assert [r.kv_bytes for r in ours] == [r.kv_bytes for r in ref]
    drift = max(float(np.max(np.abs(a.logits_first - b.logits_first)))
                for a, b in zip(ours, ref))
    with capsys.disabled():
        print(f"\n{scheme}: max |logits_first(port) - logits_first(jax)| = {drift:.3e}")
    # under AAQ too: both quantize the KV rows with the same rule, so the
    # reading (~1e-6) sits two orders below the limit; a ring that skipped
    # quantization, or read it back wrong, is off by ~1e-1 and fails
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logits_first, b.logits_first, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# token events + background driver
# --------------------------------------------------------------------------
def test_token_events_stream_in_order_under_the_background_driver():
    client = _client()
    per_req: dict[int, list] = {}
    client.subscribe(
        lambda e: per_req.setdefault(e.request_id, []).append(e))
    client.start()
    try:
        handles = [client.submit(_prompt(4 + i), max_new_tokens=4)
                   for i in range(3)]
        results = {h.request_id: h.result(timeout=600.0) for h in handles}
    finally:
        client.stop()
    for rid, evs in per_req.items():
        check_request_order(evs)             # TOKEN legality included
        toks = [e for e in evs if e.kind == ev.TOKEN]
        assert len(toks) == 4 == results[rid].new_tokens
        assert [t.data["token"] for t in toks] == list(results[rid].tokens)
        assert [t.data["step"] for t in toks] == [0, 1, 2, 3]


# --------------------------------------------------------------------------
# fleet: replica auto-restart (bounded by max_restarts)
# --------------------------------------------------------------------------
def test_fleet_restarts_dead_replica_and_requeues_its_queue():
    built = []

    def factory(i):
        c = _client()
        built.append(c)
        return c

    router = FleetRouter(factory, 2, autostart=False, max_restarts=1)
    try:
        recs = [router.submit(_prompt(4 + i), max_new_tokens=3)
                for i in range(3)]
        assert all(r.handle.status == "QUEUED" for r in recs)
        n_before = len(built)

        router.replicas[0].mark_failed()
        requeued = router.check_health()
        assert requeued                       # replica 0's queue drained
        # a FRESH client was built and the replica rejoined the fleet
        assert len(built) == n_before + 1
        assert router.replicas[0].client is built[-1]
        assert router.replicas[0].healthy
        assert router.replicas[0].restarts == 1
        assert router.registry.get(
            "fleet_replica_restarts_total").total() == 1

        router.start()
        results = [r.handle.result(timeout=600.0) for r in recs]
        assert all(res.ok for res in results)
        for rec in recs:                      # ids survive the requeue
            check_request_order(rec.events)
            kinds = [e.kind for e in rec.events]
            assert kinds.count(ev.SUBMITTED) == 1
            assert kinds[-1] == ev.COMPLETED

        # budget exhausted: a second death stays dead
        router.replicas[0].mark_failed()
        router.check_health()
        assert not router.replicas[0].healthy
        assert router.replicas[0].restarts == 1
        router.join_released(timeout=60.0)
        assert built[0] in router.released    # the replaced client was closed
    finally:
        router.stop()


# --------------------------------------------------------------------------
# HTTP transport: /v1/generate end to end
# --------------------------------------------------------------------------
def _sse(url: str) -> list:
    with urllib.request.urlopen(url, timeout=60.0) as resp:
        frames = resp.read().decode("utf-8")
    events = []
    for block in frames.strip().split("\n\n"):
        kind = data = None
        for line in block.split("\n"):
            if line.startswith("event: "):
                kind = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
        if kind:
            events.append((kind, data))
    return events


def test_generate_over_http_with_sse_tokens_and_labeled_metrics():
    router = FleetRouter(lambda i: _client(), 1, autostart=True)
    try:
        with FoldHTTPServer(router) as srv:
            doc = request_json(
                f"{srv.url}/v1/generate", method="POST",
                body={"prompt": [1, 2, 3], "max_new_tokens": 4,
                      "priority": 1})
            rid = doc["id"]
            assert doc["events_url"] == f"/v1/generate/{rid}/events"

            # SSE replays history then follows to the terminal event
            events = _sse(f"{srv.url}/v1/generate/{rid}/events")
            kinds = [k for k, _ in events]
            assert kinds.count(ev.TOKEN) == 4
            assert kinds[-1] == ev.COMPLETED

            st = request_json(f"{srv.url}/v1/generate/{rid}?logits=1")
            assert st["state"] == "DONE" and st["workload"] == "lm"
            res = st["result"]
            assert res["scheme"] == "lightnobel_aaq"
            assert res["kv_bytes"] == AAQ_KV_BYTES
            assert res["tokens"] == [d["data"]["token"]
                                     for k, d in events if k == ev.TOKEN]
            assert res["logits_first"] is not None

            # the wire tokens are the in-process client's, bitwise
            solo = _client().run([np.array([1, 2, 3], np.int32)], max_new_tokens=4)[0]
            assert res["tokens"] == [int(t) for t in solo.tokens]

            # the replica's scrape carries the workload label
            with urllib.request.urlopen(
                    f"{srv.url}/metrics/replica/0", timeout=30.0) as resp:
                text = resp.read().decode("utf-8")
            assert 'workload="lm"' in text
            ok_line = [ln for ln in text.splitlines()
                       if ln.startswith("lm_requests_total{")
                       and 'status="ok"' in ln]
            assert ok_line and 'workload="lm"' in ok_line[0]
            assert request_json(f"{srv.url}/v1/fleet")["workloads"] == ["lm"]
    finally:
        router.stop()


# --------------------------------------------------------------------------
# the CLI: --mode lm, inline and --listen
# --------------------------------------------------------------------------
_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _lm_cli(argv):
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"), OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
                             "--device", "cpu", *argv], cwd=_ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_cli_mode_lm_serves_the_reduced_config_on_the_cpu():
    proc = _lm_cli(["--n", "5", "--tokens", "6", "--window", "48", "--batch", "2",
                    "--quant-kv", "--drift-tol", "0.25"])
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    lines = out.splitlines()
    assert lines[0].startswith("request,prompt_len,new_tokens,status")
    rows = [ln.split(",") for ln in lines[1:6]]
    assert [r[3] for r in rows] == ["ok"] * 5 and {r[2] for r in rows} == {"6"}
    summary = next(ln for ln in lines if ln.startswith("# workload=lm"))
    assert "scheme=lightnobel_aaq" in summary and "served=5/5" in summary
    assert "compiles=1" in summary and "kernels=auto:ref" in summary
    assert lines[-1].startswith("# kv_drift") and lines[-1].endswith("OK")
    drift = float(lines[-1].split("=")[1].split()[0])
    assert 0.0 < drift <= 0.25                     # the KV ring was quantized


def test_cli_mode_lm_listen_answers_generate():
    proc = _lm_cli(["--listen", "127.0.0.1:0", "--replicas", "2", "--tokens", "3",
                    "--window", "32", "--batch", "2", "--quant-kv", "--serve-for-s", "240"])
    try:
        banner = ""
        for line in proc.stdout:
            if line.startswith("# listening "):
                banner = line
                break
        url = banner.split()[2]
        assert "workload=lm" in banner and "replicas=2" in banner
        rid = request_json(f"{url}/v1/generate", method="POST",
                           body={"prompt": [1, 2, 3, 4], "max_new_tokens": 3})["id"]
        kinds = [k for k, _ in _sse(f"{url}/v1/generate/{rid}/events")]
        assert kinds.count(ev.TOKEN) == 3 and kinds[-1] == ev.COMPLETED
        st = request_json(f"{url}/v1/generate/{rid}")
        assert st["workload"] == "lm" and len(st["result"]["tokens"]) == 3
        assert request_json(f"{url}/v1/fleet")["workloads"] == ["lm", "lm"]
        proc.terminate()                              # SIGTERM: the graceful drain
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    lines = out.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("# replica=")] == \
        ["replica=0", "replica=1"]
    assert lines[-1] == "# fleet shutdown complete"


_ZOO = ("phi-3-vision-4.2b", "deepseek-v2-lite-16b", "mixtral-8x22b", "recurrentgemma-9b",
        "mamba2-780m", "whisper-base")


@pytest.mark.parametrize("arch", _ZOO)
def test_cli_mode_lm_refuses_a_non_dense_arch_before_making_weights(arch, capsys,
                                                                   monkeypatch):
    """The reference's message and exit code 2; no parameters are made."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    def no_weights(*a, **k):
        raise AssertionError("weights were made for a refused arch")
    monkeypatch.setattr(lm, "init_params", no_weights)
    assert serve.main(["--mode", "lm", "--device", "cpu", "--arch", arch]) == 2
    kind = get_config(arch).kind
    assert capsys.readouterr().out.strip() == (
        f"error: --mode lm serves dense decoder archs through the substrate; "
        f"{arch!r} is kind={kind!r}")


def test_cli_mode_lm_refusal_exits_2():
    proc = _lm_cli(["--arch", "mixtral-8x22b"])
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 2, out
    assert out.strip().endswith("'mixtral-8x22b' is kind='moe'")
