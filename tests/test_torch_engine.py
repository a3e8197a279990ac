"""The port's batching engine (``repro_torch/serving``: admission, the
long-fold planner, the scheduler, the engine core and ``FoldClient``) on
the CPU, against the JAX reference and against the port's sequential
server.

Gates:
  * admission verdicts and byte estimates, chunk choices, scheduled
    batches, launch sizes and the per-request event sequence: equal to the
    reference's exactly (framework-free arithmetic);
  * the port's engine vs the port's sequential server on the same requests:
    bitwise coords on the CPU (batches of 1-3, ring depth 1 and 2; masking
    never rescales a real token, and one torch thread keeps every matmul's
    summation order independent of the batch);
  * one ``FoldClient`` run of the port vs the JAX ``FoldClient`` on the same
    bridged parameters: ``baseline_fp16`` allclose 1e-4, ``lightnobel_aaq``
    TM >= 0.995;
  * a steady-state second pass registers no new executable key;
  * the mesh flags: one without the other exits 2 as the reference's CLI
    does, ``--listen`` with ``--mesh`` raises (not ported), and ``--mesh 1x2
    --shard-threshold 64`` serves on two CPU ranks with rows labelled
    ``mesh:1x2`` (the sharded fold itself is
    ``tests/test_torch_sharded_fold.py``'s); the HTTP front-end and the
    fleet are ``tests/test_torch_transport.py``'s.
"""
import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_ppm_config as jax_full_cfg  # noqa: E402
from repro.configs import reduce_ppm_config as jax_reduce_cfg  # noqa: E402
from repro.core import make_scheme as jax_make_scheme  # noqa: E402
from repro.models.ppm import init_ppm as jax_init_ppm  # noqa: E402
from repro.serving.admission import AdmissionController as JaxAdmission  # noqa: E402
from repro.serving.client import FoldClient as JaxFoldClient  # noqa: E402
from repro.serving.engine import EngineCore as JaxEngineCore  # noqa: E402
from repro.serving.longfold import ChunkPolicy as JaxChunkPolicy  # noqa: E402
from repro.serving.longfold import DEFAULT_LONGFOLD_BUDGET_MB as JAX_BUDGET_MB  # noqa: E402
from repro.serving.placement import SINGLE_PLACEMENT as JAX_SINGLE  # noqa: E402
from repro.serving.scheduler import TokenBudgetScheduler as JaxScheduler  # noqa: E402
from repro.serving.types import FoldRequest as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_ppm_config, reduce_ppm_config  # noqa: E402
from repro_torch.core import make_scheme  # noqa: E402
from repro_torch.data.pipeline import ProteinSampler  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.ppm import init_ppm, tm_score  # noqa: E402
from repro_torch.serving import (DEFAULT_LONGFOLD_BUDGET_MB, AdmissionController,  # noqa: E402
                                 ChunkPolicy, CompileWatcher, EngineCore, FoldClient,
                                 FoldEngine, FoldRequest, TokenBudgetScheduler,
                                 check_request_order)
from repro_torch.serving.placement import SINGLE_PLACEMENT  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes at once, and
    a matmul's summation order then does not depend on its row count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class ManualClock:
    """Deterministic monotonic clock for scripting deadlines and linger."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


BUCKETS = (32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def _controllers(full: bool, scheme: str, budget_mb, spec):
    cfgs = (get_ppm_config(), jax_full_cfg()) if full else (reduce_ppm_config(),
                                                            jax_reduce_cfg())
    budget = None if budget_mb is None else int(budget_mb * 1e6)
    mine = AdmissionController(cfgs[0], make_scheme(scheme), budget)
    ref = JaxAdmission(cfgs[1], jax_make_scheme(scheme), budget)
    pol, jpol = ChunkPolicy(spec, admission=mine), JaxChunkPolicy(spec, admission=ref)
    mine.chunk_for, ref.chunk_for = pol.chunk_for, jpol.chunk_for
    return mine, ref, pol, jpol


# --------------------------------------------------------------------------
# admission and the chunk planner, exactly the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("full", [True, False], ids=["esmfold_ppm", "reduced"])
@pytest.mark.parametrize("scheme", ["lightnobel_aaq", "baseline_fp16"])
@pytest.mark.parametrize("budget_mb,spec", [
    (None, "off"), (DEFAULT_LONGFOLD_BUDGET_MB, "off"),
    (DEFAULT_LONGFOLD_BUDGET_MB, "auto"), (512.0, "auto"), (2048.0, "64")])
def test_admission_verdicts_and_bytes_match_reference(full, scheme, budget_mb, spec):
    assert DEFAULT_LONGFOLD_BUDGET_MB == JAX_BUDGET_MB
    mine, ref, pol, jpol = _controllers(full, scheme, budget_mb, spec)
    for ns in BUCKETS:
        assert pol.chunk_for(ns) == jpol.chunk_for(ns), ns
        assert pol.label_for(ns) == jpol.label_for(ns)
        for b in range(1, 9):
            got = dataclasses.asdict(mine.admit(ns, b))
            want = dataclasses.asdict(ref.admit(ns, b))
            assert got == want, (ns, b, got, want)
            for chunk in (None, 16, 64):      # explicit pricing, both models
                assert mine.estimate_bytes(ns, b, chunk=chunk) == \
                    ref.estimate_bytes(ns, b, chunk=chunk), (ns, b, chunk)
        assert mine.max_batch_for(ns, 8) == ref.max_batch_for(ns, 8)
        e, je = mine.explain(ns, 2), ref.explain(ns, 2)
        e.pop("predicted_run_ms"), je.pop("predicted_run_ms")
        assert e == je, ns
    assert pol.describe() == jpol.describe()


def test_auto_chunk_choices_match_reference():
    """ChunkPolicy("auto") at the default budget on the full config: the
    buckets whose unchunked estimate does not fit are chunked, at the
    reference's chunk, and bucket 2,048 is one of them."""
    for scheme in ("lightnobel_aaq", "baseline_fp16"):
        _, _, pol, jpol = _controllers(True, scheme, DEFAULT_LONGFOLD_BUDGET_MB, "auto")
        plan = {ns: pol.chunk_for(ns) for ns in BUCKETS}
        assert plan == {ns: jpol.chunk_for(ns) for ns in BUCKETS}
        assert plan[256] is None and plan[2048] is not None, plan


# --------------------------------------------------------------------------
# the scheduler, on a scripted stream under a manual clock
# --------------------------------------------------------------------------
def _scripted(sched_cls, req_cls, adm, clock):
    sched = sched_cls((32, 64, 128), max_tokens_per_batch=512, max_batch=4,
                      admission=adm, linger_ms=40.0)
    sampler = ProteinSampler(seed=5, min_len=20, max_len=128)
    log = []

    def submit(i, prio=0, deadline=None):
        req = req_cls(i, sampler.sample(i), priority=prio, deadline_s=deadline)
        rej = sched.submit(req, clock())
        log.append(("submit", i, None if rej is None else (rej.reason, rej.verdict)))

    def turn(allow_linger=True):
        b = sched.next_batch(clock(), allow_linger=allow_linger)
        log.append(("batch", None if b is None else (
            b.bucket, tuple(r.request_id for r in b.requests), b.est_bytes, b.deferred,
            b.placement, b.chunk_size), sched.hold_until, sched.linger_holds,
            sched.pending))

    for i in range(6):
        submit(i, prio=i % 3 == 2, deadline=0.03 if i == 5 else None)
        clock.advance(0.004)
    submit(6, deadline=5.0)
    submit(99)
    turn()
    clock.advance(0.01)
    turn()
    log.append(("cancel", sched.cancel(3), sched.cancel(3)))
    clock.advance(0.06)
    log.append(("expired", [r.request_id for r in sched.purge_expired(clock())]))
    for i in range(7, 12):
        submit(i, prio=1 if i == 9 else 0)
        clock.advance(0.002)
    for _ in range(3):
        turn()
        clock.advance(0.015)
    clock.advance(0.1)
    while sched.pending:
        turn(allow_linger=False)
    log.append(("tallies", sched.linger_holds, sched.linger_bad_holds,
                dict(sched.linger_decisions)))
    return log


def test_scheduler_batches_match_reference():
    cfg, jcfg = reduce_ppm_config(), jax_reduce_cfg()
    mine = _scripted(TokenBudgetScheduler, FoldRequest,
                     AdmissionController(cfg, make_scheme("lightnobel_aaq"), 120_000_000),
                     ManualClock())
    ref = _scripted(JaxScheduler, JaxRequest,
                    JaxAdmission(jcfg, jax_make_scheme("lightnobel_aaq"), 120_000_000),
                    ManualClock())
    assert mine == ref
    kinds = {entry[0] for entry in mine}
    assert {"submit", "batch", "cancel", "expired", "tallies"} <= kinds
    batches = [e[1] for e in mine if e[0] == "batch" and e[1] is not None]
    assert any(len(b[1]) >= 2 for b in batches)           # real batching happened
    assert any(b[3] for b in batches)                     # admission deferred some
    assert any(e[0] == "batch" and e[2] is not None for e in mine)   # a linger hold
    assert any(e[0] == "expired" and e[1] for e in mine)  # a deadline passed in queue


# --------------------------------------------------------------------------
# launch sizes, with a hand-made cost table
# --------------------------------------------------------------------------
@pytest.mark.parametrize("calibrated", [False, True])
def test_launch_sizes_match_reference(calibrated):
    cfg, jcfg = reduce_ppm_config(), jax_reduce_cfg()
    mine = EngineCore({}, cfg, "lightnobel_aaq", buckets=(32, 64), max_batch=8,
                      max_tokens_per_batch=512, device="cpu")
    ref = JaxEngineCore(None, jcfg, "lightnobel_aaq", buckets=(32, 64), max_batch=8,
                        max_tokens_per_batch=512)
    for core in (mine, ref):
        for b in (3, 6, 8):
            key = (32, b, "lightnobel_aaq", "single", 0)
            core._executables[key] = object()
            core.cost_model.record_compile(key, 900.0)
            if calibrated:
                core.cost_model.record_calibration(key, 40.0 + 55.0 * b, samples=3)
        core._executables[(64, 4, "lightnobel_aaq", "single", 0)] = object()
    for bucket in (32, 64):
        for n in range(1, 10):
            assert mine.launch_size_for(bucket, n, mine.scheme, SINGLE_PLACEMENT) == \
                ref.launch_size_for(bucket, n, ref.scheme, JAX_SINGLE), (bucket, n)
        assert mine.batch_for_bucket(bucket) == ref.batch_for_bucket(bucket)


# --------------------------------------------------------------------------
# FoldClient: the port against the JAX client, and against the sequential
# server
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _bridged():
    cfg, jcfg = reduce_ppm_config(), jax_reduce_cfg()
    jparams = jax_init_ppm(jax.random.PRNGKey(0), jcfg)
    return jparams, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg,
                                      device="cpu")


def _events_by_request(events):
    out = {}
    for e in events:
        out.setdefault(e.request_id, []).append(e)
    return out


_FRAMEWORK_FREE = ("bucket", "batch_size", "est_mb", "placement", "chunk_size", "batch",
                   "length", "priority", "deadline_s", "status", "verdict", "reason")


@pytest.mark.parametrize("scheme", ["baseline_fp16", "lightnobel_aaq"])
def test_fold_client_matches_jax_client(scheme):
    """Three requests of 56-64 residues in bucket 64, one batch of three:
    the same events per request (kinds and framework-free telemetry, legal
    order), and the same folds (FP allclose 1e-4, AAQ TM >= 0.995)."""
    jparams, params = _bridged()
    sampler = ProteinSampler(seed=3)
    seqs = [sampler.sample(i, length=n) for i, n in enumerate((64, 58, 56))]
    runs = []
    for client in (FoldClient(params, reduce_ppm_config(), scheme, buckets=(64,),
                              max_batch=3, device="cpu"),
                   JaxFoldClient(jparams, jax_reduce_cfg(), scheme, buckets=(64,),
                                 max_batch=3)):
        events = []
        client.subscribe(events.append)
        handles = [client.submit(s, priority=i % 2) for i, s in enumerate(seqs)]
        client.drive()
        runs.append(([h.result() for h in handles], _events_by_request(events)))
    (mine, my_ev), (ref, ref_ev) = runs
    assert sorted(my_ev) == sorted(ref_ev) == [0, 1, 2]
    for rid in my_ev:
        check_request_order(my_ev[rid])
        assert [e.kind for e in my_ev[rid]] == [e.kind for e in ref_ev[rid]]
        for e, je in zip(my_ev[rid], ref_ev[rid]):
            for k in _FRAMEWORK_FREE:
                assert e.data.get(k) == je.data.get(k), (rid, e, je, k)
    for r, jr in zip(mine, ref):
        assert (r.status, r.bucket, r.batch_size, r.launched_batch, r.chunk_size) == \
            (jr.status, jr.bucket, jr.batch_size, jr.launched_batch, jr.chunk_size)
        assert r.est_activation_bytes == jr.est_activation_bytes
        if scheme == "baseline_fp16":
            np.testing.assert_allclose(r.coords, np.asarray(jr.coords), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(r.distogram[...], np.asarray(jr.distogram),
                                       rtol=1e-4, atol=1e-4)
        else:
            tm = float(tm_score(torch.from_numpy(r.coords),
                                torch.from_numpy(np.array(jr.coords))))
            assert tm >= 0.995, (r.request_id, tm)


@functools.lru_cache(maxsize=None)
def _sequential(seqs_key):
    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device="cpu")
    seqs = [np.array(s, np.int32) for s in seqs_key]
    return params, serve.serve_ppm_sequential(cfg, params, seqs, (32, 48, 64),
                                              fidelity=True, device="cpu",
                                              emit=lambda *_: None)


def _trace(n=7):
    sampler = ProteinSampler(seed=11, min_len=24, max_len=64)
    return tuple(tuple(sampler.sample(i).tolist()) for i in range(n))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("max_batch", [1, 3])
def test_engine_matches_sequential_bitwise(depth, max_batch):
    seqs_key = _trace()
    params, seq_results = _sequential(seqs_key)
    client = FoldClient(params, reduce_ppm_config(), "lightnobel_aaq", buckets=(32, 48, 64),
                        max_batch=max_batch, inflight_depth=depth, fidelity=True,
                        device="cpu")
    handles = [client.submit(np.array(s, np.int32)) for s in seqs_key]
    client.drive()
    sizes = set()
    for h, ref in zip(handles, seq_results):
        r = h.result()
        assert r.ok and r.bucket == ref.bucket
        np.testing.assert_array_equal(r.coords, ref.coords.numpy())
        assert r.tm_vs_fp == pytest.approx(ref.tm_vs_fp, abs=1e-6)
        assert r.distogram.shape == (r.length, r.length, 64)
        sizes.add(r.batch_size)
    assert max(sizes) == max_batch
    assert client.metrics.summary()["pipeline"]["max_inflight"] == depth


def test_steady_state_second_pass_adds_no_key():
    params, _ = _sequential(_trace())
    client = FoldClient(params, reduce_ppm_config(), "lightnobel_aaq", buckets=(32, 48, 64),
                        max_batch=3, fidelity=True, device="cpu")
    seqs = [np.array(s, np.int32) for s in _trace()]
    first = client.run(seqs)
    keys = client.core.compile_count
    assert keys == len(client.core._executables) >= 2
    watch = CompileWatcher()
    second = client.run(seqs)
    assert client.core.compile_count == keys and watch.delta() == 0
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.coords, b.coords)
    assert [r.compile_ms for r in second] == [0.0] * len(second)
    legacy = FoldEngine(params, reduce_ppm_config(), "lightnobel_aaq", buckets=(32, 48, 64),
                        max_batch=3, device="cpu")
    for a, b in zip(first, legacy.run(seqs)):
        np.testing.assert_array_equal(a.coords, b.coords)


# --------------------------------------------------------------------------
# the mesh flags (--listen with --mesh starts); the card is the default
# --------------------------------------------------------------------------
def test_unported_serving_surfaces_raise():
    cfg = reduce_ppm_config()
    with pytest.raises(ValueError, match="together"):
        FoldClient({}, cfg, buckets=(32,), shard_threshold=32, device="cpu")
    for argv in (["--mesh", "1x2"], ["--shard-threshold", "64"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(["--mode", "ppm", "--device", "cpu", *argv])
        assert rc == 2 and "must be given together" in out.getvalue()
    # item 11.2 ported --listen with --mesh: the fleet starts on one mesh
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--mode", "ppm", "--device", "cpu", "--listen", "127.0.0.1:0",
                         "--mesh", "1x2", "--shard-threshold", "64", "--serve-for-s", "0.1"])
    assert rc == 0 and "mesh:1x2" in out.getvalue().split("# listening ")[1].splitlines()[0]
    assert "# fleet shutdown complete" in out.getvalue()
    with pytest.raises(ValueError, match="params live on"):
        EngineCore(init_ppm(cfg, seed=0, device="cpu"), cfg, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            EngineCore({}, cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FoldClient({}, cfg)


def test_mesh_cli_serves_on_cpu():
    """``--mesh 1x2 --shard-threshold 64`` starts its second rank itself and
    serves bucket 64 on the mesh, bucket 32 on rank 0 alone."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--mode", "ppm", "--device", "cpu", "--n", "4", "--buckets",
                         "32,64", "--min-len", "24", "--max-len", "64", "--max-batch", "2",
                         "--no-fidelity", "--mesh", "1x2", "--shard-threshold", "64"])
    assert rc == 0
    rows = [line.split(",") for line in out.getvalue().splitlines()[1:]
            if line and not line.startswith("#")]
    assert len(rows) == 4 and all(r[4] == "ok" for r in rows)
    labels = {int(r[2]): r[-2] for r in rows}
    assert labels.get(64) == "mesh:1x2" and labels.get(32, "single") == "single"


def test_engine_cli_serves_on_cpu(tmp_path):
    import json
    from repro_torch.serving import pipeline_overlaps, validate_chrome_trace
    trace = tmp_path / "trace.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--mode", "ppm", "--device", "cpu", "--n", "4", "--buckets",
                         "32,48,64", "--max-batch", "3", "--driver", "thread",
                         "--inflight-depth", "2", "--trace-out", str(trace)])
    lines = out.getvalue().splitlines()
    exported = json.loads(trace.read_text())
    validate_chrome_trace(exported)
    assert pipeline_overlaps(exported) >= 1          # the ring overlapped batches
    assert rc == 0
    from repro_torch.serving import CSV_HEADER
    i = lines.index(CSV_HEADER)
    rows = [ln.split(",") for ln in lines[i + 1:] if not ln.startswith("#")]
    assert len(rows) == 4 and all(r[4] == "ok" for r in rows)
    assert all(r[13] == "auto:ref" and r[14] == "single" for r in rows)
    assert any(ln.startswith("# engine device=cpu captures=") for ln in lines)


def test_cost_table_round_trip_on_cpu(tmp_path):
    """--calibrate replays every cached key and writes the table with the
    port's provenance; a restart pointed at it captures those keys first
    and then serves with no new key."""
    import json
    table = str(tmp_path / "ct.json")
    argv = ["--mode", "ppm", "--device", "cpu", "--n", "3", "--buckets", "32,64",
            "--max-batch", "2", "--no-fidelity", "--cost-table", table]
    for extra in (["--calibrate"], []):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert serve.main(argv + extra) == 0
        text = out.getvalue()
        if extra:
            assert "# cost table -> " in text
            saved = json.loads(open(table).read())
            prov = saved["provenance"]
            assert prov["backend"] == "cpu" and prov["torch_version"] == torch.__version__
            assert {"git_sha", "cuda_version", "device_kind"} <= set(prov)
            assert saved["floors"] == {} and saved["entries"]
            assert all(e["calibrated_ms"] > 0 for e in saved["entries"].values())
        else:
            assert "# cost table loaded" in text and "post_warmup_compiles=0" in text


def test_client_lifecycle_cancel_expiry_and_streams():
    """Cancellation before admission, expiry in the queue under a manual
    clock, and a served request: terminal states, legal event order on both
    the pull stream and the push callbacks, and the metrics surfaces."""
    from repro_torch.serving import CANCELLED, DONE, EXPIRED
    params, _ = _sequential(_trace())
    clock = ManualClock()
    client = FoldClient(params, reduce_ppm_config(), "lightnobel_aaq", buckets=(32, 64),
                        max_batch=2, clock=clock, device="cpu")
    stream = client.stream()
    pushed = []
    client.subscribe(pushed.append)
    seqs = [np.array(s, np.int32) for s in _trace(3)]
    served = client.submit(seqs[0])
    doomed = client.submit(seqs[1], deadline_s=0.5)
    dropped = client.submit(seqs[2], priority=1)
    assert dropped.cancel() and not dropped.cancel()
    clock.advance(1.0)
    client.drive()
    assert (served.status, doomed.status, dropped.status) == (DONE, EXPIRED, CANCELLED)
    assert served.result().ok and doomed.result().status == "expired"
    assert [s for s, _ in dropped.transitions] == ["QUEUED", "CANCELLED"]
    pulled = stream.events()
    assert [e.seq for e in pulled] == [e.seq for e in pushed]
    by = _events_by_request(pulled)
    for evs in by.values():
        check_request_order(evs)
    assert [e.kind for e in by[served.request_id]][-1] == "completed"
    assert [e.kind for e in by[doomed.request_id]] == ["submitted", "expired"]
    assert 'fold_requests_total{status="ok"' in client.metrics_text()
    assert client.metrics_json() and client.metrics.summary()["served"] == 1
    client.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        client.submit(seqs[0])
