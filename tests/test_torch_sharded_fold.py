"""The port's mesh-sharded fold tier on the CPU: ``FoldClient(mesh=...,
shard_threshold=64)`` on gloo ranks that the mesh starts itself, at the
reduced config, proteins of 56 and 60 residues in bucket 64, on meshes 1x2
and 2x2 (the port of ``tests/test_placement.py``'s end-to-end gate).

Gates:
  * a per-device budget that rejects bucket 64 on one device admits and
    serves it on the mesh; a repeat of the bucket makes no new executable;
    the label ``mesh:DxM`` rides the ``FoldResult``, the SCHEDULED events
    and the CSV rows;
  * sharded against the port's single placement: ``baseline_fp16``
    allclose 1e-4, ``lightnobel_aaq`` TM >= 0.995 (the reference's gates;
    on the CPU the two read bitwise equal: a gather concatenates and
    changes no sum), unchunked and at chunk 16;
  * every rank routes the single fold's kernel calls (each op once a
    rank, at the shard's shapes), pins a 1/M pair shard and hands the
    collectives the calls the block implies;
  * each of the five comparison schemes sharded against single, allclose
    1e-4: their tensor- and channel-wide statistics are maxima over the
    model group (``global_amax``), so a shard quantizes as the whole does;
  * the port's sharded fold against the reference's sharded fold on the
    same parameters (``bridge``), the reference run in a subprocess with as
    many forced host devices as the mesh has ranks: FP allclose 1e-4, AAQ
    TM >= 0.995.
"""
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import reduce_ppm_config as jax_reduce_cfg  # noqa: E402
from repro.models.ppm import init_ppm as jax_init_ppm  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import reduce_ppm_config  # noqa: E402
from repro_torch.core import make_scheme  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models.ppm import tm_score  # noqa: E402
from repro_torch.serving import AdmissionController, FoldClient  # noqa: E402
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.placement import make_serving_mesh  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ("1x2", "2x2")
LENGTHS = (56, 60)
COMPARISON = ("smoothquant", "llm_int8", "ptq4protein", "tender", "mefold")
CFG = reduce_ppm_config()
KW = dict(buckets=(64,), max_tokens_per_batch=128, max_batch=2, device="cpu")


def _seqs():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 20, n).astype(np.int32) for n in LENGTHS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread here and in every rank the mesh starts (it passes
    the count on): the suite runs several test processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
import numpy as np, jax
from repro.configs import reduce_ppm_config
from repro.models.ppm import init_ppm
from repro.serving import FoldClient, make_serving_mesh
cfg = reduce_ppm_config()
params = init_ppm(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(7)
seqs = [rng.integers(0, 20, n).astype(np.int32) for n in {lengths}]
mesh = make_serving_mesh("{spec}")
out = {{}}
for scheme in ("baseline_fp16", "lightnobel_aaq"):
    c = FoldClient(params, cfg, scheme, buckets=(64,), max_tokens_per_batch=128,
                   max_batch=2, mesh=mesh, shard_threshold=64)
    rs = [h.result() for h in [c.submit(s) for s in seqs]]
    assert all(r.ok and r.placement == "mesh:{spec}" for r in rs), rs
    for i, r in enumerate(rs):
        out[f"{{scheme}}_{{i}}"] = r.coords
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's sharded folds, one subprocess a mesh, started at
    once so that they run beside the port's tests."""
    d = tmp_path_factory.mktemp("ref_sharded")
    procs = {}
    for spec in MESHES:
        n = int(np.prod([int(t) for t in spec.split("x")]))
        code = textwrap.dedent(_REF.format(n=n, spec=spec, lengths=LENGTHS))
        procs[spec] = (subprocess.Popen(
            [sys.executable, "-c", code, str(d / f"{spec}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}), d / f"{spec}.npz")
    yield procs
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()


@pytest.fixture(scope="module")
def bridged():
    jparams = jax_init_ppm(jax.random.PRNGKey(0), jax_reduce_cfg())
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), CFG,
                             device="cpu")


@pytest.fixture(scope="module", params=MESHES)
def mesh(request, reference_runs):
    m = make_serving_mesh(request.param, device="cpu")
    yield m
    m.close()


def _serve(client, seqs=None):
    return [h.result() for h in [client.submit(s) for s in (seqs or _seqs())]]


def _single(params, scheme, chunk=None):
    return _serve(FoldClient(params, CFG, scheme, chunk_size=chunk, **KW))


def test_admission_flip_labels_and_steady_state(mesh, bridged):
    est = AdmissionController(CFG, make_scheme("lightnobel_aaq")).estimate_bytes(64, 1)
    budget_mb = (est - 1) / 1e6
    solo = FoldClient(bridged, CFG, "lightnobel_aaq", mem_budget_mb=budget_mb, **KW)
    h = solo.submit(_seqs()[0])
    assert h.status == "REJECTED" and "budget" in h.result().reason, h

    sharded = FoldClient(bridged, CFG, "lightnobel_aaq", mesh=mesh, shard_threshold=64,
                         mem_budget_mb=budget_mb, **KW)
    stream = sharded.stream()
    rs = _serve(sharded)
    assert all(r.ok for r in rs) and {r.placement for r in rs} == {mesh.label}
    sch = [e for e in stream.events() if e.kind == ev.SCHEDULED]
    assert sch and all(e.data["placement"] == mesh.label for e in sch), sch

    n0 = sharded.core.compile_count
    again = _serve(sharded)
    assert sharded.core.compile_count == n0, "sharded steady state made a new executable"
    for a, b in zip(rs, again):
        np.testing.assert_array_equal(a.coords, b.coords)

    buf = io.StringIO()
    sharded.metrics.write_csv(buf)
    rows = [line for line in buf.getvalue().splitlines()[1:] if line]
    assert len(rows) == 4 and all(r.endswith(f",{mesh.label},0") for r in rows), rows
    sharded.close()


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("scheme", ["baseline_fp16", "lightnobel_aaq"])
def test_sharded_matches_single(mesh, bridged, scheme, chunk):
    client = FoldClient(bridged, CFG, scheme, mesh=mesh, shard_threshold=64,
                        chunk_size=chunk, **KW)
    got = _serve(client)
    client.close()
    want = _single(bridged, scheme, chunk)
    for a, b in zip(got, want):
        assert a.placement == mesh.label and b.placement == "single"
        assert a.chunk_size == b.chunk_size == (chunk or 0)
        if scheme == "baseline_fp16":
            np.testing.assert_allclose(a.coords, b.coords, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(np.asarray(a.distogram), np.asarray(b.distogram),
                                       rtol=1e-4, atol=1e-4)
        else:
            tm = float(tm_score(torch.from_numpy(a.coords), torch.from_numpy(b.coords)))
            assert tm >= 0.995, tm


@pytest.mark.parametrize("scheme", ["baseline_fp16", "lightnobel_aaq"])
def test_each_rank_runs_the_single_folds_calls(mesh, bridged, scheme):
    """Every rank routes exactly the attention, quantized-linear and
    fake-quant calls of the single fold (each op runs once a rank, at the
    shard's shapes), pins a (1, 64, 64/M, Hz) pair shard, and hands the
    collectives the same calls and bytes as every other rank."""
    seq = _seqs()[:1]
    single = FoldClient(bridged, CFG, scheme, max_batch=1, buckets=(64,), device="cpu")
    dispatch.reset_counters()
    _serve(single, seq)
    want = dict(dispatch.counters)
    client = FoldClient(bridged, CFG, scheme, mesh=mesh, shard_threshold=64,
                        max_batch=1, buckets=(64,), device="cpu")
    mesh.rank_stats(reset=True)
    _serve(client, seq)
    stats = mesh.rank_stats()
    client.close()
    m = mesh.shape["model"]
    assert [st["rank"] for st in stats] == list(range(mesh.size))
    for st in stats:
        assert st["routes"] == want
        assert st["pair"] == (1, 64, 64 // m, CFG.hz)
        assert st["collectives"] == stats[0]["collectives"]
    calls = {k: v["calls"] for k, v in stats[0]["collectives"].items()}
    # per block: 5 gathers (seq bias, tri-mul's two a, both tri biases) and
    # 3 all-to-alls (outgoing b, the starting node there and back); the
    # structure bias, the distogram's transpose and its gather to rank 0
    assert calls == {"all_gather": 5 * CFG.blocks + 1, "all_to_all": 3 * CFG.blocks + 1,
                     "all_reduce": 0, "gather": 1, "broadcast": 0}


@pytest.mark.parametrize("scheme", COMPARISON)
def test_comparison_schemes_sharded_match_single(mesh, bridged, scheme):
    client = FoldClient(bridged, CFG, scheme, mesh=mesh, shard_threshold=64, **KW)
    got = _serve(client)
    client.close()
    for a, b in zip(got, _single(bridged, scheme)):
        np.testing.assert_allclose(a.coords, b.coords, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scheme", ["baseline_fp16", "lightnobel_aaq"])
def test_sharded_matches_reference_sharded(mesh, bridged, reference_runs, scheme):
    proc, path = reference_runs[mesh.label.split(":")[1]]
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    ref = np.load(path)
    client = FoldClient(bridged, CFG, scheme, mesh=mesh, shard_threshold=64, **KW)
    got = _serve(client)
    client.close()
    for i, a in enumerate(got):
        b = ref[f"{scheme}_{i}"]
        if scheme == "baseline_fp16":
            np.testing.assert_allclose(a.coords, b, rtol=1e-4, atol=1e-4)
        else:
            tm = float(tm_score(torch.from_numpy(a.coords), torch.from_numpy(b)))
            assert tm >= 0.995, tm
