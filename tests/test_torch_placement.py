"""The port's mesh placement (``repro_torch/serving/placement.py``) and the
serving half of its sharding specs (``repro_torch/parallel/sharding.py``)
against the JAX reference, in process (no rank is started here).

Gates, each the reference's answer computed live on the same inputs:
  * ``parse_mesh_spec`` on good and bad specs, ``make_serving_mesh`` with
    no spec and with one far beyond any host; on the card one rank a card
    (more raises "needs N devices"), the host-staged route only when asked
    for and with no memory budget;
  * ``PlacementPolicy``: placements, shard counts and labels by bucket,
    the undividable bucket kept single, and its configuration errors;
  * admission's per-device share ``ceil(total / shards)`` and the flip (a
    budget that rejects a bucket on one device admits it sharded);
  * the placement label in ``ScheduledBatch``, the CSV row and the JSON
    report;
  * ``ppm_input_shardings``, ``ppm_constraints``, ``ppm_serving_rules``,
    ``data_axes``, ``_axis_size`` and ``_maybe`` equal to the reference's
    ``PartitionSpec``s at meshes 1x2, 2x2, 1x4 and 2x4.
"""
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduce_ppm_config as jax_reduce_cfg  # noqa: E402
from repro.core import make_scheme as jax_make_scheme  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.serving import AdmissionController as JaxAdmission  # noqa: E402
from repro.serving import EngineMetrics as JaxMetrics  # noqa: E402
from repro.serving import FoldRequest as JaxRequest  # noqa: E402
from repro.serving import FoldResult as JaxResult  # noqa: E402
from repro.serving import PlacementPolicy as JaxPolicy  # noqa: E402
from repro.serving import TokenBudgetScheduler as JaxScheduler  # noqa: E402
from repro.serving import csv_row as jax_csv_row  # noqa: E402
from repro.serving import make_serving_mesh as jax_make_serving_mesh  # noqa: E402
from repro.serving import parse_mesh_spec as jax_parse_mesh_spec  # noqa: E402
from repro_torch.configs import reduce_ppm_config  # noqa: E402
from repro_torch.core import make_scheme  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.serving import (ADMIT, REJECT, AdmissionController,  # noqa: E402
                                 EngineMetrics, FoldRequest, FoldResult,
                                 PlacementPolicy, TokenBudgetScheduler, csv_row)
from repro_torch.serving.placement import (SINGLE_PLACEMENT, ServingMesh,  # noqa: E402
                                           make_serving_mesh, parse_mesh_spec)

MESHES = [(1, 2), (2, 2), (1, 4), (2, 4)]


class _FakeMesh:
    """Enough mesh surface for either package's PlacementPolicy and specs
    without devices (the reference's test stand-in)."""
    axis_names = ("data", "model")

    def __init__(self, data: int, model: int):
        self.shape = {"data": data, "model": model}
        self.devices = np.zeros((data, model))


def _seq(rng, length: int) -> np.ndarray:
    return rng.integers(0, 20, length).astype(np.int32)


def _outcome(fn, *args, **kw):
    """("ok", value) or ("raises", exception type) of ``fn``."""
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:       # noqa: BLE001 - the type is the outcome
        return "raises", type(e).__name__


# --------------------------------------------------------------------------
# mesh spec / policy
# --------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["2x4", "1X8", "1x1", "2", "2x", "axb", "0x4",
                                  "2x4x2", "x4", "3x0"])
def test_parse_mesh_spec(spec):
    assert _outcome(parse_mesh_spec, spec) == _outcome(jax_parse_mesh_spec, spec)


def test_make_serving_mesh_none_and_too_big():
    assert make_serving_mesh(None) is None and jax_make_serving_mesh(None) is None
    assert make_serving_mesh("") is None and jax_make_serving_mesh("") is None
    with pytest.raises(ValueError, match="needs 4096 devices"):
        make_serving_mesh("64x64", device="cpu")     # way beyond any host
    with pytest.raises(ValueError, match="xla_force_host_platform"):
        jax_make_serving_mesh("64x64")
    mesh = make_serving_mesh("1x2", device="cpu")   # described, nothing started
    assert isinstance(mesh, ServingMesh) and not mesh.bound
    assert mesh.shape == {"data": 1, "model": 2} and mesh.label == "mesh:1x2"


def test_rank_worker_defaults_to_the_card():
    """The rank worker's ``--device`` defaults to the card, as every entry
    point of the port does; its parent passes the mesh's device."""
    from repro_torch.launch import mesh as lmesh
    need = ["--rank", "1", "--data", "1", "--model", "2", "--init", "file:///x",
            "--route", "gloo"]
    assert lmesh.parser().parse_args(need).device == "cuda"
    assert lmesh.parser().parse_args([*need, "--device", "cpu"]).device == "cpu"


@pytest.fixture
def one_card(monkeypatch):
    """A host that shows one card (this module starts no rank and touches
    no card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


@pytest.mark.parametrize("device", ["cuda", None])
def test_card_mesh_counts_cards(one_card, device):
    """On the card a rank takes a card (NCCL refuses two on one): a mesh
    larger than the cards raises the reference's "needs N devices" error,
    from the spec and from a mesh built directly alike."""
    assert make_serving_mesh("1x1", device=device).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 2 devices but only 1 visible"):
        make_serving_mesh("1x2", device=device)
    with pytest.raises(ValueError, match="needs 4 devices but only 1 visible"):
        ServingMesh(2, 2)._route(torch.device("cuda"))
    assert ServingMesh(1, 1)._route(torch.device("cuda")) == "nccl"
    assert not ServingMesh(1, 1).colocated_on("cuda")


def test_host_staged_route_only_when_asked_and_without_budget(one_card):
    """``backend="gloo"`` puts every rank on one card over the host-staged
    route; an engine there refuses a memory budget, since its ranks share
    the card that admission prices as one rank's."""
    mesh = make_serving_mesh("1x4", device="cuda", backend="gloo")
    assert mesh._route(torch.device("cuda")) == "gloo-host-staged"
    assert mesh.colocated_on("cuda") and not mesh.colocated_on("cpu")
    assert not ServingMesh(1, 1, backend="gloo").colocated_on("cuda")
    with pytest.raises(ValueError, match="not 'mpi'"):
        ServingMesh(1, 2, backend="mpi")._route(torch.device("cuda"))
    from repro_torch.models.ppm import init_ppm
    from repro_torch.serving import EngineCore
    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device="cpu")
    mesh.colocated_on = lambda device: True      # as on the card, on this CPU
    with pytest.raises(ValueError, match="no memory budget"):
        EngineCore(params, cfg, "lightnobel_aaq", buckets=(64,), mesh=mesh,
                   shard_threshold=64, mem_budget_mb=8, device="cpu")
    assert not mesh.bound                        # refused before any rank started


def _decisions(policy, buckets=(16, 24, 32, 48, 64, 96, 128, 512)):
    return [(b, p.kind, p.label, p.model_shards, policy.shards_for(b),
             policy.label_for(b)) for b in buckets for p in [policy.placement_for(b)]]


@pytest.mark.parametrize("mesh,threshold", [((2, 4), 64), ((1, 3), 16), ((1, 2), 64),
                                            ((2, 2), 32), (None, None)])
def test_placement_policy_thresholds_and_labels(mesh, threshold):
    port = PlacementPolicy(mesh=None if mesh is None else ServingMesh(*mesh),
                           shard_threshold=threshold)
    ref = JaxPolicy(mesh=None if mesh is None else _FakeMesh(*mesh),
                    shard_threshold=threshold)
    assert _decisions(port) == _decisions(ref)
    assert port.describe() == ref.describe()
    # the port's policy reads the reference's stand-in mesh the same way
    if mesh is not None:
        fake = PlacementPolicy(mesh=_FakeMesh(*mesh), shard_threshold=threshold)
        assert _decisions(fake) == _decisions(ref)
        assert "," not in port.placement_for(512).label    # survives CSV rows
    assert port.placement_for(8) is SINGLE_PLACEMENT


def test_placement_policy_configuration_errors():
    class NoModel:
        axis_names = ("data",)
        shape = {"data": 2}
    for kw in (dict(mesh=NoModel(), shard_threshold=16),
               dict(mesh=_FakeMesh(2, 4)), dict(shard_threshold=64)):
        got, want = _outcome(PlacementPolicy, **kw), _outcome(JaxPolicy, **kw)
        assert got == want and got[0] == "raises"
    with pytest.raises(ValueError, match="together"):
        PlacementPolicy(mesh=ServingMesh(2, 4))
    with pytest.raises(ValueError, match="model"):
        PlacementPolicy(mesh=NoModel(), shard_threshold=16)


# --------------------------------------------------------------------------
# per-device admission accounting
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["lightnobel_aaq", "baseline_fp16"])
@pytest.mark.parametrize("shards", [2, 4])
def test_admission_per_device_share_and_flip(scheme, shards):
    cfg, jcfg = reduce_ppm_config(), jax_reduce_cfg()
    sc, jsc = make_scheme(scheme), jax_make_scheme(scheme)
    total = AdmissionController(cfg, sc).estimate_bytes(64, 1)
    assert total == JaxAdmission(jcfg, jsc).estimate_bytes(64, 1)

    def route(ns):
        return shards if ns >= 64 else 1

    port = dict(sharded=AdmissionController(cfg, sc, mem_budget_bytes=total - 1,
                                            shards_for=route),
                solo=AdmissionController(cfg, sc, mem_budget_bytes=total - 1))
    ref = dict(sharded=JaxAdmission(jcfg, jsc, mem_budget_bytes=total - 1,
                                    shards_for=route),
               solo=JaxAdmission(jcfg, jsc, mem_budget_bytes=total - 1))
    for name in port:
        for ns in (32, 64, 128):
            for b in (1, 2):
                d, jd = port[name].admit(ns, b), ref[name].admit(ns, b)
                assert (d.verdict, d.est_bytes, d.shards, d.reason) == \
                       (jd.verdict, jd.est_bytes, jd.shards, jd.reason)
            assert port[name].max_batch_for(ns, 8) == ref[name].max_batch_for(ns, 8)
            assert port[name].explain(ns, 1) == pytest.approx(ref[name].explain(ns, 1))
    # the flip: bucket 64 busts the budget alone, fits per device sharded
    assert port["solo"].admit(64, 1).verdict == REJECT
    d = port["sharded"].admit(64, 1)
    assert d.verdict == ADMIT and d.shards == shards and d.est_bytes == -(-total // shards)
    assert AdmissionController(cfg, sc).estimate_bytes(64, 1, shards=shards) == -(-total // shards)


# --------------------------------------------------------------------------
# scheduler / report threading
# --------------------------------------------------------------------------
def test_scheduled_batch_carries_placement_label():
    rng = np.random.default_rng(23)
    seqs = [_seq(rng, 20), _seq(rng, 50), _seq(rng, 60)]

    def batches(sched_cls, req_cls, policy):
        sched = sched_cls((32, 64), max_tokens_per_batch=128, placement=policy)
        for i, s in enumerate(seqs):
            sched.submit(req_cls(i, s), now=float(i))
        out = []
        while sched.pending:
            b = sched.next_batch()
            out.append((b.bucket, b.placement, [r.request_id for r in b.requests]))
        return out

    got = batches(TokenBudgetScheduler, FoldRequest,
                  PlacementPolicy(mesh=ServingMesh(2, 4), shard_threshold=64))
    want = batches(JaxScheduler, JaxRequest,
                   JaxPolicy(mesh=_FakeMesh(2, 4), shard_threshold=64))
    assert got == want
    assert {b: p for b, p, _ in got} == {32: "single", 64: "mesh:2x4"}
    assert batches(TokenBudgetScheduler, FoldRequest, None) == \
        batches(JaxScheduler, JaxRequest, None)


def test_placement_in_csv_and_json_reports():
    kw = dict(request_id=0, length=50, bucket=64, batch_size=1,
              coords=np.zeros((50, 3), np.float32), kernel_backend="auto:ref",
              placement="mesh:2x4")
    r, jr = FoldResult(**kw), JaxResult(**kw)
    assert csv_row(r) == jax_csv_row(jr) and csv_row(r).endswith(",auto:ref,mesh:2x4,0")
    bufs = []
    for m, res in ((EngineMetrics(), r), (JaxMetrics(), jr)):
        m.record(res)
        buf = io.StringIO()
        m.write_csv(buf)
        bufs.append(buf.getvalue())
        buf = io.StringIO()
        m.write_json(buf)
        assert '"placement": "mesh:2x4"' in buf.getvalue()
    assert bufs[0].splitlines()[0] == bufs[1].splitlines()[0]
    header, row = bufs[0].strip().splitlines()
    assert header.endswith(",kernel_backend,placement,chunk_size")
    assert row.split(",")[-2] == "mesh:2x4"


# --------------------------------------------------------------------------
# the specs: framework-free arithmetic, equal to the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d,m", MESHES)
def test_ppm_specs_equal_reference(d, m):
    port_mesh, ref_mesh = ServingMesh(d, m), _FakeMesh(d, m)
    assert tuple(sh.ppm_input_shardings(port_mesh)["aatype"]) == \
        tuple(jsh.ppm_input_shardings(ref_mesh)["aatype"])
    for name, spec in jsh.ppm_constraints(ref_mesh).items():
        assert tuple(sh.ppm_constraints(port_mesh)[name]) == tuple(spec)
    got, want = sh.ppm_serving_rules(port_mesh), jsh.ppm_serving_rules(ref_mesh)
    assert set(got) == set(want) and tuple(got["pair"]) == tuple(want["pair"])
    assert sh.data_axes(port_mesh) == jsh.data_axes(ref_mesh)
    for axis in (None, "data", "model", ("data", "model")):
        assert sh._axis_size(port_mesh, axis) == jsh._axis_size(ref_mesh, axis)
        for dim in (0, 1, 2, 3, 6, 8, 64):
            assert sh._maybe(port_mesh, dim, axis) == jsh._maybe(ref_mesh, dim, axis)


def test_act_rules_scope_constrain_and_rule_value():
    rules = sh.ppm_serving_rules(ServingMesh(1, 2))
    x = torch.zeros(1, 8, 4, 3)
    assert sh.constrain(x, "pair") is x and sh.rule_value("pair") is None
    with sh.act_rules(rules):
        assert sh.rule_value("pair") == rules["pair"]
        assert sh.rule_value("other", 7) == 7
        assert sh.constrain(x, "pair") is x          # no shard scope: no pin
    shard = sh.PairShard(None, 2, 0)
    with sh.sharded(shard, 8):
        assert sh.current_shard() is shard
        assert sh.constrain(x, "pair") is x          # (1, 8, 8/2, 3): the shard
        with pytest.raises(ValueError, match="shard is 4 of 8"):
            sh.constrain(torch.zeros(1, 8, 8, 3), "pair")
    assert sh.current_shard() is None and sh.rule_value("pair") is None
    assert sh.P(None, ("data",), "model") == (None, "data", "model")
    assert shard.cols(8) == slice(0, 4) and sh.PairShard(None, 4, 3).cols(64) == slice(48, 64)
