"""The port's dry-run (``repro_torch/launch/dryrun.py``, the counting in
``launch/cost_analysis.py``) on the CPU, against the reference's
``launch/dryrun.py`` and ``launch/hlo_analysis.py``.

The reference's dry-run module forces 512 host devices when it is
imported, so its numbers come from one subprocess (``reference``).

Gates:
  * ``model_flops_estimate``, ``ppm_model_flops``, ``active_params`` and
    the copied ``block_macs`` equal the reference's exactly;
  * ``lm.param_specs``/``input_specs`` equal the reference's
    ``jax.eval_shape`` leaf for leaf (shape and dtype) for all ten configs
    at the reduced size, the port's layer lists stacked by the
    checkpoint's rule;
  * a reduced cell's FLOPs, bytes and collectives grow exactly linearly in
    ``layers`` on a fake 1 x 2 mesh (the counterpart of
    ``test_analyzer_counts_loop_trips_exactly``);
  * one device: the fake trace's FLOPs equal ``FlopCounterMode``'s count
    of the same step run for real (a train step, a fold); and the counted
    FLOPs of reduced qwen's train step within ``HLO_RTOL`` of the
    reference's ``analyze_hlo`` of its compiled step;
  * sharded: a device's counted FLOPs of that step on fake 1 x 2 and
    2 x 1 meshes within ``HLO_RTOL`` of the reference's ``analyze_hlo`` of
    the step compiled with its dry-run's shardings on 2 devices;
  * sharded steps hold no whole tensor a device (``CostMode.largest``, the
    largest storage an op made): a train step's largest is under the
    global (B, chunk, V) float32 logits over |model| (the cross-entropy is
    vocabulary-parallel), a decode step's under one layer's global ring
    over its shards (attention where the ring lies, sharded on its K/V
    heads or on its head dim); the MoE train and prefill steps trace at
    the smallest fake meshes and reduced shapes where DTensor's folds of
    a sharded batch into routing groups broke (a local shape half the one
    expected);
  * the fold cell on a fake 2 x 2 mesh (the production layout: rows over
    ``data``, columns over ``model``, the parameters cut by
    ``param_spec``) reads a lower peak, and makes a smaller largest
    storage, than the same fold traced on the serving tier's layout (j
    over ``model``, the parameters whole);
  * the bottleneck selection of the reference's test, with the H100's
    constants;
  * the CLI writes the reference's record keys (``fits_hbm_80g``,
    ``trace_s``, no ``xla_*``, the widened copies apart), records a skip,
    and exits 1 on a failure.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpointing import stack_layers  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, ShapeSpec, get_config,  # noqa: E402
                                 get_ppm_config, reduce_config, reduce_ppm_config)
from repro_torch.launch import cost_analysis as ca  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: reduced qwen's train step (8 x 32 tokens, float32, one device): the
#: port's counted FLOPs against the reference's ``analyze_hlo``.  Read on
#: the CPU: 169,869,312 counted, 165,675,008 from the HLO, 2.53% apart;
#: the gap is exactly one (256 x 64) @ (64 x 128) product, the logits'
#: size (the eager step runs a product that the compiled one does not)
HLO_RTOL = 0.03
#: the same step a device on 2 devices, read on the CPU: 1 x 2 84,934,656
#: counted and 84,934,656 from the HLO (equal); 2 x 1 84,934,656 against
#: 82,837,504, 2.53% apart (the one-device gap, halved with the batch)
MESHES = ((1, 2), (2, 1))
SMALL = {"train": ShapeSpec("t", 32, 8, "train"), "prefill": ShapeSpec("p", 32, 8, "prefill"),
         "decode": ShapeSpec("d", 32, 8, "decode")}

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.launch import dryrun as d          # forces its host devices first
from repro.launch import hlo_analysis as ha
from repro.configs import ARCH_NAMES, get_config, get_ppm_config, reduce_config
from repro.configs.base import ShapeSpec
from repro.launch.steps import make_train_step
from repro.models import lm
from repro.optim import adamw
from benchmarks.compute_cost import block_macs

out = {"ppm_flops": {}, "active": {}, "specs": {}}
ppm = get_ppm_config()
for ns in (256, 512, 1024, 2048):
    out["ppm_flops"][str(ns)] = d.ppm_model_flops(ppm, ns)
out["block_macs"] = block_macs(ppm, 300)
for name in ARCH_NAMES:
    cfg = get_config(name)
    n = d.count_params_from_sds(lm.param_specs(cfg))
    out["active"][name] = [n, d.active_params(cfg, n)]
    r = reduce_config(cfg)
    specs = {"params": lm.param_specs(r)}
    for step in ("train", "prefill", "decode"):
        specs[step] = lm.input_specs(r, ShapeSpec(step, 32, 8, step), quantized_kv=True)
    out["specs"][name] = {k: [[list(x.shape), str(x.dtype)] for x in jax.tree.leaves(v)]
                          for k, v in specs.items()}
out["mfe"] = [ha.model_flops_estimate(1e9, 1e6, "train"),
              ha.model_flops_estimate(1e9, 1e6, "decode", n_active=5e8),
              ha.model_flops_estimate(3.5e8, 4096, "prefill")]
cfg = reduce_config(get_config("qwen1.5-0.5b")).replace(dtype="float32")
params = lm.param_specs(cfg)
opt = jax.eval_shape(adamw.init, params)
batch = lm.input_specs(cfg, ShapeSpec("t", 32, 8, "train"))["batch"]
compiled = jax.jit(make_train_step(cfg)).lower(params, opt, batch).compile()
out["hlo_flops"] = ha.analyze_hlo(compiled.as_text()).flops
# the same step sharded as the reference's dry-run shards a cell, on 2 devices
from repro.launch.mesh import make_mesh
from repro.parallel import sharding as sh
out["hlo_flops_mesh"] = {}
for ms in ((1, 2), (2, 1)):
    mesh = make_mesh(ms, ("data", "model"))
    psh = sh.param_shardings(params, mesh, cfg)
    bsh = sh.to_shardings(mesh, sh.batch_specs(cfg, ShapeSpec("t", 32, 8, "train"), mesh))
    with mesh, sh.act_rules(sh.default_act_rules(mesh, "train", cfg)):
        compiled = jax.jit(make_train_step(cfg), donate_argnums=(0, 1),
                           in_shardings=(psh, sh.opt_state_shardings(psh, mesh), bsh["batch"])
                           ).lower(params, opt, batch).compile()
    out["hlo_flops_mesh"]["x".join(map(str, ms))] = ha.analyze_hlo(compiled.as_text()).flops
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_analytic_flops_equal_the_reference(reference):
    ppm = get_ppm_config()
    for ns, want in reference["ppm_flops"].items():
        assert dryrun.ppm_model_flops(ppm, int(ns)) == want
    assert [list(m) for m in dryrun.block_macs(ppm, 300)] == reference["block_macs"]
    for name, (n, active) in reference["active"].items():
        got = dryrun.count_params_from_sds(lm.param_specs(get_config(name)))
        assert got == n and dryrun.active_params(get_config(name), got) == active
    assert [ca.model_flops_estimate(1e9, 1e6, "train"),
            ca.model_flops_estimate(1e9, 1e6, "decode", n_active=5e8),
            ca.model_flops_estimate(3.5e8, 4096, "prefill")] == reference["mfe"]


def _shapes(tree, cfg):
    """Each leaf as [shape, dtype name], the layer lists stacked as the
    reference stacks them."""
    host = tree_map(lambda t: np.empty(tuple(t.shape), np.int8), tree)
    dtypes = tree_map(lambda t: str(t.dtype).removeprefix("torch."), tree)
    stacked = stack_layers(host, cfg)
    names = [d for d in leaves(_stacked_dtypes(dtypes, cfg))]
    return [[list(a.shape), n] for a, n in zip(leaves(stacked), names)]


def _stacked_dtypes(tree, cfg):
    from repro_torch.checkpoint import checkpointing as ckpt
    return ckpt._stacked(tree, ckpt.stacked_entries(cfg), lambda layers: layers[0])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_and_input_specs_equal_the_reference(reference, name):
    cfg = reduce_config(get_config(name))
    want = reference["specs"][name]
    assert _shapes(lm.param_specs(cfg), cfg) == want["params"]
    for step, shape in SMALL.items():
        assert _shapes(lm.input_specs(cfg, shape, quantized_kv=True), cfg) == want[step], step


def test_counts_grow_exactly_linearly_in_layers():
    """Reduced qwen's train step on a fake 1 x 2 mesh at 1, 2 and 3 layers:
    every count's step from 1 to 2 layers equals its step from 2 to 3."""
    recs = []
    for n in (1, 2, 3):
        cfg = reduce_config(get_config("qwen1.5-0.5b")).replace(dtype="float32", layers=n)
        recs.append(dryrun.lower_cell("qwen1.5-0.5b", SMALL["train"], cfg=cfg,
                                      mesh_shape=(1, 2)))
    for read in (lambda r: r["cost"]["flops_per_dev"], lambda r: r["cost"]["bytes_per_dev"],
                 lambda r: r["mem"]["argument_bytes_per_dev"],
                 *(lambda r, k=k: r["collectives"]["counts"].get(k, 0)
                   for k in ca.COLLECTIVE_KINDS)):
        a, b, c = map(read, recs)
        assert b - a == c - b
    assert all(r["cost"]["widen_bytes_per_dev"] == 0 for r in recs)     # float32
    assert recs[1]["cost"]["flops_per_dev"] > recs[0]["cost"]["flops_per_dev"]
    assert recs[1]["collectives"]["counts"]["all-gather"] > \
        recs[0]["collectives"]["counts"]["all-gather"]


def test_one_device_flops_equal_flop_counter_and_the_reference_hlo(reference):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_fold_step, make_train_step
    from repro_torch.models.ppm import init_ppm
    from repro_torch.optim import adamw
    cfg = reduce_config(get_config("qwen1.5-0.5b")).replace(dtype="float32")
    rec = dryrun.lower_cell("qwen1.5-0.5b", SMALL["train"], cfg=cfg, mesh_shape=())
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.zeros(8, 32, dtype=torch.int32) for k in ("tokens", "labels")}
    with dispatch.use_backend("ref"), FlopCounterMode(display=False) as fc:
        make_train_step(cfg)(params, adamw.init(params), batch)
    assert rec["cost"]["flops_per_dev"] == fc.get_total_flops() > 0
    got, want = rec["cost"]["flops_per_dev"], reference["hlo_flops"]
    assert abs(got - want) <= HLO_RTOL * want, (got, want)
    # the fold, under inference mode (composite ops decomposed as FlopCounterMode does)
    pcfg = reduce_ppm_config()
    shape = ShapeSpec("ns48", 48, 1, "fold")
    frec = dryrun.lower_cell("esmfold_ppm", shape, cfg=pcfg, mesh_shape=())
    p = init_ppm(pcfg, seed=0, device="cpu")
    with dispatch.use_backend("ref"), torch.inference_mode(), \
            FlopCounterMode(display=False) as fc:
        make_fold_step(pcfg)(p, torch.zeros(1, 48, dtype=torch.int32))
    assert frec["cost"]["flops_per_dev"] == fc.get_total_flops() > 0


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_sharded_flops_hold_to_the_reference_hlo(reference, mesh_shape):
    cfg = reduce_config(get_config("qwen1.5-0.5b")).replace(dtype="float32")
    rec = dryrun.lower_cell("qwen1.5-0.5b", SMALL["train"], cfg=cfg, mesh_shape=mesh_shape)
    got = rec["cost"]["flops_per_dev"]
    want = reference["hlo_flops_mesh"]["x".join(map(str, mesh_shape))]
    assert rec["chips"] == 2 and abs(got - want) <= HLO_RTOL * want, (got, want)
    assert got < reference["hlo_flops"]            # a device's share of the step


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "chatglm3-6b"])     # tied, untied
def test_sharded_train_step_never_makes_the_whole_logits(name):
    """Reduced float32 configs with a vocabulary of 32,768 (the logits then
    dominate) on a fake 2 x 2 mesh, 8 x 64 tokens (one chunk)."""
    cfg = reduce_config(get_config(name)).replace(dtype="float32", vocab=32768)
    b, s = 8, 64
    mode = ca.CostMode()
    dryrun.lower_cell(name, ShapeSpec("t", s, b, "train"), cfg=cfg, mesh_shape=(2, 2),
                      mode=mode)
    whole = b * s * cfg.vocab * 4 // 2            # the f32 logits over |model|
    assert mode.largest[0] < whole, mode.largest


@pytest.mark.parametrize("name", ["phi-3-vision-4.2b", "chatglm3-6b"])  # heads, head dim
def test_sharded_decode_step_attends_the_ring_where_it_lies(name):
    """A decode step of reduced float32 configs (1 layer; phi-3's 4 K/V
    heads, chatglm3's one, whose ring is sharded on the head dim) on a
    fake 2 x 2 mesh, 8 rows against 4,096 ring positions."""
    cfg = reduce_config(get_config(name)).replace(dtype="float32", layers=1)
    b, w = 8, 4096
    mode = ca.CostMode()
    rec = dryrun.lower_cell(name, ShapeSpec("d", w, b, "decode"), cfg=cfg, mesh_shape=(2, 2),
                            mode=mode)
    ring = 2 * b * w * cfg.n_kv_heads * cfg.hd * 4 // 4   # one layer's K and V, 4 shards
    assert mode.largest[0] < ring, mode.largest
    assert rec["collectives"]["counts"].get("all-reduce", 0) > 0


#: (arch, step, fake mesh, (batch, seq)): the smallest where DTensor's own
#: folds of the MoE routing groups broke ("shape '[1, 32, 64]' is invalid
#: for input of size 1024"; mixtral's: "... would remove or reshape
#: sharded dimension 1", "Cannot unflatten unevenly sharded tensor")
MOE_CELLS = [("deepseek-v2-lite-16b", "train", (2, 2), (8, 32)),
             ("deepseek-v2-lite-16b", "prefill", (2, 2), (16, 64)),
             ("mixtral-8x22b", "train", (2, 4), (16, 64)),
             ("mixtral-8x22b", "prefill", (4, 2), (16, 64))]


@pytest.mark.parametrize("name,step,mesh,bs", MOE_CELLS,
                         ids=[f"{a}-{st}" for a, st, _, _ in MOE_CELLS])
def test_moe_steps_trace_on_a_sharded_batch(name, step, mesh, bs):
    cfg = reduce_config(get_config(name))
    b, s = bs
    rec = dryrun.lower_cell(name, ShapeSpec("x", s, b, step), cfg=cfg, mesh_shape=mesh)
    assert rec["chips"] == mesh[0] * mesh[1]
    assert rec["cost"]["flops_per_dev"] > 0 and rec["mem"]["peak_bytes_per_dev"] > 0


def test_roofline_bottleneck_selection_with_the_cards_constants():
    mc = ca.ModuleCost(flops=ca.PEAK_FLOPS, bytes=ca.HBM_BW * 10, coll={}, coll_counts={},
                       loops=[])
    rl = ca.roofline_from_module(mc, chips=1, model_flops=ca.PEAK_FLOPS)
    assert rl.bottleneck == "memory"
    assert rl.t_memory == pytest.approx(10.0)
    assert rl.roofline_fraction == pytest.approx(0.1)
    assert (ca.PEAK_FLOPS, ca.HBM_BW, ca.LINK_BW) == (989e12, 3.35e12, 450e9)
    mc = ca.ModuleCost(flops=0.0, bytes=0.0, coll={"all-gather": ca.LINK_BW * 3},
                       coll_counts={"all-gather": 1}, loops=[])
    rl = ca.roofline_from_module(mc, chips=4)
    assert rl.bottleneck == "collective" and rl.t_collective == pytest.approx(3.0)


#: the reference's record keys (``launch/dryrun.py``), with the port's changes
_REF_KEYS = {"arch", "shape", "step", "mesh", "chips", "quantized_kv", "compile_s", "mem",
             "fits_hbm_16g", "cost", "collectives", "roofline", "n_params"}
_PORT_KEYS = (_REF_KEYS - {"compile_s", "fits_hbm_16g"}) | {"trace_s", "fits_hbm_80g",
                                                           "device"}


def test_cli_writes_the_reference_record(tmp_path, monkeypatch, capsys):
    """``--arch qwen1.5-0.5b --shape train_4k --mesh single`` on the fake
    16 x 16 mesh, at the reduced width (the full width: ``chip_smoke.py``),
    appended to ``--out``; ``long_500k`` of a full-attention arch is
    recorded as skipped; a failing cell is recorded and exits 1."""
    reduced = reduce_config(get_config("qwen1.5-0.5b"))
    monkeypatch.setattr(dryrun, "get_config", lambda name: reduced)
    out = tmp_path / "dry.jsonl"
    argv = ["--arch", "qwen1.5-0.5b", "--mesh", "single", "--out", str(out)]
    assert dryrun.main([*argv, "--shape", "train_4k"]) == 0
    assert dryrun.main([*argv, "--shape", "long_500k"]) == 0
    rec, skip = [json.loads(line) for line in out.read_text().splitlines()]
    assert set(rec) == _PORT_KEYS
    assert rec["chips"] == 256 and rec["mesh"] == "single" and rec["shape"] == "train_4k"
    assert set(rec["mem"]) == {"argument_bytes_per_dev", "output_bytes_per_dev",
                               "temp_bytes_per_dev", "alias_bytes_per_dev",
                               "peak_bytes_per_dev"}
    assert set(rec["cost"]) == {"flops_per_dev", "bytes_per_dev", "widen_bytes_per_dev"}
    # bf16 products on DTensors widen their operands: counted apart, and in
    # the bytes
    assert 0 < rec["cost"]["widen_bytes_per_dev"] < rec["cost"]["bytes_per_dev"]
    assert set(rec["collectives"]) == {"per_device_bytes", "counts", "loops"}
    assert rec["collectives"]["counts"]["all-gather"] > 0
    assert set(rec["roofline"]) == {"t_compute_s", "t_memory_s", "t_collective_s",
                                    "bottleneck", "model_flops", "hlo_flops_global",
                                    "useful_fraction", "roofline_fraction"}
    m = rec["mem"]
    assert m["peak_bytes_per_dev"] == (m["argument_bytes_per_dev"] + m["output_bytes_per_dev"]
                                       + m["temp_bytes_per_dev"] - m["alias_bytes_per_dev"])
    assert "skipped" in skip and "[skip]" in capsys.readouterr().out

    def broken(*a, **k):
        raise RuntimeError("broken cell")

    monkeypatch.setattr(dryrun, "lower_cell", broken)
    assert dryrun.main([*argv, "--shape", "train_4k"]) == 1
    assert json.loads(out.read_text().splitlines()[-1])["error"] == "broken cell"


def _fold_on_pair_shard(cfg, shape, mesh_shape) -> ca.CostMode:
    """The fold cell traced as the dry-run traced it before the grid: the
    pair tensor split on j over ``model`` (``PairShard``), the parameters
    whole on every rank."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.schemes import FP16Baseline
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_fold_step
    from repro_torch.models.ppm import init_ppm
    from repro_torch.parallel import sharding as sh
    dev = dryrun.default_device()
    mode = ca.CostMode()
    with dryrun.fake_mesh(mesh_shape, dev) as mesh, dryrun._index_math_on_host(), \
            FakeTensorMode(), dispatch.use_backend("ref"):
        params = init_ppm(cfg, seed=0, device=dev)
        shard = sh.PairShard(mesh.get_group("model"), mesh_shape[1],
                             mesh.get_local_rank("model"))
        aatype = torch.zeros((shape.global_batch, shape.seq_len), dtype=torch.int32,
                             device=dev)
        mode.track((params, aatype))
        with mode, torch.inference_mode():
            out = make_fold_step(cfg, FP16Baseline(), shard=shard)(params, aatype)
        mode.outputs(out)
    return mode


def test_fold_cell_on_the_grid_holds_less_than_the_j_split():
    cfg = reduce_ppm_config()
    shape = ShapeSpec("ns64", 64, 1, "fold")
    mode = ca.CostMode()
    rec = dryrun.lower_cell("esmfold_ppm", shape, cfg=cfg, mesh_shape=(2, 2), mode=mode)
    j = _fold_on_pair_shard(cfg, shape, (2, 2))
    assert rec["chips"] == 4 and rec["cost"]["flops_per_dev"] > 0
    assert rec["mem"]["peak_bytes_per_dev"] < j.mem["peak_bytes_per_dev"], \
        (rec["mem"], j.mem)
    assert mode.largest[0] < j.largest[0], (mode.largest, j.largest)
    counts = rec["collectives"]["counts"]
    assert counts.get("all-gather", 0) > 0 and counts.get("all-to-all", 0) > 0
