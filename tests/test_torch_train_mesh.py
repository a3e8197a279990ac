"""The port's sharded train step (``launch/steps.py`` on DTensors laid out
by ``parallel/sharding.py``) on spawned gloo ranks, at the reduced configs
in float32, against the port's single-device step and the JAX reference's
loss on the same numpy parameters (the reference's ``init_params``,
bridged) and batch.

Gates:
  * at (2, 2) and (1, 4) (qwen1.5-0.5b; deepseek-v2-lite-16b, MoE with its
    experts over ``model``, at (2, 2)): the sharded step's loss within
    1e-4 relative of the single-device step's and, under ``DISABLED``, of
    the reference's; under ``AAQConfig(ste=True)`` within 1e-4 relative of
    the single-device step (readings 0 to 4.5e-6: see ``AAQ_RTOL``); the
    parameters after the step allclose 1e-5;
  * every rank routes exactly the single-device step's fake-quant calls
    (one an act site: each rank quantizes its own rows);
  * one step of every other kind at 1 x 2 against its single-device step;
  * the gradients on their parameters' placements, or on
    ``grad_shardings``' when given;
  * ``python -m repro_torch.launch.train --device cpu --model-parallel 2``
    end to end: its losses within 1e-4 of ``--model-parallel 1``, and a
    run failed at step 3 and restarted from its checkpoint ends bitwise
    where the uninterrupted run does;
  * the reference's checkpoint of deepseek (its ``blocks`` stacked on a
    leading axis, the dense ``first_block`` apart) with its AdamW state,
    resumed by ``resume_elastic`` on a 1 x 2 mesh: every leaf gathered
    bitwise the reference's, unstacked by the bridge;
  * the dry-run's count of the collectives of reduced qwen's train step
    traced on a fake 1 x 2 mesh equals, kind by kind, what the same step
    ran on 2 gloo ranks (``counting_dtensor``);
  * a prefill step and two decode steps laid out on a 1 x 2 mesh as the
    dry-run lays out its cells (qwen with the INT8 KV cache, deepseek's
    MLA cache, whisper's; qwen's ring sharded on its K/V heads without the
    INT8 cache, chatglm3's one K/V head sharded on the head dim), from a
    random cache: the logits and the cache after them allclose 1e-5 to
    the same steps on one device; each rank attends its own heads (GQA:
    chatglm3's prefill splits its 4 q heads and reads its one K/V head
    whole), and a head-dim ring is attended where it lies (all-reduced
    partial scores, no gather);
  * the cross-entropy and every gradient of reduced qwen (tied) and
    chatglm3 (untied) at 1 x 2, where it is vocabulary-parallel, and at
    2 x 1, where the batch is split and the vocabulary is not: the loss
    within 1e-4 relative of one device's, the gradients allclose 1e-5;
  * a kernel wrapper handed a DTensor raises, and ``dispatch.fake_quant``
    quantizes a DTensor's rows as the plain version does;
  * in the 4-rank spawn, a decode ring sharded on its positions (a
    reduced dense config whose 2 K/V heads and head dim 6 a 4-wide model
    axis divides neither, a ring of 32 on 1 x 4): the logits and the cache
    allclose 1e-5 to one device's, each rank attending its own positions
    (no all-gather of the ring);
  * attention whose heads a 4-wide model axis does not divide (whisper's
    case at 16), split over heads and query rows: the output and the
    gradients allclose 1e-5 to one device's, causal too;
  * the fold on a 2 x 2 ``PairGrid`` (the reference's production layout:
    rows over ``data``, columns over ``model``, each parameter the rank's
    ``param_spec`` shard) of the reduced PPM at N = 64, bridged from the
    reference's parameters: ``baseline_fp16`` and ``tender`` allclose 1e-4
    to one device, ``lightnobel_aaq`` TM >= 0.995; a 1 x 1 grid bitwise
    one device; a 1 x 4 grid bitwise the serving tier's 1 x 4 j split; every rank's parameter bytes those of the reference's
    ``param_shardings(params, mesh, None)`` on a 2 x 2 mesh; and the
    reference's own 2-D fold (``jax.jit(make_fold_step)`` under
    ``default_act_rules(mesh, "train")``, 4 forced host devices, in a
    subprocess): FP allclose 1e-4, AAQ TM >= 0.995; at N = 62, which the
    grid's fine rows do not divide, FP allclose 1e-4 to one device;
  * the same folds row-chunked at ``GRID_CHUNK`` on the grid: 2 x 2
    against the reference's chunked 2-D fold (``ppm_forward(...,
    chunk_size=16)`` under the same rules) and against the port's
    unchunked 2 x 2 fold, FP allclose 1e-4, AAQ TM >= 0.995; a 1 x 1 grid
    bitwise one device's chunked fold; a 1 x 4 grid bitwise the chunked
    1 x 4 ``PairShard`` fold; at N = 62 (a rank's 31 rows divide neither
    into slabs of 16 nor into 4 fine rows) FP allclose 1e-4 to one
    device's chunked fold.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))

from _torch_mesh_ranks import (_cfg, four_rank_jobs, one_step, run_ranks,  # noqa: E402
                               serve_steps, steps_grads_and_elastic)
from _torch_train_parity import batch_for  # noqa: E402
from repro.checkpoint import checkpointing as jckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_ppm_config as jax_reduce_ppm_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.ppm import init_ppm as jax_init_ppm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.bridge import lm_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs import ARCH_NAMES, reduce_ppm_config  # noqa: E402
from repro_torch.core import make_scheme  # noqa: E402
from repro_torch.core.policy import DISABLED, AAQConfig  # noqa: E402
from repro_torch.models.ppm import tm_score  # noqa: E402

RTOL = 1e-4
#: sharded vs single-device loss under AAQ's straight-through fake-quant:
#: read 0 (qwen), 3.5e-7 (deepseek), 4.5e-6 (mixtral) at 1 x 2 and 2 x 2;
#: a fake-quant bin that flips with a sum's order moves it by more
AAQ_RTOL = 1e-4
DENSE, MOE = "qwen1.5-0.5b", "deepseek-v2-lite-16b"
JOBS4 = [(DENSE, (2, 2)), (MOE, (2, 2)), (DENSE, (1, 4))]
#: (arch, INT8 KV cache, what the case holds) of the sharded prefill and
#: decode steps; the id is the arch, or arch-what
SERVE = [(DENSE, True, None), (MOE, False, None), ("whisper-base", False, None),
         (DENSE, False, "heads"), ("chatglm3-6b", False, "hd")]
SERVE_IDS = [a if what is None else f"{a}-{what}" for a, _, what in SERVE]
#: (arch, mesh) of the vocabulary-parallel cross-entropy's gradients
XENT = [(DENSE, (1, 2)), (DENSE, (2, 1)), ("chatglm3-6b", (1, 2)), ("chatglm3-6b", (2, 1))]
OTHERS = [n for n in ARCH_NAMES if n not in (DENSE, MOE)]
#: a reduced dense config whose K/V heads and head dim a 4-wide model axis
#: divides neither (``cache_specs``' third branch: the ring on its
#: positions), its ring 32 rows
RING = (DENSE, dict(n_heads=4, n_kv_heads=2, head_dim=6))
RING_ROWS = 32
#: (q heads, K/V heads, causal) of attention on a 1 x 4 mesh whose model
#: axis divides neither head count
SPLIT_ATTN = [(2, 2, True), (2, 2, False), (6, 2, True)]
#: the grid fold's sequence length and schemes
GRID_N = 64
GRID_SCHEMES = ("baseline_fp16", "lightnobel_aaq", "tender")
GRID_CHUNK = 16
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(name):
    jcfg = jax_reduce_config(jax_get_config(name)).replace(dtype="float32")
    return jcfg, jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for name in ARCH_NAMES:
        jcfg, tree = _tree(name)
        out[name] = (jcfg, tree, batch_for(_cfg(name), b=8, s=16))
    return out


_REF_GRID = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import reduce_ppm_config
from repro.core import make_scheme
from repro.launch.steps import make_fold_step
from repro.models.ppm import init_ppm, ppm_forward
from repro.parallel import sharding as sh
cfg = reduce_ppm_config()
params = init_ppm(jax.random.PRNGKey(0), cfg)
aatype = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
psh = sh.param_shardings(params, mesh, None)
out = {{"param_bytes": sum(int(np.prod(s.shard_shape(p.shape))) * p.dtype.itemsize
                          for p, s in zip(jax.tree.leaves(params), jax.tree.leaves(psh)))}}
for scheme in {schemes}:
    with mesh, sh.act_rules(sh.default_act_rules(mesh, "train")):
        fn = jax.jit(make_fold_step(cfg, make_scheme(scheme)),
                     in_shardings=(psh, NamedSharding(mesh, PartitionSpec(None, "data"))))
        out[scheme] = np.asarray(fn(params, aatype)["coords"])
        chunked = jax.jit(lambda p, a, s=make_scheme(scheme): ppm_forward(
            p, a, cfg, s, chunk_size={chunk})["coords"],
            in_shardings=(psh, NamedSharding(mesh, PartitionSpec(None, "data"))))
        out["chunked_" + scheme] = np.asarray(chunked(params, aatype))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def grid_inputs():
    """(the reference's reduced PPM parameters as numpy, an aatype (1, 64))."""
    tree = jax.tree.map(np.asarray, jax_init_ppm(jax.random.PRNGKey(0),
                                                 jax_reduce_ppm_config()))
    aatype = np.random.default_rng(5).integers(0, 20, (1, GRID_N)).astype(np.int32)
    return tree, aatype


@pytest.fixture(scope="module")
def reference_grid(grid_inputs, tmp_path_factory):
    """The reference's 2-D fold (FP and AAQ) and its parameter bytes a
    device, in a subprocess started before the 4-rank spawn, beside it."""
    d = tmp_path_factory.mktemp("ref_grid")
    np.save(d / "aatype.npy", grid_inputs[1])
    code = textwrap.dedent(_REF_GRID.format(schemes=GRID_SCHEMES[:2], chunk=GRID_CHUNK))
    proc = subprocess.Popen([sys.executable, "-c", code, str(d / "aatype.npy"),
                             str(d / "out.npz")], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"})
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def _ring_job():
    """The prefill and two decode steps of ``RING`` (4 rows, a ring of
    ``RING_ROWS`` from a random cache)."""
    name, over = RING
    jcfg = jax_reduce_config(jax_get_config(name)).replace(dtype="float32", **over)
    tree = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = _cfg(name).replace(**over)
    batch = batch_for(cfg, b=4, s=RING_ROWS)
    del batch["labels"]
    return (RING, tree, batch, _cache(cfg, False, 4, RING_ROWS), 2, False)


def _attn_jobs():
    rng = np.random.default_rng(4)
    jobs = []
    for hq, hkv, causal in SPLIT_ATTN:
        def f(*shape):
            return rng.standard_normal(shape).astype(np.float32)
        jobs.append((f(2, 8, hq, 8), f(2, 8, hkv, 8), f(2, 8, hkv, 8), f(2, 8, hq, 8), causal))
    return jobs


@pytest.fixture(scope="module")
def four_ranks(inputs, grid_inputs, reference_grid):
    """One spawn of 4 ranks: each (arch, mesh) under DISABLED and AAQ; then
    ``RING``'s steps on 1 x 4; then ``SPLIT_ATTN``; then the grid folds."""
    jobs = [(a, inputs[a][1], inputs[a][2], ste, shape)
            for a, shape in JOBS4 for ste in (False, True)]
    ring, attn = _ring_job(), _attn_jobs()
    res = run_ranks(4, four_rank_jobs, jobs, [ring], attn,
                    (*grid_inputs, GRID_SCHEMES, GRID_CHUNK))
    out = {(a, shape, ste): [r[0][i] for r in res]
           for i, (a, _, _, ste, shape) in enumerate(jobs)}
    out["ring"] = (res[0][1][0], ring)
    out["attn"] = list(zip(res[0][2], attn))
    out["grid"] = [r[3] for r in res]
    return out


def _reference_state(name):
    """The reference's (params, AdamW state) of ``name`` after one update."""
    jcfg = jax_reduce_config(jax_get_config(name)).replace(dtype="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jo = jadamw.init(jp)
    jp, jo, _ = jadamw.update(jp, jax.tree.map(lambda a: a * 0.5 + 0.1, jp), jo,
                              jadamw.AdamWConfig(lr=0.1))
    return jp, jo


def _cache(name, qkv, b, s, seed=3):
    """The leaves of ``lm.make_cache`` for ``name`` (or a config), random
    (float and int8 leaves), every ``pos`` at 5: a decode step reads five
    written rows."""
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    rng = np.random.default_rng(seed)

    def fill(t):
        if isinstance(t, dict):
            return {k: torch.full_like(v, 5) if k == "pos" else fill(v) for k, v in t.items()}
        if isinstance(t, list):
            return [fill(v) for v in t]
        if t.dtype.is_floating_point:
            return torch.from_numpy(0.5 * rng.standard_normal(tuple(t.shape))).to(t.dtype)
        if t.dtype == torch.int8:
            return torch.from_numpy(rng.integers(-127, 128, tuple(t.shape)).astype(np.int8))
        return t

    cfg = _cfg(name) if isinstance(name, str) else name
    return [t.numpy() for t in leaves(fill(lm.make_cache(cfg, b, s, quantized=qkv,
                                                          device="cpu")))]


def _serve_job(inputs, name, qkv):
    _, tree, batch = inputs[name]
    batch = {k: v for k, v in batch.items() if k != "labels"}
    n, s = batch["tokens"].shape
    return (name, tree, batch, _cache(name, qkv, n, s), 2, qkv)


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    """One spawn of 2 ranks: every other kind, one step at 1 x 2; then
    qwen's gradient placements (``grad_placements``); then the reference's
    checkpoint of deepseek (layers stacked) resumed elastically at 1 x 2;
    then the collectives of qwen's step; then the prefill and decode steps
    of ``SERVE`` at 1 x 2; then the cross-entropy's gradients of
    ``XENT``."""
    jobs = [(a, inputs[a][1], inputs[a][2], False, (1, 2)) for a in OTHERS]
    ckpt_dir = str(tmp_path_factory.mktemp("stacked_ckpt"))
    state = _reference_state(MOE)
    jckpt.save(ckpt_dir, 7, state)
    serve_jobs = [_serve_job(inputs, a, qkv) for a, qkv, _ in SERVE]
    xent_jobs = [(a, inputs[a][1], inputs[a][2], shape) for a, shape in XENT]
    res = run_ranks(2, steps_grads_and_elastic, jobs, inputs[DENSE][1], inputs[DENSE][2],
                    MOE, ckpt_dir, serve_jobs, xent_jobs)
    out = {a: [r[0][i] for r in res] for i, a in enumerate(OTHERS)}
    out["grad_placements"] = [r[1] for r in res]
    out["elastic"] = ([r[2] for r in res], state)
    out["collectives"] = [r[3] for r in res]
    out["serve"] = dict(zip(SERVE_IDS, zip(res[0][4], serve_jobs)))
    out["xent"] = res[0][5]
    return out


def _single(inputs, name, ste):
    cfg = _cfg(name)
    _, tree, batch = inputs[name]
    return one_step(cfg, lm_params_from_numpy(tree, cfg, device="cpu"), batch,
                    AAQConfig(ste=True) if ste else DISABLED)


@pytest.mark.parametrize("ste", (False, True), ids=("fp", "aaq"))
@pytest.mark.parametrize("name,shape", JOBS4, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_sharded_step_matches_single_and_reference(four_ranks, inputs, name, shape, ste):
    ranks = four_ranks[(name, shape, ste)]
    loss, params, fq = _single(inputs, name, ste)
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], loss, rtol=AAQ_RTOL if ste else RTOL)
    if not ste:
        jcfg, tree, batch = inputs[name]
        want = jlm.loss_fn(jax.tree.map(jnp.asarray, tree),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        np.testing.assert_allclose(got["loss"], float(want), rtol=RTOL)
    assert len(got["params"]) == len(params)
    for a, b in zip(got["params"], params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # every rank quantizes its own rows: the single step's act calls, each
    assert fq == (16 if name == DENSE else 12) * ste
    assert [r["fq"] for r in ranks] == [fq] * 4
    assert all(r["loss"] == got["loss"] for r in ranks)


@pytest.mark.parametrize("name", OTHERS)
def test_every_other_kind_steps_at_1x2(two_ranks, inputs, name):
    ranks = two_ranks[name]
    loss, params, _ = _single(inputs, name, False)
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=RTOL)
    for a, b in zip(ranks[0]["params"], params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert ranks[1]["loss"] == ranks[0]["loss"]


def test_grad_shardings_places_the_gradients(two_ranks):
    """``value_and_grad``'s gradients take their parameters' placements
    (a partial sum reduced, a shard scattered), or ``grad_shardings``'
    when given (here every leaf replicated: the same values); and a
    ``make_train_step`` given the parameters' own shardings steps
    bitwise as it does without them."""
    for r in two_ranks["grad_placements"]:
        assert r["grads"] == r["params"]
        assert any("Shard" in p for p in r["params"])
        assert set(r["grads_r"]) == {"(Replicate(), Replicate())"}
        assert r["loss_r"] == r["loss"]
        assert r["gap"] <= 1e-6
        assert r["steps_equal"]


#: ``collectives.counts()`` names -> the dry-run's kinds
_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "permute": "collective-permute", "broadcast": "broadcast", "gather": "gather"}


def test_dry_run_collectives_equal_a_real_1x2_step(two_ranks, inputs):
    """Reduced qwen's train step (8 x 16 tokens, ``DISABLED``) traced on a
    fake 1 x 2 mesh by the dry-run: its collective calls, kind by kind,
    equal those the same step ran on each of 2 gloo ranks."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    n, s = inputs[DENSE][2]["tokens"].shape
    rec = dryrun.lower_cell(DENSE, ShapeSpec("t", s, n, "train"), cfg=_cfg(DENSE),
                            mesh_shape=(1, 2))
    want = rec["collectives"]["counts"]
    assert want.get("all-gather", 0) > 0
    for got in two_ranks["collectives"]:
        assert {_KINDS[k]: v for k, v in got.items()} == want


@pytest.mark.parametrize("name", SERVE_IDS)
def test_sharded_prefill_and_decode_match_one_device(two_ranks, name):
    """The prefill step and two decode steps, sharded on 1 x 2 as the
    dry-run shards its cells (read on the CPU: logits within 3.1e-6, the
    cache within 1.7e-6, of one device's), against one device; the two
    ring cases attend where their rings lie."""
    (prefill, logits, cache, probe), (arch, tree, batch, cache0, n_decode, qkv) = \
        two_ranks["serve"][name]
    cfg = _cfg(arch)
    if name == f"{DENSE}-heads":
        # 4 K/V heads over 2 ranks: each rank attends its 2 (and 2 q heads)
        assert probe["ring"] == "(Shard(dim=1), Shard(dim=3))"
        assert set(probe["decode"]) == {(2, 2)}
    if name == "chatglm3-6b-hd":
        # GQA prefill: 4 q heads split over 2 ranks, the one K/V head whole
        assert set(probe["prefill"]) == {(2, 1)}
        # the ring's head dim over 2 ranks: no local attention call, the
        # partial scores all-reduced once a layer and step
        assert probe["ring"] == "(Shard(dim=1), Shard(dim=4))"
        assert probe["decode"] == [] and probe["all_reduce"] == n_decode * cfg.layers
    want = serve_steps(cfg, lm_params_from_numpy(tree, cfg, device="cpu"), batch, cache0,
                       n_decode, qkv)
    np.testing.assert_allclose(prefill, want[0], rtol=1e-5, atol=1e-5)
    assert len(logits) == n_decode
    for a, b in zip(logits, want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert len(cache) == len(want[2])
    for a, b in zip(cache, want[2]):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,shape", XENT, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_vocab_parallel_loss_and_gradients_match_one_device(two_ranks, inputs, name, shape):
    """``value_and_grad`` of the sharded step against one device's: at
    1 x 2 the cross-entropy splits the vocabulary over ``model`` (each
    rank's own logits, explicit all-reduces; the table's or the head's
    gradient each rank's own columns), at 2 x 1 it does not, and each
    rank looks up its own batch rows (the table's gradient a partial sum
    over ``data``)."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.tree import leaves
    got = two_ranks["xent"][XENT.index((name, shape))]
    cfg = _cfg(name)
    _, tree, batch = inputs[name]
    loss, grads = value_and_grad(lm_params_from_numpy(tree, cfg, device="cpu"),
                                 {k: torch.from_numpy(np.ascontiguousarray(v))
                                  for k, v in batch.items()}, cfg)
    assert got["split"] == (1 if shape == (1, 2) else None)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=RTOL)
    want = [g.numpy() for g in leaves(grads)]
    assert len(got["grads"]) == len(want)
    for a, b in zip(got["grads"], want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_elastic_resume_of_a_stacked_reference_checkpoint(two_ranks):
    """The reference's checkpoint of reduced deepseek's parameters and AdamW
    state (``blocks`` stacked, ``first_block`` apart) resumed by
    ``resume_elastic`` on a 1 x 2 mesh: the step, and every leaf gathered
    bitwise the reference's leaf, unstacked by the bridge; its experts
    sharded over ``model``."""
    from repro_torch.tree import leaves
    ranks, (jp, jo) = two_ranks["elastic"]
    cfg = _cfg(MOE)
    conv = lambda t: lm_params_from_numpy(jax.tree.map(np.asarray, t), cfg,  # noqa: E731
                                          device="cpu")
    want = [np.asarray(x) for x in leaves((conv(jp), {"m": conv(jo["m"]), "v": conv(jo["v"]),
                                                      "step": np.asarray(jo["step"])}))]
    for r in ranks:
        assert r["step"] == 7 and r["mesh"] == (1, 2)
        assert len(r["leaves"]) == len(want)
        for g, w in zip(r["leaves"], want):
            np.testing.assert_array_equal(g, w)
        assert any("Shard" in p for p in r["placements"])


def _train(tmp_path, *extra):
    from repro_torch.launch import train
    return train.main(["--device", "cpu", "--reduced", "--steps", "4", "--batch", "8",
                       "--seq", "32", "--ckpt-every", "2", *extra])


def test_launch_train_model_parallel_end_to_end(tmp_path, capsys):
    """``--model-parallel 2`` alone starts its second rank itself; its
    losses match one device's; a failure at step 3 restarts every rank
    from the step-1 checkpoint and ends bitwise where the uninterrupted
    run does."""
    from repro_torch.tree import leaves
    one = _train(tmp_path, "--ckpt-dir", str(tmp_path / "one"))
    full = _train(tmp_path, "--model-parallel", "2", "--gather-state",
                  "--ckpt-dir", str(tmp_path / "full"))
    assert full.mesh == (1, 2) and one.mesh is None
    np.testing.assert_allclose(full.losses, one.losses, rtol=RTOL)
    failed = _train(tmp_path, "--model-parallel", "2", "--fail-at", "3", "--gather-state",
                    "--ckpt-dir", str(tmp_path / "failed"))
    assert failed.driver.restarts == 1 and failed.driver.starts == [0, 2]
    assert failed.losses[-1] == full.losses[-1]
    for a, b in zip(leaves(failed.state), leaves(full.state)):
        assert not isinstance(a, torch.distributed.tensor.DTensor)
        assert torch.equal(a, b)
    # rank 0 alone prints (the failed run: 3 steps, then 2 replayed), and
    # alone writes the checkpoints
    out = capsys.readouterr().out
    assert out.count("done: 4 steps") == 2 and out.count("done: 5 steps") == 1
    assert sorted(os.listdir(tmp_path / "full")) == ["step_00000001", "step_00000003"]


def test_model_parallel_refuses_more_ranks_than_cards(monkeypatch):
    from repro_torch.launch import mesh as lmesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices"):
        lmesh.training_world(2, "cuda")
    assert lmesh.training_world(2, "cpu") == 2


def test_kernel_wrappers_refuse_dtensors(tmp_path):
    """A DTensor reaches no kernel wrapper (its storage is one rank's
    shard): each raises, and so does ``dispatch`` on either route; the act
    site (``AAQConfig.act``, through ``sharding.on_rows``) quantizes the
    DTensor's rows on the rank, as the plain version does on the whole
    tensor."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel
    from repro_torch.kernels.aaq_quant.aaq_quant import (aaq_fake_quant_kernel,
                                                         aaq_quantize_kernel)
    from repro_torch.kernels.flash_attention.flash_attention import flash_mha_kernel
    from repro_torch.core.quantize import fake_quant
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        x = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
        dx = distribute_tensor(x, mesh, [Shard(0)])
        for call in (lambda: aaq_fake_quant_kernel(dx, 8, 4),
                     lambda: aaq_quantize_kernel(dx, bits=8, k_outliers=4),
                     lambda: aaq_matmul_kernel(dx, dx, dx, dx, dx, bits=8),
                     lambda: flash_mha_kernel(dx[None, :, None], dx[None, :, None],
                                              dx[None, :, None])):
            with pytest.raises(TypeError, match="DTensor"):
                call()
        dispatch.reset_counters()
        for backend in (dispatch.REF, dispatch.KERNEL):
            with pytest.raises(TypeError, match="DTensor"):
                dispatch.fake_quant(dx, bits=8, k_outliers=4, backend=backend)
            with pytest.raises(TypeError, match="DTensor"):
                dispatch.attention(dx[None, :, None], dx[None, :, None], dx[None, :, None],
                                   backend=backend)
        assert not any(dispatch.counters.values())
        aaq = AAQConfig(enabled=True)
        pol = aaq.policy_for("lm.pre_ln")
        assert pol.enabled
        got = aaq.act(dx, "lm.pre_ln")
        assert torch.equal(got.full_tensor(), fake_quant(x, pol.bits, pol.k_outliers))
        assert dispatch.counters["fakequant.ref"] == 1
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the 4-rank spawn's other jobs: a ring on its positions, attention split
# over heads and rows, the fold on a 2 x 2 grid
# --------------------------------------------------------------------------
def test_position_sharded_ring_decode_matches_one_device(four_ranks):
    """``RING`` on 1 x 4: the ring sharded on its 32 positions (8 a rank);
    each rank attends its own (no local attention call, three all-reduces
    a layer and step, no all-gather of a ring shard), the logits and the
    cache after two decode steps within 1e-5 of one device's."""
    (prefill, logits, cache, probe), (arch, tree, batch, cache0, n_decode, qkv) = \
        four_ranks["ring"]
    cfg = _cfg(arch[0]).replace(**arch[1])
    assert probe["ring"] == "(Shard(dim=1), Shard(dim=2))"
    assert probe["decode"] == [] and probe["all_reduce"] == 3 * n_decode * cfg.layers
    shard = (4, RING_ROWS // 4, cfg.n_kv_heads, cfg.hd)
    assert not [g for g in probe["gathered"] if len(g) == 4 and g[1] == shard[1]], \
        probe["gathered"]
    want = serve_steps(cfg, lm_params_from_numpy(tree, cfg, device="cpu"), batch, cache0,
                       n_decode, qkv)
    np.testing.assert_allclose(prefill, want[0], rtol=1e-5, atol=1e-5)
    assert len(logits) == n_decode
    for a, b in zip(logits, want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(cache, want[2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", range(len(SPLIT_ATTN)),
                         ids=["q{}-kv{}-{}".format(h, k, "causal" if c else "full")
                              for h, k, c in SPLIT_ATTN])
def test_attention_heads_the_model_axis_does_not_divide(four_ranks, case):
    """A rank takes a block of heads and a block of query rows (causal at
    its offset): the output and the gradients of q, k and v within 1e-5 of
    one device's; no rank attends every head of every row."""
    from repro_torch.kernels import dispatch
    (out, dq, dk, dv, seen), (q, k, v, w, causal) = four_ranks["attn"][case]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with dispatch.use_backend("ref"):
        o = dispatch.attention(*ts, causal=causal)
        grads = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ts)
    for got, want in zip((out, dq, dk, dv), (o.detach(), *grads)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
    assert seen and all(rows * heads < q.shape[1] * q.shape[2] for rows, heads, _ in seen), seen


@pytest.fixture(scope="module")
def grid_single(grid_inputs):
    """One device's fold of the grid inputs under each scheme; chunked at
    ``GRID_CHUNK`` under the first two ("chunked <scheme>"), and at N - 2
    under the first ("chunked blocks")."""
    from repro_torch.launch.steps import make_fold_step
    cfg = reduce_ppm_config()
    params = params_from_numpy(grid_inputs[0], cfg, device="cpu")
    a = torch.from_numpy(grid_inputs[1])
    out = {}
    for scheme, chunk, aa in ([(s, None, a) for s in GRID_SCHEMES]
                              + [(s, GRID_CHUNK, a) for s in GRID_SCHEMES[:2]]
                              + [(GRID_SCHEMES[0], GRID_CHUNK, a[:, :-2])]):
        with torch.no_grad():
            o = make_fold_step(cfg, make_scheme(scheme), chunk_size=chunk)(params, aa)
        key = (scheme if chunk is None else f"chunked {scheme}" if aa is a
               else "chunked blocks")
        out[key] = (o["coords"].numpy(), o["distogram"].numpy())
    return out


@pytest.mark.parametrize("scheme", GRID_SCHEMES)
def test_one_row_strip_grid_folds_as_the_pair_shard(four_ranks, grid_single, scheme):
    """A 1 x 4 grid (the rows whole, the parameters cut by ``param_spec``)
    folds what the serving tier's 1 x 4 ``PairShard`` folds, bitwise, and
    within 1e-4 of one device."""
    folds = four_ranks["grid"][0][0]
    coords, disto = folds[("1x4", scheme)]
    if scheme == GRID_SCHEMES[0]:
        want = folds[("pair shard", scheme)]
        np.testing.assert_array_equal(coords, want[0])
        np.testing.assert_array_equal(disto, want[1])
    if scheme == "lightnobel_aaq":
        assert _tm(coords, grid_single[scheme][0]) >= 0.995
    else:
        np.testing.assert_allclose(coords, grid_single[scheme][0], rtol=1e-4, atol=1e-4)


def test_grid_fold_where_the_fine_rows_do_not_divide(four_ranks, grid_inputs):
    """N = 62 on the 2 x 2 grid: 62 rows do not split into 4 fine rows, so
    triangular attention runs on each block with its keys gathered;
    ``baseline_fp16`` allclose 1e-4 to one device."""
    from repro_torch.launch.steps import make_fold_step
    cfg = reduce_ppm_config()
    params = params_from_numpy(grid_inputs[0], cfg, device="cpu")
    with torch.no_grad():
        o = make_fold_step(cfg, make_scheme(GRID_SCHEMES[0]))(
            params, torch.from_numpy(grid_inputs[1][:, :-2]))
    coords, disto = four_ranks["grid"][0][0][("2x2 blocks", GRID_SCHEMES[0])]
    np.testing.assert_allclose(coords, o["coords"].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(disto, o["distogram"].numpy(), rtol=1e-4, atol=1e-4)


def _tm(a, b) -> float:
    """TM-score of coords (1, N, 3) against (1, N, 3)."""
    return float(tm_score(torch.from_numpy(a[0]), torch.from_numpy(b[0])))


@pytest.mark.parametrize("scheme", GRID_SCHEMES)
def test_grid_fold_matches_one_device(four_ranks, grid_single, scheme):
    folds = four_ranks["grid"][0][0]
    (coords, disto), (wc, wd) = folds[("2x2", scheme)], grid_single[scheme]
    assert coords.shape == wc.shape and disto.shape == wd.shape
    if scheme == "lightnobel_aaq":
        assert _tm(coords, wc) >= 0.995
    else:
        np.testing.assert_allclose(coords, wc, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(disto, wd, rtol=1e-4, atol=1e-4)
    # a 1 x 1 grid moves nothing and folds what one device folds
    one = folds[("1x1", scheme)]
    np.testing.assert_array_equal(one[0], wc)
    np.testing.assert_array_equal(one[1], wd)


def test_grid_ranks_hold_the_reference_param_spec_shards(four_ranks, reference_grid):
    """Each rank holds the bytes the reference's ``param_shardings(params,
    mesh, None)`` puts on a device of the 2 x 2 mesh, and its fold gathers
    the parameters, the strips and the swapped blocks as collectives."""
    proc, path = reference_grid
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    want = int(np.load(path)["param_bytes"])
    ranks = four_ranks["grid"]
    assert [r[1] for r in ranks] == [want] * 4
    calls = {k: v["calls"] for k, v in ranks[0][2].items()}
    assert calls["all_gather"] > 0 and calls["all_to_all"] > 0 and calls["gather"] == 2
    # cell (0, 1) swaps its off-diagonal blocks with (1, 0) point to point
    assert ranks[1][2]["permute"]["calls"] > 0


@pytest.mark.parametrize("scheme", GRID_SCHEMES[:2])
def test_grid_fold_matches_reference_2d_fold(four_ranks, reference_grid, scheme):
    proc, path = reference_grid
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    want = np.load(path)[scheme]
    got = four_ranks["grid"][0][0][("2x2", scheme)][0]
    if scheme == "baseline_fp16":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert _tm(got, want) >= 0.995


# --------------------------------------------------------------------------
# the row-chunked fold on the grid (the long-fold path in the production
# layout)
# --------------------------------------------------------------------------
def _fold_close(scheme, got, want) -> None:
    """FP: coords and distogram allclose 1e-4; AAQ: coords TM >= 0.995."""
    if scheme == "lightnobel_aaq":
        assert _tm(got[0], want[0]) >= 0.995
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
        if want[1] is not None:
            np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scheme", GRID_SCHEMES[:2])
def test_chunked_grid_fold_matches_the_reference_chunked_2d_fold(four_ranks, reference_grid,
                                                                 scheme):
    proc, path = reference_grid
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    want = np.load(path)["chunked_" + scheme]
    got = four_ranks["grid"][0][0][("2x2 chunked", scheme)][0]
    _fold_close(scheme, (got, None), (want, None))


@pytest.mark.parametrize("scheme", GRID_SCHEMES[:2])
def test_chunked_grid_fold_matches_the_unchunked_grid_fold(four_ranks, scheme):
    folds = four_ranks["grid"][0][0]
    got, want = folds[("2x2 chunked", scheme)], folds[("2x2", scheme)]
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    _fold_close(scheme, got, want)


@pytest.mark.parametrize("scheme", GRID_SCHEMES[:2])
def test_chunked_one_by_one_grid_is_bitwise_one_device_chunked(four_ranks, grid_single, scheme):
    """A 1 x 1 grid moves nothing and slabs as one device does: its chunked
    fold is one device's chunked fold, bitwise."""
    got = four_ranks["grid"][0][0][("1x1 chunked", scheme)]
    want = grid_single[f"chunked {scheme}"]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("scheme", GRID_SCHEMES[:2])
def test_chunked_one_row_strip_grid_is_bitwise_the_pair_shard(four_ranks, grid_single, scheme):
    """A chunked 1 x 4 grid folds what the serving tier's chunked 1 x 4
    ``PairShard`` folds, bitwise, and within the chunked gates of one
    device's chunked fold."""
    folds = four_ranks["grid"][0][0]
    got, want = folds[("1x4 chunked", scheme)], folds[("pair shard chunked", scheme)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _fold_close(scheme, got, grid_single[f"chunked {scheme}"])


def test_chunked_grid_fold_where_neither_slabs_nor_fine_rows_divide(four_ranks, grid_single):
    """N = 62 on the 2 x 2 grid, chunked at 16: a rank's 31 rows take
    slabs of one row, and the triangular attention runs on the blocks;
    ``baseline_fp16`` allclose 1e-4 to one device's chunked fold."""
    got = four_ranks["grid"][0][0][("2x2 blocks chunked", GRID_SCHEMES[0])]
    _fold_close(GRID_SCHEMES[0], got, grid_single["chunked blocks"])
