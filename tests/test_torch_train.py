"""CPU parity of the port's training substrate with the JAX reference: the
AAQ straight-through fake-quant, AdamW, the schedule, gradient
compression, the synthetic data stream and ``make_train_step``.

The same numpy inputs (and the reference's own parameters, bridged) go
through both packages.  Tolerances:
  * bitwise: ``SyntheticLM``/``ShardInfo`` batches (numpy on both sides),
    the straight-through gradient (the identity), the fake-quant forward;
  * 1e-6 (absolute and relative): AdamW's update, the schedule and the
    compressed gradients and residuals, float32 arithmetic in the same
    order, one rounding apart where XLA fuses;
  * one train step (loss, gradient norm) 1e-5 relative: the gradients sum
    in another order (1e-6-level, ``test_torch_train_loss.py``); the
    parameters after two steps within 2 lr of the reference's: AdamW
    divides by sqrt(v), which turns a 1e-7 gradient difference on a
    near-zero gradient into a step of up to lr either way.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.core.quantize import fake_quant_ste as jax_fake_quant_ste  # noqa: E402
from repro.data.pipeline import ShardInfo as JaxShardInfo  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.optim.schedule import linear_warmup as jax_linear_warmup  # noqa: E402
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.bridge import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.quantize import fake_quant, fake_quant_ste  # noqa: E402
from repro_torch.data.pipeline import ShardInfo, SyntheticLM  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw, grad_compress  # noqa: E402
from repro_torch.optim.schedule import linear_warmup, warmup_cosine  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "nested": {"b": rng.standard_normal((16,)).astype(np.float32),
                       "a": rng.standard_normal((3, 2, 5)).astype(np.float32)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# the straight-through fake-quant
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits,k", [(8, 4), (4, 4), (4, 0)])
def test_fake_quant_ste_is_identity_backward_like_the_reference(bits, k):
    rng = np.random.default_rng(bits + k)
    x = (rng.standard_normal((6, 64)) * 3).astype(np.float32)
    g = rng.standard_normal((6, 64)).astype(np.float32)
    want_y, vjp = jax.vjp(lambda a: jax_fake_quant_ste(a, bits, k), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    dispatch.reset_counters()
    y = fake_quant_ste(xt, bits, k)
    assert y.grad_fn is not None and dispatch.counters["fakequant.ref"] == 1
    y.backward(torch.from_numpy(g))
    assert torch.equal(xt.grad, torch.from_numpy(g))                 # identity
    np.testing.assert_array_equal(np.asarray(want_g), g)
    assert torch.equal(y.detach(), fake_quant(torch.from_numpy(x), bits, k))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))


# --------------------------------------------------------------------------
# optimizer, schedule, gradient compression
# --------------------------------------------------------------------------
def test_adamw_update_matches_reference():
    params, grads = _tree(0), _tree(1)
    cfg = dict(lr=0.05, weight_decay=0.1, clip_norm=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init(jp)
    tp = _torch_tree(params)
    ts = adamw.init(tp)
    assert ts["step"].dtype == torch.int32 and all(
        m.dtype == torch.float32 for m in leaves(ts["m"]))
    for i in range(3):
        g = jax.tree.map(lambda a, i=i: a * (i + 1), grads)
        jp, js, jm = jadamw.update(jp, jax.tree.map(jnp.asarray, g), js,
                                   jadamw.AdamWConfig(**cfg), lr_scale=0.7)
        tp, ts, tm = adamw.update(tp, _torch_tree(g), ts, adamw.AdamWConfig(**cfg),
                                  lr_scale=0.7)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        _close(tp, jp, 1e-6)
        _close(ts["m"], js["m"], 1e-6)
        _close(ts["v"], js["v"], 1e-6)
        assert int(ts["step"]) == int(js["step"]) == i + 1


def test_adamw_reduces_quadratic_loss():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=0.5, weight_decay=0.0, clip_norm=100.0)
    for _ in range(60):
        params, state, _ = adamw.update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_adamw_clipping_reports_the_norm_before_clipping():
    params = {"w": torch.ones(4)}
    _, _, m = adamw.update(params, {"w": torch.full((4,), 1e6)}, adamw.init(params),
                           adamw.AdamWConfig(clip_norm=1.0))
    assert float(m["grad_norm"]) > 1e5


def test_schedules_match_reference():
    for s in (0, 1, 5, 99, 100, 101, 5000, 9999, 10000, 20000):
        for kw in ({}, dict(warmup=10, total=100), dict(warmup=0, total=50, floor=0.0)):
            want = float(jax_warmup_cosine(jnp.asarray(s, jnp.int32), **kw))
            got_t = warmup_cosine(torch.tensor(s, dtype=torch.int32), **kw)
            assert got_t.dtype == torch.float32
            np.testing.assert_allclose(float(got_t), want, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(float(warmup_cosine(s, **kw)),
                                       float(jax_warmup_cosine(s, **kw)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(linear_warmup(torch.tensor(s), warmup=7)),
                                   float(jax_linear_warmup(jnp.asarray(s), warmup=7)), rtol=1e-6)
    vals = [float(warmup_cosine(torch.tensor(s), warmup=10, total=100)) for s in range(10)]
    assert all(b >= a for a, b in zip(vals, vals[1:]))


def test_grad_compress_matches_reference_and_error_feedback_is_unbiased():
    g = {"w": (np.random.default_rng(0).standard_normal((16, 32)) * 0.1).astype(np.float32),
         "b": np.random.default_rng(1).standard_normal((32,)).astype(np.float32)}
    jstate, tstate = jgc.init_state(jax.tree.map(jnp.asarray, g)), grad_compress.init_state(
        _torch_tree(g))
    total = torch.zeros(16, 32)
    for _ in range(8):
        jsent, jstate = jgc.compress_decompress(jax.tree.map(jnp.asarray, g), jstate, bits=8)
        tsent, tstate = grad_compress.compress_decompress(_torch_tree(g), tstate, bits=8)
        _close(tsent, jsent, 1e-6)
        _close(tstate, jstate, 1e-6)
        total = total + tsent["w"]
    np.testing.assert_allclose((total + tstate["w"]).numpy(), 8 * g["w"], rtol=1e-4, atol=1e-4)
    assert grad_compress.wire_bytes({"w": torch.zeros(16, 32)}, bits=8) == \
        jgc.wire_bytes({"w": jnp.zeros((16, 32))}, bits=8) == 16 * 32 + 16 * 4


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("step", [0, 3, 17])
def test_synthetic_lm_batches_are_the_references_bitwise(world, step):
    for rank in range(world):
        kw = dict(seed=5)
        got = SyntheticLM(300, 24, 8, shard=ShardInfo(rank, world), **kw).batch(step)
        want = JaxSyntheticLM(300, 24, 8, shard=JaxShardInfo(rank, world), **kw).batch(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    full = SyntheticLM(300, 24, 8, seed=5).batch(step)
    parts = [SyntheticLM(300, 24, 8, seed=5, shard=ShardInfo(0, 1).reshard(r, world)).batch(step)
             for r in range(world)]
    np.testing.assert_array_equal(np.concatenate([p["tokens"] for p in parts]), full["tokens"])
    assert np.array_equal(full["tokens"][:, 1:], full["labels"][:, :-1])


# --------------------------------------------------------------------------
# make_train_step
# --------------------------------------------------------------------------
def _qwen(seed=0):
    jcfg = jax_reduce_config(jax_get_config("qwen1.5-0.5b")).replace(dtype="float32")
    tcfg = reduce_config(get_config("qwen1.5-0.5b")).replace(dtype="float32")
    jp = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batch(vocab, b=4, s=16, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    """Two steps of ``make_train_step`` (the first at lr 0: the schedule
    starts from 0) against the reference's, from its own parameters."""
    jcfg, tcfg, jp, tp = _qwen()
    opt_cfg = dict(lr=1e-3, weight_decay=0.1)
    jstep = jax.jit(jax_make_train_step(jcfg, jadamw.AdamWConfig(**opt_cfg), microbatches=micro))
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**opt_cfg), microbatches=micro)
    jo, to = jadamw.init(jp), adamw.init(tp)
    lr_bound = 0.0
    for i in range(2):
        batch = _batch(tcfg.vocab, seed=i)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        lr_bound += 2 * opt_cfg["lr"] * float(jax_warmup_cosine(jnp.asarray(i)))
        want = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        d = max(float((a - b).abs().max()) for a, b in zip(leaves(tp), leaves(want)))
        assert d <= lr_bound + 1e-6, (i, d, lr_bound)
        assert int(to["step"]) == i + 1
    assert all(not p.requires_grad for p in leaves(tp))


def test_microbatched_grads_match_full_batch():
    """Port of the reference's test: 4 microbatches against the full batch."""
    _, cfg, _, params = _qwen()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, b=4, s=16).items()}
    p1, p4 = copy.deepcopy(params), copy.deepcopy(params)
    p1, o1, m1 = make_train_step(cfg, microbatches=1)(p1, adamw.init(p1), batch)
    p4, o4, m4 = make_train_step(cfg, microbatches=4)(p4, adamw.init(p4), batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    assert max(float((a - b).abs().max()) for a, b in zip(leaves(p1), leaves(p4))) < 5e-5
    assert max(float((a - b).abs().max()) for a, b in zip(leaves(o1["m"]), leaves(o4["m"]))) < 1e-6


def test_train_step_decreases_loss_on_learnable_data():
    """Port of the reference's test: 40 steps on the Markov stream."""
    _, cfg, _, params = _qwen()
    opt = adamw.init(params)
    data = SyntheticLM(cfg.vocab, 32, 8, seed=0)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=3e-3, weight_decay=0.0))
    losses = []
    for i in range(40):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses
