"""Unit parity of the port's model-zoo modules with the JAX reference on the
CPU (float32, one torch thread, the reference's own parameters), the
reference's property tests of those modules ported to the port, and the
attention route of MLA's narrower v.

Gates:
  * ``_dispatch_tensors``: bitwise, ties included (``jax.lax.top_k`` sends
    a tie to the lower index; the port's stable descending sort does too);
  * ``moe_apply``, ``mla_apply`` (prefill and a decode step), ``ssd_chunked``,
    ``_rglru`` (its log-depth scan against ``jax.lax.associative_scan``),
    ``encode`` / ``decode_full``: allclose 1e-4 (float32 sums and scans in
    another order);
  * the properties (identical experts = one dense FFN, capacity drops
    tokens, SSD chunked = the sequential recurrence): the reference's own
    tolerances;
  * ``dispatch.attention`` with q/k head dim 192 and v 128 on the kernel
    route (v padded to 192, the output sliced; the kernel's plain version
    here) against the ref route: allclose 1e-5.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import hybrid as jhy  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jme  # noqa: E402
from repro.models import ssm as jsm  # noqa: E402
from repro_torch.bridge import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    TC_HEAD_DIMS, _flash_launch_args)
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import hybrid as thy  # noqa: E402
from repro_torch.models import moe as tme  # noqa: E402
from repro_torch.models import ssm as tsm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(name):
    jcfg = jax_reduce_config(jax_get_config(name)).replace(dtype="float32")
    return jcfg, reduce_config(get_config(name)).replace(dtype="float32")


def _params(name):
    jcfg, tcfg = _cfgs(name)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                                device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def _tied_gates(rng):
    """Rows with exact ties: all equal, pairs equal at the top-k edge."""
    g = rng.random((16, 8)).astype(np.float32)
    g[0] = 0.125                                   # every expert ties
    g[1] = 0.1
    g[1, [2, 5, 6]] = 0.9                          # three-way tie for two places
    g[2, :] = 0.0
    g[2, [7, 0]] = 0.5                             # tie between the last and first
    g[3, [1, 3]] = g[3].max() + 0.1
    return g


@pytest.mark.parametrize("case", ["k2", "k6", "ties", "groups"])
def test_dispatch_tensors_bitwise(case):
    rng = np.random.default_rng(21)
    if case == "k2":
        gates, k, cap = jax.nn.softmax(rng.standard_normal((32, 4)).astype(np.float32)), 2, 4
    elif case == "k6":
        gates, k, cap = jax.nn.softmax(rng.standard_normal((512, 64)).astype(np.float32)), 6, 60
    elif case == "ties":
        gates, k, cap = _tied_gates(rng), 2, 3
    else:   # a (groups, G, E) batch, as moe_apply hands it over
        gates, k, cap = jax.nn.softmax(rng.standard_normal((3, 24, 8)).astype(np.float32)), 2, 5
    gates = np.asarray(gates)
    fn = jme._dispatch_tensors
    if gates.ndim == 3:
        fn = jax.vmap(lambda g: jme._dispatch_tensors(g, k, cap))
        want = fn(jnp.asarray(gates))
    else:
        want = fn(jnp.asarray(gates), k, cap)
    got = tme._dispatch_tensors(_t(gates), k, cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "ties":       # torch.topk need not agree with lower-index ties
        _, idx = tme._top_k(_t(gates), k)
        assert idx[0].tolist() == [0, 1] and idx[1].tolist() == [2, 5]
        assert idx[2].tolist() == [0, 7]


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v2-lite-16b"])
def test_moe_apply_matches_jax(name):
    """Routed experts (and DeepSeek's shared ones) over one group of 24
    tokens at capacity 15 an expert (48 choices over 4 experts)."""
    jcfg, tcfg, jp, tp = _params(name)
    x = np.random.default_rng(4).standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    blk = jax.tree.map(lambda a: a[0], jp["blocks"])["mlp"]
    want = jme.moe_apply(blk, jnp.asarray(x), jcfg)
    _close(tme.moe_apply(tp["blocks"][0]["mlp"], _t(x), tcfg), want)


def test_moe_identical_experts_equals_dense():
    """With identical expert weights and ample capacity, routed MoE = one
    dense FFN (combine weights are normalized): dispatch correctness."""
    _, tcfg = _cfgs("mixtral-8x22b")
    tcfg = tcfg.replace(moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, expert_ff=64,
                                      capacity_factor=8.0))
    p = tme.init_moe_mlp(torch.Generator().manual_seed(0), tcfg)
    p["experts"] = {k: {"w": v["w"][:1].expand_as(v["w"]).clone()}
                    for k, v in p["experts"].items()}
    x = torch.randn((2, 16, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    one = {k: {"w": v["w"][0]} for k, v in p["experts"].items()}
    _close(tme.moe_apply(p, x, tcfg), ttf.mlp_apply(one, x, tcfg).numpy(), 2e-4)


def test_moe_capacity_drops_tokens():
    gates = torch.softmax(torch.randn((32, 4), generator=torch.Generator().manual_seed(0)), -1)
    disp, _ = tme._dispatch_tensors(gates, k=2, cap=4)
    # each token appears at most k times; each (expert, slot) at most once
    assert float(disp.sum(dim=(1, 2)).max()) <= 2.0
    assert float(disp.sum(dim=0).max()) <= 1.0 + 1e-6
    # capacity bound: per expert at most cap tokens; 64 choices, 16 seats
    assert float(disp.sum(dim=(0, 2)).max()) <= 4.0 + 1e-6
    assert float(disp.sum()) == 16.0


def test_mla_apply_matches_jax_prefill_and_decode():
    jcfg, tcfg, jp, tp = _params("deepseek-v2-lite-16b")
    jb = jax.tree.map(lambda a: a[0], jp["blocks"])["attn"]
    tb = tp["blocks"][0]["attn"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7)).copy()
    want, _ = jme.mla_apply(jb, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    _close(tme.mla_apply(tb, _t(x), tcfg, positions=_t(pos)), want)
    # decode: 3 steps into a 5-row latent ring
    m = tcfg.mla
    jc = {"latent": jnp.zeros((2, 5, m.kv_lora_rank)),
          "k_rope": jnp.zeros((2, 5, m.qk_rope_head_dim))}
    tc = {"latent": torch.zeros((2, 5, m.kv_lora_rank)),
          "k_rope": torch.zeros((2, 5, m.qk_rope_head_dim)),
          "pos": torch.zeros((), dtype=torch.int32)}
    for step in range(3):
        xs = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        p1 = np.full((2, 1), step, np.int32)
        want, jc = jme.mla_apply(jb, jnp.asarray(xs), jcfg, positions=jnp.asarray(p1), cache=jc)
        got = tme.mla_apply(tb, _t(xs), tcfg, positions=_t(p1), cache=ttf.LockstepRing(tc))
        tc["pos"] = tc["pos"] + 1
        _close(got, want)
    _close(tc["latent"], jc["latent"])
    _close(tc["k_rope"], jc["k_rope"])


def test_attention_pads_mla_v_on_the_kernel_route():
    """q/k head dim 192, v 128 (DeepSeek's MLA): the kernel route pads v
    to 192 and slices the output back; the same as the ref route, and
    counted as one flash call."""
    rng = np.random.default_rng(6)
    q, k = (_t(rng.standard_normal((2, 9, 4, 192)).astype(np.float32)) for _ in range(2))
    v = _t(rng.standard_normal((2, 9, 4, 128)).astype(np.float32))
    scale = 1.0 / math.sqrt(192)
    dispatch.reset_counters()
    got = dispatch.attention(q, k, v, causal=True, softmax_scale=scale, backend="kernel")
    assert dispatch.plain_counts()["flash_mha"] == 1
    want = dispatch.attention(q, k, v, causal=True, softmax_scale=scale, backend="ref")
    assert tuple(got.shape) == (2, 9, 4, 128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    kvl = torch.tensor([3, 9], dtype=torch.int32)
    got = dispatch.attention(q[:, :1], k, v, kv_valid_len=kvl, softmax_scale=scale,
                             backend="kernel")
    want = dispatch.attention(q[:, :1], k, v, kv_valid_len=kvl, softmax_scale=scale,
                              backend="ref")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [96, 192, 256])
def test_flash_launch_args_take_the_zoo_head_dims(d):
    """phi-3-vision 96, MLA 192 (v padded), RecurrentGemma 256 with MQA:
    the Hopper prefill variant (the tensor-core one's head dims too), with
    its 16-byte rule; float32 at these dims takes the float32 kernel, as the
    reference's kernel takes any head dim in either type."""
    assert d in TC_HEAD_DIMS
    q = torch.empty((2, 64, 16, d), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 2048, 1, d), dtype=torch.bfloat16, device="meta")
    kvl = torch.empty((2,), dtype=torch.int32, device="meta")
    args = _flash_launch_args(q, kv, kv, None, kvl, causal=True, window=2048)
    assert args.variant == "pf" and args.sizes == (2, 64, 2048, 16, 1, d, 1)
    assert args.window == 2048 and args.scale == pytest.approx(1.0 / math.sqrt(d))
    f32 = _flash_launch_args(q.float(), kv.float(), kv.float())
    assert f32.variant == "f32" and f32.sizes[5] == f32.head_dim == d


# --------------------------------------------------------------------------
# SSD
# --------------------------------------------------------------------------
def _ssd_inputs(seed, b=2, s=21, h=3, p=4, n=8):
    rng = np.random.default_rng(seed)
    x, Bm, Cm = (rng.standard_normal(sh).astype(np.float32)
                 for sh in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((h,))).astype(np.float32)
    D = rng.standard_normal((h,)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, Bm, Cm, D, s0


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_jax(init):
    x, dt, A, Bm, Cm, D, s0 = _ssd_inputs(7)       # 21 steps: a padded last chunk
    s0 = s0 if init else None
    wy, wf = jsm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)), chunk=8,
                             init_state=None if s0 is None else jnp.asarray(s0))
    gy, gf = tsm.ssd_chunked(*(_t(a) for a in (x, dt, A, Bm, Cm, D)), chunk=8,
                             init_state=None if s0 is None else _t(s0))
    _close(gy, wy)
    _close(gf, wf)


def test_ssd_chunked_equals_sequential():
    b, s, h, p, n = 1, 24, 2, 4, 8
    g = torch.Generator().manual_seed(0)
    x, Bm, Cm = (torch.randn(sh, generator=g) for sh in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    A = -torch.exp(torch.randn((h,), generator=g))
    D = torch.ones((h,))
    y, fin = tsm.ssd_chunked(x, dt, A, Bm, Cm, D, chunk=8)
    st = torch.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A[None])
        st = st * dA[..., None, None] + torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t],
                                                     Bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], st) + x[:, t] * D[None, :, None])
    _close(y, torch.stack(ys, 1).numpy())
    _close(fin, st.numpy())


def test_segsum_decay_masks_before_exp():
    a = _t(np.cumsum(-np.abs(np.random.default_rng(8).standard_normal((3, 6))), -1)
           .astype(np.float32) * 100)
    got = tsm._segsum_decay(a)
    assert bool(torch.isfinite(got).all())
    _close(got, jsm._segsum_decay(jnp.asarray(a.numpy())), 1e-6)
    assert float(got[..., 0, 1:].abs().max()) == 0.0


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["prefill", "prefill_from_state", "decode"])
def test_rglru_matches_jax(mode):
    jcfg, tcfg, jp, tp = _params("recurrentgemma-9b")
    jb = jax.tree.map(lambda a: a[0], jp["periods"])["b0"]
    tb = tp["periods"][0]["b0"]
    rng = np.random.default_rng(10)
    s = 1 if mode == "decode" else 37                # 37: not a power of two
    w = tcfg.hybrid.lru_width
    x = rng.standard_normal((2, s, w)).astype(np.float32)
    gin = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    st = None if mode == "prefill" else rng.standard_normal((2, w)).astype(np.float32)
    wh, wl = jhy._rglru(jnp.asarray(x), jnp.asarray(gin), jb,
                        None if st is None else jnp.asarray(st))
    gh, gl = thy._rglru(_t(x), _t(gin), tb, None if st is None else _t(st))
    _close(gh, wh)
    _close(gl, wl)


def test_linear_scan_equals_the_loop_over_time():
    g = torch.Generator().manual_seed(3)
    a, b = torch.rand((2, 50, 5), generator=g), torch.randn((2, 50, 5), generator=g)
    h, want = torch.zeros((2, 5)), []
    for t in range(50):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(thy._linear_scan(a, b), torch.stack(want, 1).numpy(), 1e-5)


# --------------------------------------------------------------------------
# enc-dec
# --------------------------------------------------------------------------
def test_encode_and_decode_full_match_jax():
    jcfg, tcfg, jp, tp = _params("whisper-base")
    rng = np.random.default_rng(12)
    frames = rng.standard_normal((2, tcfg.n_audio_frames, tcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, tcfg.vocab, (2, 6)).astype(np.int32)
    want_enc = jed.encode(jp, jnp.asarray(frames), jcfg)
    got_enc = ted.encode(tp, _t(frames), tcfg)
    _close(got_enc, want_enc)
    _close(ted._sinusoid(1500, 512), jed._sinusoid(1500, 512), 1e-3)
    want = jed.decode_full(jp, jnp.asarray(tokens), want_enc, jcfg)
    _close(ted.decode_full(tp, _t(tokens), got_enc, tcfg), want)
