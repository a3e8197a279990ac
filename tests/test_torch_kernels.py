"""Each kernel's plain PyTorch version against the JAX Pallas kernel run in
interpret mode, the flash references against the JAX references, the
dispatch rules, and the build/binding contract of the CUDA sources.

This box has no card, so the CUDA kernels themselves are held against these
plain versions by ``chip_smoke.py`` on the GPU; here each wrapper gets CPU
tensors and computes its plain version.

Tolerances:
  * aaq_quantize: bitwise against the JAX plain reference; against the
    interpreted Pallas kernel, scales within one float32 ulp and inliers
    within one step (see below), outliers bitwise;
  * aaq_fake_quant: bitwise against ``dequantize`` of the JAX plain
    reference; against ``dequantize`` of the interpreted Pallas kernel,
    within one inlier step of the row plus one ulp of the output type (the
    same one-ulp scale);
  * aaq_matmul, attention: rtol 1e-5, atol 1e-5 of the output's max — the
    same float32 arithmetic summed in another order (and exp in another
    library for attention).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.aaq_matmul.aaq_matmul import aaq_matmul_pallas  # noqa: E402
from repro.kernels.aaq_matmul.ops import aaq_linear as jax_aaq_linear  # noqa: E402
from repro.kernels.aaq_quant.aaq_quant import aaq_quantize_pallas  # noqa: E402
from repro.kernels.aaq_quant.ref import aaq_quantize_ref as jax_quant_ref  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.kernels.flash_attention.flash_attention import flash_mha_pallas  # noqa: E402
from repro_torch.kernels import build, dispatch  # noqa: E402
from repro_torch.kernels.aaq_matmul import aaq_matmul as tmm  # noqa: E402
from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel  # noqa: E402
from repro_torch.kernels.aaq_matmul.ops import aaq_linear  # noqa: E402
from repro_torch.kernels.aaq_quant.aaq_quant import (  # noqa: E402
    _launch_shape, aaq_fake_quant_kernel, aaq_quantize_kernel)
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    DEC_MAX_SPLITS, WG_FUSED, WG_FUSED_Q, WG_HEADS_INNER, WG_KEYS_INNER, DecPlan,
    F32Plan, PfPlan, _flash_launch, _flash_launch_args, dec_plan, f32_plan, flash_mha_kernel,
    flash_mha_plain, launch_head_dim, pf_plan, variant_for, wg_plan, wg_plan_or_none)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of a
    thread per core in each of them oversubscribes the CPU many times."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1.0))


def _activations(t, h, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, h)) * 2).astype(np.float32)
    x[0] = 0.0                                   # padded token: every lane ties
    x[1, : h // 2] = 1.5                         # ties on the largest |x|
    x[2, 3] = 60.0
    x[-1] = np.round(x[-1])
    return x


# --------------------------------------------------------------------------
# aaq_quantize: plain version vs the Pallas kernel (interpret)
#
# The port divides with IEEE rounding (``m / qmax``, ``inl / sigma``), as the
# JAX package's own plain reference does when run op by op; the two agree
# bitwise.  The interpreted Pallas kernel is compiled by XLA, which turns the
# division by the constant qmax into a product with its reciprocal, so its
# scale may sit one float32 ulp away, and an inlier on a rounding tie one
# step away.  Outlier values and indices are bitwise in all three.
# --------------------------------------------------------------------------
def _check_quant(got, want, bits, *, bitwise):
    from repro_torch.core.qtensor import unpack_int4
    for name, w, g in zip(("inliers", "scales", "ovals", "oidx"), want, got):
        w = np.asarray(w).astype(np.float32)
        assert w.shape == tuple(g.shape), name
        if bitwise or name in ("ovals", "oidx"):
            np.testing.assert_array_equal(g.float().numpy(), w, err_msg=name)
        elif name == "scales":
            np.testing.assert_allclose(g.numpy(), w, rtol=1.2e-7, atol=0, err_msg=name)
        else:
            unpack = unpack_int4 if bits == 4 else (lambda a: a)
            wi = torch.from_numpy(np.array(want[0]))
            assert int((unpack(g).int() - unpack(wi).int()).abs().max()) <= 1


@pytest.mark.parametrize("t,h", [(37, 128), (130, 32), (9, 512)])
@pytest.mark.parametrize("bits,k", [(4, 4), (8, 4), (4, 0), (8, 0)])
def test_aaq_quantize_plain_matches_pallas(t, h, bits, k):
    x = _activations(t, h, seed=t + h + bits + k)
    got = aaq_quantize_kernel(_t(x), bits=bits, k_outliers=k)
    # bitwise against the JAX package's plain reference (IEEE division)
    _check_quant(got, jax_quant_ref(jnp.asarray(x), bits, k), bits, bitwise=True)
    want = aaq_quantize_pallas(jnp.asarray(x), bits=bits, k_outliers=k,
                               block_t=64, interpret=True)
    _check_quant(got, want, bits, bitwise=False)


def test_aaq_quantize_bf16_input_matches_reference():
    x = _activations(33, 128, seed=3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = aaq_quantize_kernel(_t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
                              bits=4, k_outliers=4)
    _check_quant(got, jax_quant_ref(xb, 4, 4), 4, bitwise=True)
    _check_quant(got, aaq_quantize_pallas(xb, bits=4, k_outliers=4, block_t=64,
                                          interpret=True), 4, bitwise=False)


# --------------------------------------------------------------------------
# aaq_fake_quant: plain version vs dequantize of the JAX reference and of the
# Pallas kernel (interpret)
# --------------------------------------------------------------------------
def _lane_rows(x):
    """Rows that exercise the CUDA kernel's 16-column lanes: 16 equal maxima
    straddling two lanes, all outliers inside one lane, the largest values in
    the last columns, negative zeros."""
    h = x.shape[1]
    x[3] = 0.25
    x[3, 8:24] = np.where(np.arange(16) % 2, 5.0, -5.0)
    x[4, 16:20] = [50.0, -50.0, 40.0, -40.0]
    x[5, h - 4:] = 9.0
    x[6] = -0.0
    x[6, h // 2] = 1.0
    return x


def _dequantize_jax(out, bits, k, h, dtype):
    from repro.core.qtensor import QTensor as JQTensor
    from repro.core.quantize import dequantize as jdequantize
    return np.asarray(jdequantize(JQTensor(*out, bits=bits, k_outliers=k, feature_dim=h,
                                            orig_dtype=dtype)).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [32, 128, 512])
@pytest.mark.parametrize("bits,k", [(8, 4), (4, 4), (4, 0)])
def test_aaq_fake_quant_plain_matches_dequantized_reference(h, bits, k, dtype):
    x = _lane_rows(_activations(70, h, seed=h + 3 * bits + k))
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = aaq_fake_quant_kernel(tx, bits, k)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.float().numpy()
    want = _dequantize_jax(jax_quant_ref(jx, bits, k), bits, k, h, jx.dtype)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    pallas = aaq_quantize_pallas(jx, bits=bits, k_outliers=k, block_t=64, interpret=True)
    want = _dequantize_jax(pallas, bits, k, h, jx.dtype)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -22
    step = np.asarray(pallas[1]) * (1 + 2.0 ** -20)
    assert np.all(np.abs(got - want) <= step + ulp * np.abs(want))


# --------------------------------------------------------------------------
# the CUDA quantize kernel's lane layout, modelled in numpy
#
# csrc/aaq_quant.cu gives a token G = pow2ceil(H/16) lanes of 16 columns.
# Each value becomes an integer key (|x| bits, 512 - column, sign); a lane
# sorts its keys in four quads (a 5-comparator network) and merges the
# sorted 4-lists in a tree, then log2(G) butterfly levels merge the
# partners' lists (max against the reversed partner list, then a bitonic
# clean-up), and each lane marks the top-k columns it owns.  The model
# below repeats those steps on whole arrays; it must pick the reference's
# top k.
# --------------------------------------------------------------------------
def _order(a, i, j):
    hi, lo = np.maximum(a[..., i], a[..., j]), np.minimum(a[..., i], a[..., j])
    a[..., i], a[..., j] = hi, lo


def _merge4(a, b):
    a = np.maximum(a, b[..., ::-1])
    for i, j in ((0, 2), (1, 3), (0, 1), (2, 3)):
        _order(a, i, j)
    return a


def _lane_model_top4(x, key_bits):
    """(T, H) float32 -> the merged top-4 keys on every lane, (T, G, 4)."""
    t, h = x.shape
    g = 1
    while 16 * g < h:
        g *= 2
    u = np.zeros((t, 16 * g), np.uint64)
    u[:, :h] = x.view(np.uint32)
    col = np.arange(16 * g, dtype=np.uint64)
    low = ((np.uint64(8192) - col) << np.uint64(1)) | (u >> np.uint64(31))
    if key_bits == 32:
        key = (u & np.uint64(0x7FFF0000)) | low
    else:
        key = ((u & np.uint64(0x7FFFFFFF)) << np.uint64(32)) | low
    key[:, h:] = 0
    quad = key.reshape(t, g, 4, 4).copy()
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        _order(quad, i, j)
    top = _merge4(_merge4(quad[:, :, 0], quad[:, :, 1]), _merge4(quad[:, :, 2], quad[:, :, 3]))
    off = 1
    while off < g:
        top = _merge4(top, top[:, np.arange(g) ^ off, :])
        off *= 2
    return top


@pytest.mark.parametrize("key_bits", [32, 64])
@pytest.mark.parametrize("h", [32, 128, 512])
def test_lane_merge_model_picks_the_reference_top4(h, key_bits):
    from repro_torch.core.quantize import topk_lower_index
    rng = np.random.default_rng(h + key_bits)
    x = rng.integers(-3, 4, (96, h)).astype(np.float32)            # ties everywhere
    x[40:] = (rng.standard_normal((56, h)) * 2).astype(np.float32)
    x[0] = 0.0
    x[1, : h // 2] = 1.5
    x[2, 7], x[2, h - 1] = 4.0, -4.0
    x = _lane_rows(x)
    x[50:60] = rng.integers(-1, 2, (10, h)) * 2.0 ** rng.integers(-3, 3, (10, h))
    if key_bits == 32:                                    # bf16 input: 32-bit keys
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    top = _lane_model_top4(x, key_bits)
    assert (top == top[:, :1]).all()                      # every lane holds the same list
    cols = 8192 - ((top >> np.uint64(1)) & np.uint64(0x3FFF)).astype(np.int64)
    g = top.shape[1]
    top, lane_cols = top[:, 0], cols
    cols = cols[:, 0]
    if key_bits == 32:
        bits = (top & np.uint64(0x7FFF0000)) | ((top & np.uint64(1)) << np.uint64(31))
    else:
        bits = (top >> np.uint64(32)) | ((top & np.uint64(1)) << np.uint64(31))
    want = topk_lower_index(torch.from_numpy(np.abs(x)), 4).numpy()
    np.testing.assert_array_equal(cols, want)
    np.testing.assert_array_equal(bits.astype(np.uint32),
                                  np.take_along_axis(x, want, -1).view(np.uint32))
    for k in (1, 2, 4):                 # each lane marks the top-k columns it owns
        d = lane_cols[:, :, :k] - 16 * np.arange(g)[None, :, None]
        mask = np.zeros((x.shape[0], g, 16), bool)
        tok, lane, j = np.nonzero((d >= 0) & (d < 16))
        mask[tok, lane, d[tok, lane, j]] = True
        want_mask = np.zeros_like(x, bool)
        np.put_along_axis(want_mask, want[:, :k], True, -1)
        np.testing.assert_array_equal(mask.reshape(x.shape[0], -1)[:, : x.shape[1]], want_mask)


def _merge4_fifth(a, b, f):
    """merge4, and the largest key the merged top 4 leave out (the minima of
    the half-cleaner's pairs are the union's bottom 4)."""
    f = np.maximum(f, np.minimum(a, b[..., ::-1]).max(-1))
    return _merge4(a, b), f


def _rows_model(x, key_bits, k):
    """The kernel's design for rows wider than 512 (``quant_rows_body``),
    in numpy: one warp a token, lane l owning columns 16 l .. 16 l + 15 of
    every 512-column chunk; each chunk's sorted 4-list folded into the
    lane's running top 4 with the fifth key carried, then 5 butterfly
    levels.  Returns (top-4 keys (T, 32, 4), inlier max |x| (T, 32))."""
    t, h = x.shape
    nch = -(-h // 512)
    u = np.zeros((t, nch * 512), np.uint64)
    u[:, :h] = x.view(np.uint32)
    col = np.arange(nch * 512, dtype=np.uint64)
    low = ((np.uint64(8192) - col) << np.uint64(1)) | (u >> np.uint64(31))
    if key_bits == 32:
        key = (u & np.uint64(0x7FFF0000)) | low
    else:
        key = ((u & np.uint64(0x7FFFFFFF)) << np.uint64(32)) | low
    key[:, h:] = 0
    key = key.reshape(t, nch, 32, 4, 4)                   # (token, chunk, lane, quad, 4)
    top = np.zeros((t, 32, 4), np.uint64)
    fifth = np.zeros((t, 32), np.uint64)
    for ch in range(nch):
        quad = key[:, ch].copy()
        for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
            _order(quad, i, j)
        a, fifth = _merge4_fifth(quad[:, :, 0], quad[:, :, 1], fifth)
        b, fifth = _merge4_fifth(quad[:, :, 2], quad[:, :, 3], fifth)
        c, fifth = _merge4_fifth(a, b, fifth)
        top, fifth = _merge4_fifth(top, c, fifth)
    off = 1
    while off < 32:
        partner = np.arange(32) ^ off
        fifth = np.maximum(fifth, fifth[:, partner])
        top, fifth = _merge4_fifth(top, top[:, partner, :], fifth)
        off *= 2
    nxt = fifth if k == 4 else top[:, :, k]
    if key_bits == 32:
        bits = nxt & np.uint64(0x7FFF0000)
    else:
        bits = nxt >> np.uint64(32)
    return top, bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("key_bits", [32, 64])
@pytest.mark.parametrize("h", [520, 1024, 1536, 6144, 8192])
def test_wide_row_model_picks_the_reference_outliers_and_inlier_max(h, key_bits):
    """The wide-row design gives every lane the reference's top-4 columns
    and values (ties to the lower index) and, from the carried fifth key,
    the inlier max the reference computes (max |x| with the top k zeroed)."""
    from repro_torch.core.quantize import topk_lower_index
    rng = np.random.default_rng(h + key_bits)
    x = rng.integers(-3, 4, (40, h)).astype(np.float32)             # ties everywhere
    x[20:] = (rng.standard_normal((20, h)) * 2).astype(np.float32)
    x[0] = 0.0
    x[1, : h // 2] = 1.5
    x[2, 7], x[2, h - 1] = 4.0, -4.0                                 # chunk ends
    x[3, 511], x[3, 512], x[3, 1023 % h] = 9.0, -9.0, 9.0            # across chunks
    x[4, ::97] = 50.0                                                # > 4 equal maxima
    if key_bits == 32:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = topk_lower_index(torch.from_numpy(np.abs(x)), 4).numpy()
    for k in (1, 2, 3, 4):
        top, m = _rows_model(x, key_bits, k)
        assert (top == top[:, :1]).all() and (m == m[:, :1]).all()
        cols = 8192 - ((top[:, 0] >> np.uint64(1)) & np.uint64(0x3FFF)).astype(np.int64)
        np.testing.assert_array_equal(cols, want)
        inl = np.abs(x).copy()
        np.put_along_axis(inl, want[:, :k], 0.0, -1)
        np.testing.assert_array_equal(m[:, 0], inl.max(-1))


# --------------------------------------------------------------------------
# the CUDA quantize kernel's division rule, modelled in numpy
#
# The kernel rounds v * RN(1/sigma) instead of the IEEE quotient v / sigma,
# and divides only where that product lies within 2^-13 of a half-integer
# (or 1/sigma would be subnormal): for an inlier |v / sigma| <= qmax < 128,
# so the product is within 2^-15 of the rounded quotient and rounds to the
# same integer elsewhere.  numpy's float32 arithmetic is IEEE, as the card's.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("qm", [7, 127])
def test_reciprocal_division_rule_rounds_as_the_ieee_quotient(qm):
    f32 = np.float32
    rng = np.random.default_rng(qm)
    n = 1_000_000
    sigma = np.maximum((2.0 ** rng.uniform(-40, 40, n) * rng.uniform(1, 2, n)).astype(f32),
                       f32(1e-12))
    s64 = sigma.astype(np.float64)
    inlier = (rng.uniform(-1, 1, n) * qm * s64).astype(f32)
    tie = ((rng.integers(-qm, qm, n) + 0.5) * s64).astype(f32)          # a few ulps off
    tie = np.nextafter(tie, np.where(rng.integers(0, 2, n) == 1, np.inf, -np.inf).astype(f32))
    grid = (rng.integers(-qm, qm + 1, n) * s64).astype(f32)             # fake-quantized
    v = np.choose(rng.integers(0, 3, n), [inlier, tie, grid])
    v[::97] = 0.0
    want = np.rint(v / sigma)
    prod = v * (f32(1) / sigma)
    near = (np.abs(prod - (np.floor(prod) + f32(0.5))) < f32(2.0 ** -13)) | ~(sigma < f32(2.0 ** 120))
    np.testing.assert_array_equal(np.rint(np.where(near, v / sigma, prod)), want)
    assert 0.2 < near.mean() < 0.5 and (np.rint(prod) != want).sum() > 1000   # the rule matters


# --------------------------------------------------------------------------
# aaq_matmul: plain version vs the Pallas kernel (interpret)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("t,h,d", [(37, 128, 4), (130, 32, 96), (64, 512, 130)])
@pytest.mark.parametrize("bits,k", [(4, 4), (8, 4), (4, 0)])
def test_aaq_matmul_plain_matches_pallas(t, h, d, bits, k):
    x = _activations(t, h, seed=t * d + bits + k)
    w = (np.random.default_rng(d).standard_normal((h, d)) / np.sqrt(h)).astype(np.float32)
    q, s, ov, oi = (np.asarray(a) for a in jax_quant_ref(jnp.asarray(x), bits, k))
    want = aaq_matmul_pallas(jnp.asarray(q), jnp.asarray(s), jnp.asarray(ov),
                             jnp.asarray(oi), jnp.asarray(w), bits=bits,
                             block_t=32, block_d=64, interpret=True)
    got = aaq_matmul_kernel(_t(q), _t(s), _t(ov.astype(np.float32)).to(torch.bfloat16),
                            _t(oi), _t(w), bits=bits, out_dtype=torch.float32)
    _close(got.numpy(), want)


def test_aaq_linear_matches_reference():
    x = _activations(2 * 5 * 7, 32, seed=11).reshape(2, 5, 7, 32)
    w = np.random.default_rng(1).standard_normal((32, 24)).astype(np.float32)
    want = jax_aaq_linear(jnp.asarray(x), jnp.asarray(w), bits=4, k_outliers=4,
                          block_t=32, block_d=32)
    got = aaq_linear(_t(x), _t(w), bits=4, k_outliers=4)
    assert got.shape == (2, 5, 7, 24)
    _close(got.numpy(), want)


# --------------------------------------------------------------------------
# aaq_matmul's routing rule and the Hopper kernel's plan (meta tensors)
# --------------------------------------------------------------------------
#: (H, D, bits) of every quantized linear a full-width esmfold_ppm block
#: launches under lightnobel_aaq: the triangular bias, the pair projections,
#: triangular attention's qkv, tri-mul's packed projection, the transition's
#: down projection
FOLD_MATMULS = ((128, 4, 4), (128, 128, 4), (128, 384, 4), (128, 512, 4), (512, 128, 4))


@pytest.fixture(scope="module")
def fold_matmul_shapes():
    """(H, D, bits) of the W operands ``aaq_matmul_kernel`` receives during a
    one-block fold at esmfold_ppm's full width on the CPU (kernel mode: the
    kernel wrappers' plain versions)."""
    import dataclasses

    from repro_torch.configs import get_ppm_config
    from repro_torch.core import make_scheme
    from repro_torch.kernels.aaq_matmul import ops
    from repro_torch.models.ppm import init_ppm, ppm_forward
    cfg = dataclasses.replace(get_ppm_config(), blocks=1)
    params = init_ppm(cfg, seed=0, device="cpu")
    seen, real = set(), ops.aaq_matmul_kernel

    def hooked(q, s, ov, oi, w, *, bits, out_dtype):
        seen.add((*w.shape, bits))
        return real(q, s, ov, oi, w, bits=bits, out_dtype=out_dtype)

    aat = torch.from_numpy(np.random.default_rng(0).integers(0, 20, (1, 12)))
    ops.aaq_matmul_kernel = hooked
    try:
        with torch.inference_mode(), dispatch.use_backend("kernel"):
            ppm_forward(params, aat, cfg, make_scheme("lightnobel_aaq"))
    finally:
        ops.aaq_matmul_kernel = real
    return seen


def test_fold_matmul_shapes_are_the_recorded_ones(fold_matmul_shapes):
    assert fold_matmul_shapes == set(FOLD_MATMULS)


def _meta_matmul(t, h, d, bits, k, dtype=torch.bfloat16):
    meta = dict(device="meta")
    return (torch.empty((t, h // 2 if bits == 4 else h), dtype=torch.int8, **meta),
            torch.empty((t, 1), **meta), torch.empty((t, k), dtype=torch.bfloat16, **meta),
            torch.empty((t, k), dtype=torch.int32, **meta),
            torch.empty((h, d), dtype=dtype, **meta))


@pytest.mark.parametrize("h,d,bits", FOLD_MATMULS)
@pytest.mark.parametrize("t", [1, 129, 65536, 262144])
def test_matmul_rule_takes_the_hopper_kernel_at_every_fold_shape_but_d4(h, d, bits, t):
    want = "tc" if d == 4 else "wg"
    assert tmm.variant_for(torch.bfloat16, h, d, bits) == want
    for k in (0, 4):
        args = tmm._matmul_launch_args(*_meta_matmul(t, h, d, bits, k), bits=bits,
                                       out_dtype=torch.bfloat16)
        assert (args.variant, args.t, args.h, args.d, args.k) == (want, t, h, d, k)
        assert (args.plan is None) == (want == "tc")
    if want == "wg":
        for k in (0, 4):
            plan = tmm.wg_plan(h, d, bits, k)
            # W resident, a ring of 2-8 stages and each warpgroup's
            # staged output (and, with outliers, its outlier tile), all inside
            # one block's shared memory
            parts = (plan.warpgroups, plan.stages, plan.out_buffers, k > 0)
            assert plan.smem_bytes == tmm.wg_smem_bytes(h, d, *parts) <= 232448
            assert 2 <= plan.warpgroups <= plan.stages <= 8 and plan.stages % plan.warpgroups == 0
            more = (plan.warpgroups, plan.stages + plan.warpgroups, plan.out_buffers, k > 0)
            assert plan.stages == 8 or tmm.wg_smem_bytes(h, d, *more) > 232448
        assert tmm.wg_plan(h, d, bits, 0).warpgroups == (3 if (h, d) == (512, 128) else 4)
    else:
        assert tmm.wg_plan(h, d, bits) is None


@pytest.mark.parametrize("h,d,bits,dtype,want", [
    (128, 4, 8, torch.bfloat16, "tc"),       # int8 inliers
    (128, 128, 8, torch.bfloat16, "tc"),
    (32, 96, 4, torch.bfloat16, "tc"),       # H and D off 128
    (256, 130, 4, torch.bfloat16, "tc"),
    (128, 8, 4, torch.bfloat16, "tc"),
    (512, 512, 4, torch.bfloat16, "tc"),     # W (512 KB) cannot stay resident
    (256, 256, 4, torch.bfloat16, "wg"),
    (128, 1024, 4, torch.bfloat16, "tc"),
    (128, 128, 4, torch.float32, "f32"),
    (64, 130, 8, torch.float32, "f32"),
])
def test_matmul_rule_keeps_what_the_hopper_kernel_does_not_take(h, d, bits, dtype, want):
    assert tmm.variant_for(dtype, h, d, bits) == want
    args = tmm._matmul_launch_args(*_meta_matmul(1000, h, d, bits, 4, dtype), bits=bits,
                                   out_dtype=dtype)
    assert args.variant == want and (args.plan is not None) == (want == "wg")


def test_matmul_launch_args_refuse_what_no_variant_takes():
    ok = _meta_matmul(64, 128, 128, 4, 4)
    with pytest.raises(ValueError, match="do not match"):
        tmm._matmul_launch_args(ok[0][:, :32], *ok[1:], bits=4, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="same type"):
        tmm._matmul_launch_args(*ok, bits=4, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="k=5"):
        tmm._matmul_launch_args(*_meta_matmul(64, 128, 128, 4, 5), bits=4,
                                out_dtype=torch.bfloat16)
    # H above 512 was refused before the split-W kernel took it (one part)
    assert tmm._matmul_launch_args(*_meta_matmul(64, 1024, 4, 4, 4), bits=4,
                                   out_dtype=torch.bfloat16).variant == "wide"


def test_matmul_hopper_k_order_is_a_permutation_of_each_128_columns():
    """The Hopper kernel's W rows (csrc ``mmwg::phys_row``) in numpy: a
    thread's 16 bytes of q (columns 128 m + 32 c .. + 31, lane % 4 = c) hold
    its fragments' k values, two nibbles 16 bits apart a register."""
    L = np.arange(512)
    m, t, h, c, e = L >> 7, (L >> 4) & 7, (L >> 3) & 1, (L >> 1) & 3, L & 1
    phys = 128 * m + 32 * c + 8 * (t >> 1) + 4 * e + 2 * (t & 1) + h
    src = (tmm.__file__.rsplit("/kernels/", 1)[0] + "/csrc/aaq_matmul.cu")
    text = open(src).read()
    assert "(L & ~127) + 32 * ((L >> 1) & 3) + 8 * ((L >> 5) & 3) + 4 * (L & 1)" in text
    assert sorted(phys) == list(range(512)) and (phys // 128 == m).all()
    nibble = (phys % 32) % 8                           # within the thread's word
    assert ((phys % 128) // 32 == c).all() and ((phys % 32) // 8 == t >> 1).all()
    assert (nibble[e == 1] == nibble[e == 0] + 4).all()   # pairs 16 bits apart


# --------------------------------------------------------------------------
# flash attention: plain version vs the Pallas kernel (interpret)
# --------------------------------------------------------------------------
def _attn_inputs(b, sq, skv, hq, hkv, d, *, bias_b=None, bias_bf16=False, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    bias = None
    if bias_b is not None:
        bias = rng.standard_normal((bias_b, hq, sq, skv)).astype(np.float32)
        if bias_bf16:
            bias = np.asarray(jnp.asarray(bias).astype(jnp.bfloat16).astype(jnp.float32))
    return q, k, v, bias


FLASH_CASES = {
    # name: (b, sq, skv, hq, hkv, d, bias batch, bf16 bias, kv lens, causal, window)
    "ragged": (2, 37, 50, 2, 2, 16, None, False, None, False, None),
    "block-bias": (6, 21, 21, 4, 4, 32, 2, False, None, False, None),
    "tri-bf16-bias-kvlen": (6, 21, 21, 4, 4, 32, 2, True, [21, 21, 21, 15, 15, 15],
                            False, None),
    "fully-masked-row": (2, 19, 33, 2, 2, 8, None, False, [0, 30], False, None),
    "causal": (2, 40, 40, 2, 2, 64, None, False, None, True, None),
    "window": (2, 40, 40, 2, 2, 32, None, False, None, True, 7),
    "gqa": (2, 33, 45, 8, 2, 16, 1, False, [45, 20], False, None),
    # one query row a slot against an MQA ring (the decode kernel's call),
    # key lengths 0, 1, the full ring and between
    "decode-mqa": (5, 1, 48, 8, 1, 64, None, False, [0, 1, 48, 20, 33], False, None),
    # the prefill kernel's: causal GQA in a window at head dim 128
    "causal-gqa-window": (2, 40, 40, 8, 2, 128, None, False, None, True, 9),
    # float32 at phi-3's head dim 96 (the float32 decode and float32
    # kernels): a decode step against a ring, and a causal prefill
    "f32-d96-decode": (3, 1, 40, 8, 8, 96, None, False, [40, 17, 1], False, None),
    "f32-d96-causal": (1, 33, 33, 4, 4, 96, None, False, None, True, None),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(case):
    b, sq, skv, hq, hkv, d, bb, bf, lens, causal, window = FLASH_CASES[case]
    q, k, v, bias = _attn_inputs(b, sq, skv, hq, hkv, d, bias_b=bb, bias_bf16=bf)
    kvl = None if lens is None else np.asarray(lens, np.int32)
    jbias = None if bias is None else jnp.asarray(bias)
    if bf:
        jbias = jbias.astype(jnp.bfloat16)
    want = flash_mha_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias,
                            None if kvl is None else jnp.asarray(kvl), causal=causal,
                            window=window, block_q=16, block_k=16, interpret=True)
    tbias = None if bias is None else _t(bias)
    if bf:
        tbias = tbias.to(torch.bfloat16)
    got = flash_mha_kernel(_t(q), _t(k), _t(v), tbias,
                           None if kvl is None else _t(kvl), causal=causal, window=window)
    _close(got.numpy(), want)
    if case == "fully-masked-row":          # the kernel returns 0 there, mha_ref mean(v)
        assert np.all(got.numpy()[0] == 0.0)
    if case == "decode-mqa":                 # a slot with no valid key returns 0
        assert np.all(got.numpy()[0] == 0.0)


def test_flash_plain_agrees_with_mha_ref_on_rows_with_a_key():
    q, k, v, bias = _attn_inputs(4, 30, 30, 4, 2, 32, bias_b=2, seed=5)
    kvl = _t(np.asarray([30, 12, 30, 1], np.int32))
    a = flash_mha_plain(_t(q), _t(k), _t(v), _t(bias), kvl, causal=True)
    b = tref.mha_ref(_t(q), _t(k), _t(v), bias=_t(bias), kv_valid_len=kvl, causal=True)
    _close(a.numpy(), b.numpy())


# --------------------------------------------------------------------------
# references (the ``ref`` backend) vs the JAX references
# --------------------------------------------------------------------------
@pytest.mark.parametrize("q_chunk", [4, 512])
@pytest.mark.parametrize("masks", ["none", "causal-window-kvlen"])
def test_mha_ref_and_chunked_match_reference(q_chunk, masks):
    q, k, v, bias = _attn_inputs(4, 8, 8, 4, 2, 16, bias_b=2, seed=q_chunk)
    kw = {}
    if masks != "none":
        kw = dict(causal=True, window=3)
    kvl = np.asarray([8, 5, 8, 2], np.int32) if masks != "none" else None
    want = jref.mha_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            bias=jnp.asarray(bias), q_chunk=q_chunk,
                            kv_valid_len=None if kvl is None else jnp.asarray(kvl), **kw)
    got = tref.mha_chunked(_t(q), _t(k), _t(v), bias=_t(bias), q_chunk=q_chunk,
                           kv_valid_len=None if kvl is None else _t(kvl), **kw)
    _close(got.numpy(), want)


def test_block_broadcast_bias_matches_reference():
    bias = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(
        tref._block_broadcast_bias(_t(bias), 6).numpy(),
        np.asarray(jref._block_broadcast_bias(jnp.asarray(bias), 6)))
    # block, not modulo: rows 0..2 read bias row 0
    assert tref._block_broadcast_bias(_t(bias), 6)[2, 0, 0] == 0.0


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------
def test_dispatch_routes_by_mode_and_device():
    q, k, v, bias = (_t(a) for a in _attn_inputs(2, 9, 9, 2, 2, 8, bias_b=1))
    x = torch.randn(3, 5, 32)
    w = torch.randn(32, 8)
    dispatch.reset_counters()
    assert dispatch.get_backend() == dispatch.AUTO
    cpu = torch.device("cpu")
    assert not dispatch.attention_is_kernel(cpu)
    assert dispatch.attention_is_kernel(torch.device("cuda"))     # decided by device type
    assert dispatch.describe(device="cpu") == "auto:ref"
    assert dispatch.describe(device="cuda") == "auto:kernel"
    ref_o = dispatch.attention(q, k, v, bias=bias)
    dispatch.quantized_linear(x, w, bits=4, k_outliers=4)
    ref_fq = dispatch.fake_quant(x, bits=4, k_outliers=4)
    assert dispatch.counters == {"attention.kernel": 0, "attention.ref": 1,
                                 "attention.ref_grad": 0,
                                 "qmatmul.kernel": 0, "qmatmul.ref": 1, "qmatmul.ref_grad": 0,
                                 "fakequant.kernel": 0, "fakequant.ref": 1,
                                 "fakequant.ref_grad": 0,
                                 "quantize.kernel": 0, "quantize.ref": 0, "quantize.ref_grad": 0}
    with dispatch.use_backend("kernel"):
        assert dispatch.attention_is_kernel(cpu)
        assert dispatch.describe(device="cpu") == "kernel-plain"
        ker_o = dispatch.attention(q, k, v, bias=bias)
        dispatch.quantized_linear(x, w, bits=4, k_outliers=4)
        ker_fq = dispatch.fake_quant(x, bits=4, k_outliers=4)
    dispatch.fake_quant(x, bits=8, k_outliers=4, backend="kernel")
    dispatch.fake_quant(x, bits=8, k_outliers=4, backend="ref")
    assert dispatch.get_backend() == dispatch.AUTO
    assert dispatch.counters["attention.kernel"] == 1
    assert dispatch.counters["fakequant.kernel"] == 2 and dispatch.counters["fakequant.ref"] == 2
    assert dispatch.plain_counts() == {"aaq_quantize": 1, "aaq_fake_quant": 2, "aaq_matmul": 1,
                                       "flash_mha": 1}
    assert dispatch.launch_counts() == {"aaq_quantize": 0, "aaq_fake_quant": 0, "aaq_matmul": 0,
                                        "aaq_matmul_wg": 0, "aaq_matmul_f32": 0,
                                        "aaq_matmul_wide": 0, "flash_mha": 0,
                                        "flash_mha_wg": 0, "flash_mha_dec": 0,
                                        "flash_mha_pf": 0, "flash_mha_f32": 0,
                                        "flash_mha_f32_dec": 0}
    assert set(dispatch.MAIN_PATH) <= set(dispatch.launch_counts())
    _close(ker_o.numpy(), ref_o.numpy())
    assert ker_fq.shape == x.shape and torch.equal(ker_fq, ref_fq)
    assert dispatch.describe("ref", device="cuda") == "ref"
    with pytest.raises(ValueError):
        dispatch.set_backend("pallas")
    # the LM's KV-row quantize: the reference dataflow on the CPU, the
    # kernel's plain version when the kernel is asked for; the same QTensor
    dispatch.reset_counters()
    qt_ref = dispatch.quantize(x, bits=4, k_outliers=0)
    qt_ker = dispatch.quantize(x, bits=4, k_outliers=0, backend="kernel")
    assert (dispatch.counters["quantize.ref"], dispatch.counters["quantize.kernel"]) == (1, 1)
    assert dispatch.plain_counts()["aaq_quantize"] == 1
    assert torch.equal(qt_ref.inliers, qt_ker.inliers) and torch.equal(qt_ref.scales, qt_ker.scales)
    dispatch.reset_counters()
    assert sum(dispatch.plain_counts().values()) == 0


# --------------------------------------------------------------------------
# build and ctypes binding contract (static: no nvcc here)
# --------------------------------------------------------------------------
def test_build_commands_target_hopper_without_fast_math(tmp_path):
    srcs = build.sources()
    assert [s.name for s in srcs] == ["aaq_matmul.cu", "aaq_quant.cu", "flash_attention.cu",
                                      "flash_decode.cu", "flash_f32.cu", "flash_prefill.cu"]
    cmds = build.compile_commands("nvcc", srcs, tmp_path)
    assert len(cmds) == len(srcs)                 # one nvcc per source, run together
    for cmd in cmds:
        assert "arch=compute_90a,code=sm_90a" in cmd and "-O3" in cmd
        assert "-std=c++17" in cmd and "-fPIC" in cmd and "-c" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    link = build.link_command("nvcc", [tmp_path / "a.o"], tmp_path / "lib.so")
    assert "-shared" in link
    assert build.BUILD_DIR.name == "build"


def test_ptxas_report_gives_registers_and_spills(tmp_path, monkeypatch):
    """``-Xptxas -v`` is on, and the report kept beside the library parses
    into (registers, spilled bytes) per kernel."""
    assert "-Xptxas" in build.NVCC_FLAGS and "-v" in build.NVCC_FLAGS
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    lib = build._lib_path()
    lib.parent.mkdir(parents=True)
    (lib.parent / build.PTXAS_REPORT).write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1aILi256ELi2EEv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aILi256ELi2EEv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1bv\n"
        "    24 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 24 bytes cumulative stack size\n")
    assert build.ptxas_resources() == {"_Z1aILi256ELi2EEv": (255, 0), "_Z1bv": (168, 24)}


def test_ctypes_signatures_match_the_c_entry_points():
    text = "\n".join(s.read_text() for s in build.sources())
    for name, argtypes in build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), name
        for p, a in zip(params, argtypes):
            if "*" in p:
                assert a is build.ctypes.c_void_p, (name, p)
            elif p.startswith("float"):
                assert a is build.ctypes.c_float, (name, p)
            elif p.startswith("int64_t"):
                assert a is build.ctypes.c_int64, (name, p)
            else:
                assert p.startswith("int ") and a is build.ctypes.c_int, (name, p)
    assert {"aaq_quantize_launch", "aaq_fake_quant_launch"} <= set(build.SIGNATURES)
    # every flash stride is 64-bit
    flash = re.search(r'extern "C" int flash_mha_launch\(([^)]*)\)', text).group(1)
    assert sum("int64_t" in p for p in flash.split(",")) == 13
    assert "cudaGetLastError" in text and "__shfl_xor_sync" in text
    assert "mma.sync.aligned.m16n8k16" in build.headers()[0].read_text()


# --------------------------------------------------------------------------
# quantize launch arguments (meta tensors): the 16-byte loads need aligned rows
# --------------------------------------------------------------------------
@pytest.mark.parametrize("h,dtype,ok", [(128, torch.bfloat16, True), (512, torch.bfloat16, True),
                                        (40, torch.bfloat16, True), (36, torch.float32, True),
                                        (130, torch.bfloat16, False), (34, torch.float32, False),
                                        (513, torch.float32, False)])
def test_quantize_launch_args_need_16_byte_rows(h, dtype, ok):
    x = torch.empty((2048 * 2048, h), dtype=dtype, device="meta")
    for what in ("aaq_quantize", "aaq_fake_quant"):
        if ok:
            assert _launch_shape(x, 4, 4, what) == (2048 * 2048, h)
        else:
            with pytest.raises(ValueError):
                _launch_shape(x, 4, 4, what)
    if ok:
        with pytest.raises(ValueError, match="even"):
            _launch_shape(torch.empty((4, h + 1), device="meta"), 4, 0, "aaq_quantize")
        with pytest.raises(ValueError, match="contiguous"):
            _launch_shape(x[:, : h // 2], 4, 0, "aaq_quantize")
        with pytest.raises(ValueError, match="k="):
            _launch_shape(x, 8, 5, "aaq_quantize")


# --------------------------------------------------------------------------
# flash launch arguments at the trunk's full-length operands (meta tensors)
#
# The kernels index in 64 bits; the wrapper must take the trunk's own views
# at every length the model folds and hand their strides on unchanged.
# --------------------------------------------------------------------------
def _seq_operands(n, heads=16, dh=64):
    """seq_attn_apply's q, k, v views and its f32 bias permuted from (1,N,N,H)."""
    qkv = torch.empty((1, n, 3 * heads * dh), dtype=torch.bfloat16, device="meta")
    q, k, v = (a.reshape(1, n, heads, dh) for a in torch.split(qkv, heads * dh, dim=-1))
    bias = torch.empty((1, n, n, heads), dtype=torch.bfloat16, device="meta")
    return q, k, v, bias.permute(0, 3, 1, 2).float()


def _tri_operands(n, heads=4, dh=32):
    """tri_attn_apply's rows-as-batch views of a split (1,N,N,3*H*dh)
    projection and its permuted (1,N,N,H) bf16 bias."""
    qkv = torch.empty((1, n, n, 3 * heads * dh), dtype=torch.bfloat16, device="meta")
    q, k, v = (a.reshape(1, n, n, heads, dh).reshape(n, n, heads, dh)
               for a in torch.split(qkv, heads * dh, dim=-1))
    bias = torch.empty((1, n, n, heads), dtype=torch.bfloat16, device="meta")
    return q, k, v, bias.permute(0, 3, 1, 2)


@pytest.mark.parametrize("kind,n", [("seq", 512), ("seq", 1024), ("seq", 2048),
                                    ("tri", 1024), ("tri", 2400)])
def test_flash_launch_args_take_the_trunks_operands_at_full_length(kind, n):
    q, k, v, bias = (_seq_operands if kind == "seq" else _tri_operands)(n)
    kvl = torch.empty((q.shape[0],), dtype=torch.int32, device="meta")
    args = _flash_launch_args(q, k, v, bias, kvl)
    assert args.variant == "wg"          # the fold's attention takes the Hopper kernel
    assert args.q_strides == q.stride()[:3] and args.k_strides == k.stride()[:3]
    assert args.v_strides == v.stride()[:3] and args.bias_strides == bias.stride()
    assert args.sizes == (q.shape[0], n, n, q.shape[2], k.shape[2], q.shape[3], 1)
    assert args.bias_kind == (1 if kind == "seq" else 2)
    # the old product guard max(stride) * max(shape) >= 2**31 tripped on these
    assert max(max(a.stride()) * max(a.shape) for a in (q, bias)) >= 2 ** 31 or n < 813
    assert len(args.c_args()) == len(build.SIGNATURES["flash_mha_launch"]) - 7


def test_flash_launch_args_refuse_what_the_kernels_do_not_take():
    q, k, v, bias = _tri_operands(64)
    _flash_launch_args(q, k, v, bias)
    qt = torch.empty((64, 64, 32, 4), dtype=torch.bfloat16, device="meta").transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):                # head dim strided
        _flash_launch_args(qt, k, v, bias)
    base = torch.empty((64, 64, 4, 40), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="16-byte aligned"):            # misaligned view
        _flash_launch_args(base[..., 1:33], k, v, bias)
    padded = torch.empty((64, 64, 4, 36), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="16-byte aligned"):            # 72-byte head stride
        _flash_launch_args(q, padded[..., :32], v, bias)
    with pytest.raises(ValueError, match="broadcast"):                  # 64 % 3 != 0
        _flash_launch_args(q, k, v, torch.empty((3, 4, 64, 64), device="meta"))
    with pytest.raises(ValueError, match="broadcast"):
        _flash_launch_args(q, k, v, bias[..., :63])
    # the float32 variants read 4 bytes at a time where 16 are off: no
    # alignment rule; bf16 at D = 8 pads to 16 on the tensor-core kernel
    f = torch.empty((64, 64, 4, 40), device="meta")[..., 1:33]
    assert _flash_launch_args(f, f, f).variant == "f32"
    assert _flash_launch_args(f[:, :1], f, f).variant == "f32_dec"
    assert variant_for(torch.bfloat16, 8) == "tc" and variant_for(torch.bfloat16, 16) == "tc"
    assert launch_head_dim(torch.bfloat16, 8) == 16 and launch_head_dim(torch.float32, 8) == 8
    assert variant_for(torch.bfloat16, 64) == "dec"


# --------------------------------------------------------------------------
# the Hopper variant: the rule that picks it, its row-grouping plan, and
# what its TMA maps refuse (meta tensors: nothing is launched)
# --------------------------------------------------------------------------
def _tri_rows_operands(rows, n, bb=1, keys_outer=False):
    """Triangular attention's operands for ``rows`` rows of each of ``bb``
    proteins (the chunked slab: rows < n): (bb*rows, n, 4, 32) views of a
    split (bb, rows, n, 384) projection and a permuted (bb, n, n, 4) bias,
    or (``keys_outer``) the bias a mesh rank gathers on its keys, laid out
    (bb, keys, queries, 4)."""
    qkv = torch.empty((bb, rows, n, 384), dtype=torch.bfloat16, device="meta")
    q, k, v = (a.reshape(bb * rows, n, 4, 32) for a in torch.split(qkv, 128, dim=-1))
    bias = torch.empty((bb, n, n, 4), dtype=torch.bfloat16, device="meta")
    return q, k, v, bias.permute(0, 3, 2, 1) if keys_outer else bias.permute(0, 3, 1, 2)


def _seq_block_operands(b, nq, n, structure=False):
    """Sequence attention's (structure=False) or the structure module's
    operands at batch ``b``: ``nq`` query rows (a grid rank's block) against
    ``n`` keys, the f32 bias permuted from (b, nq, n, 16) or contiguous."""
    qkv = torch.empty((b, n, 3 * 1024), dtype=torch.bfloat16, device="meta")
    q, k, v = (a.reshape(b, n, 16, 64) for a in torch.split(qkv, 1024, dim=-1))
    if structure:
        bias = torch.empty((b, 16, nq, n), device="meta")
    else:
        bias = torch.empty((b, nq, n, 16), device="meta").permute(0, 3, 1, 2)
    return q[:, :nq], k, v, bias


FOLD_OPERANDS = {
    **{f"tri N={n}": (lambda n=n: _tri_rows_operands(n, n)) for n in (64, 256, 1024, 2400)},
    "chunked slab (64, 2048)": lambda: _tri_rows_operands(64, 2048),
    "batch 4 tri, Bb=4": lambda: _tri_rows_operands(256, 256, bb=4),
    "grid rank tri (64, 256)": lambda: _tri_rows_operands(64, 256),
    "mesh rank chunked slab, keys outermost": lambda: _tri_rows_operands(64, 256,
                                                                         keys_outer=True),
    **{f"seq N={n}": (lambda n=n: _seq_block_operands(1, n, n)) for n in (256, 1024, 2048)},
    **{f"structure N={n}": (lambda n=n: _seq_block_operands(1, n, n, True))
       for n in (256, 2048)},
    "batch 4 seq, Bb=4": lambda: _seq_block_operands(4, 256, 256),
    "batch 4 structure, Bb=4": lambda: _seq_block_operands(4, 256, 256, True),
    "grid rank seq (128 x 256)": lambda: _seq_block_operands(1, 128, 256),
}


@pytest.mark.parametrize("name", sorted(FOLD_OPERANDS))
def test_flash_rule_takes_the_hopper_kernel_for_every_fold_operand(name):
    q, k, v, bias = FOLD_OPERANDS[name]()
    kvl = torch.empty((q.shape[0],), dtype=torch.int32, device="meta")
    args = _flash_launch_args(q, k, v, bias, kvl)
    assert args.variant == "wg"
    b, sq, skv, hq, hkv, d, bb = args.sizes
    plan = args.plan
    # the rows a block shares one bias tile with lie in one bias block
    assert (b // bb) % plan.rows == 0 and b % plan.rows == 0
    assert plan.rows == (2 if d == 32 and (b // bb) % 2 == 0 else 1)
    assert plan.blocks == -(-sq // 64) * (hq // 4) * (b // plan.rows)
    assert plan.bias_map == (WG_FUSED_Q if "keys outermost" in name else WG_FUSED if d == 32
                             else WG_KEYS_INNER if "structure" in name else WG_HEADS_INNER)


@pytest.mark.parametrize("case", ["causal", "window", "gqa", "d16", "d96", "d128", "d256",
                                  "decode", "no bias"])
def test_flash_rule_keeps_the_tc_kernel_off_the_fold(case):
    d = {"d16": 16, "d96": 96, "d128": 128, "d256": 256}.get(case, 64)
    sq = 1 if case == "decode" else 100
    hkv = 2 if case == "gqa" else 4
    q = torch.empty((2, sq, 4, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 100, hkv, d), dtype=torch.bfloat16, device="meta")
    bias = None if case == "no bias" else torch.empty((2, 4, sq, 100), device="meta")
    args = _flash_launch_args(q, k, k, bias, causal=case == "causal",
                              window=16 if case == "window" else None)
    # without a bias a prefill is the Hopper prefill kernel's (off the fold too)
    want = "pf" if case == "no bias" else "tc"
    assert args.variant == want and (args.plan is None) == (want == "tc")
    assert variant_for(torch.bfloat16, d, sq=sq, hq=4, hkv=hkv, has_bias=bias is not None,
                       causal=case == "causal", window=16 if case == "window" else None) == want


@pytest.mark.parametrize("d", [32, 64])
def test_flash_rule_keeps_the_simt_kernel_for_f32(d):
    """Every float32 call takes a float32 kernel (the SIMT kernel's
    successors): a bias or more query rows the float32 kernel, one row
    without a bias or mask the float32 decode kernel."""
    q = torch.empty((2, 100, 4, d), device="meta")
    args = _flash_launch_args(q, q, q, torch.empty((2, 4, 100, 100), device="meta"))
    assert args.variant == "f32" and args.plan == f32_plan(2, 100, 4, d)
    assert variant_for(torch.float32, d, sq=100, hq=4, hkv=4, has_bias=True) == "f32"
    assert variant_for(torch.float32, d, sq=1, hq=4, hkv=4, has_bias=True) == "f32"
    assert variant_for(torch.float32, d, sq=1, hq=4, hkv=4) == "f32_dec"


def test_flash_hopper_kernel_refuses_what_tma_cannot_take():
    q, k, v, bias = _tri_rows_operands(64, 64)
    assert _flash_launch_args(q, k, v, bias).variant == "wg"
    base = torch.empty((64, 64, 4, 40), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="Hopper kernel.*16-byte aligned"):
        _flash_launch_args(base[..., 1:33], k, v, bias)               # base off 16 bytes
    padded = torch.empty((64, 64, 4, 36), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="Hopper kernel.*16-byte aligned"):
        _flash_launch_args(q, padded[..., :32], v, bias)              # 72-byte head stride
    qt = torch.empty((64, 64, 32, 4), dtype=torch.bfloat16, device="meta").transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):
        _flash_launch_args(qt, k, v, bias)
    # A bias or a scale the Hopper kernel refuses (wg_plan raises) sends the
    # call to the tensor-core kernel, which took each of them before the
    # Hopper kernel existed.
    # a bias whose rows' stride is 66 keys x 4 heads x 2 bytes (not 16-aligned)
    wide = torch.empty((1, 64, 66, 4), dtype=torch.bfloat16, device="meta")
    wide = wide[:, :, 1:65].permute(0, 3, 1, 2)
    # neither heads nor keys innermost: no TMA box
    odd = torch.empty((1, 64, 4, 64), dtype=torch.bfloat16, device="meta").permute(0, 2, 1, 3)
    odd = odd.transpose(2, 3)
    # bf16 with heads innermost but 8 heads a key: no 16-byte box of 4 heads
    q8 = torch.empty((64, 64, 8, 32), dtype=torch.bfloat16, device="meta")
    b8 = torch.empty((1, 64, 64, 8), dtype=torch.bfloat16, device="meta").permute(0, 3, 1, 2)
    refused = [((q, k, v, wide), {}, "bias is read by TMA.*16-byte"),
               ((q, k, v, odd), {}, "suits no TMA box"),
               ((q8, q8, q8, b8), {}, "suits no TMA box"),
               ((q, k, v, bias), {"softmax_scale": 0.0}, "positive softmax scale")]
    for (qq, kk, vv, bb), kw, why in refused:
        b, sq, hq, d = qq.shape
        scale = kw.get("softmax_scale", 1.0)
        with pytest.raises(ValueError, match=why):
            wg_plan(b, sq, hq, d, bb, scale=scale)
        assert wg_plan_or_none(b, sq, hq, d, bb, scale=scale) is None
        assert variant_for(qq.dtype, d, sq=sq, hq=hq, hkv=kk.shape[2], has_bias=True) == "wg"
        args = _flash_launch_args(qq, kk, vv, bb, **kw)
        assert args.variant == "tc" and args.plan is None
    assert wg_plan(8, 64, 8, 32, b8.contiguous()).bias_map == WG_KEYS_INNER


@pytest.mark.parametrize("rows_per_block,d,want", [(64, 32, 2), (63, 32, 1), (1, 32, 1),
                                                   (256, 64, 1)])
def test_wg_plan_groups_rows_inside_each_bias_block(rows_per_block, d, want):
    bias = torch.empty((3, 4, 64, 64), dtype=torch.bfloat16, device="meta")
    plan = wg_plan(3 * rows_per_block, 64, 4, d, bias)
    assert plan.rows == want and rows_per_block % plan.rows == 0
    assert plan.blocks == 1 * 1 * (3 * rows_per_block // want)


# --------------------------------------------------------------------------
# the decode and prefill variants: the rule at the LM tenant's and the zoo's
# shapes, their plans, what their launch arguments refuse (meta tensors)
# --------------------------------------------------------------------------
# name: (B, Sq, Skv, Hq, Hkv, D, causal, window, kv_valid_len): phase 8's
# served steps, and phase 9's prefills and decode steps (16-row rings; the
# recurrentgemma ring is its 2,048 window)
LM_ZOO_FLASH = {
    "qwen1.5-0.5b decode": (4, 1, 256, 16, 16, 64, False, None, True),
    "qwen2.5-3b decode": (4, 1, 256, 16, 2, 128, False, None, True),
    "qwen1.5-0.5b prefill": (1, 13, 13, 16, 16, 64, True, None, False),
    "deepseek MLA prefill": (2, 512, 512, 16, 16, 192, True, None, False),
    "deepseek MLA decode": (2, 1, 16, 16, 16, 192, False, None, True),
    "recurrentgemma prefill": (2, 2560, 2560, 16, 1, 256, True, 2048, False),
    "recurrentgemma decode": (2, 1, 2048, 16, 1, 256, False, None, True),
    "whisper encoder self": (2, 1500, 1500, 8, 8, 64, False, None, False),
    "whisper decoder self prefill": (2, 64, 64, 8, 8, 64, True, None, False),
    "whisper cross prefill": (2, 64, 1500, 8, 8, 64, False, None, False),
    "whisper self decode": (2, 1, 16, 8, 8, 64, False, None, True),
    "whisper cross decode": (2, 1, 1500, 8, 8, 64, False, None, False),
    "phi-3 prefill": (2, 512, 512, 32, 32, 96, True, None, False),
    "phi-3 decode": (2, 1, 16, 32, 32, 96, False, None, True),
    "mixtral prefill": (1, 4608, 4608, 48, 8, 128, True, 4096, False),
    "mixtral decode": (1, 1, 16, 48, 8, 128, False, None, True),
}


def _ring(layers, b, w, hkv, d):
    """One layer's (b, w, hkv, d) view of a stacked decode ring, as the
    LM's ``LockstepRing`` hands it to attention."""
    return torch.empty((layers, b, w, hkv, d), dtype=torch.bfloat16, device="meta")[1]


@pytest.mark.parametrize("name", sorted(LM_ZOO_FLASH))
def test_flash_rule_takes_the_decode_and_prefill_kernels_at_lm_and_zoo_shapes(name):
    b, sq, skv, hq, hkv, d, causal, window, lens = LM_ZOO_FLASH[name]
    q = torch.empty((b, sq, hq * d), dtype=torch.bfloat16, device="meta").view(b, sq, hq, d)
    k, v = (_ring(3, b, skv, hkv, d) for _ in range(2))
    kvl = torch.empty((b,), dtype=torch.int32, device="meta") if lens else None
    scale = 1.0 / 192 ** 0.5 if "MLA" in name else None
    args = _flash_launch_args(q, k, v, None, kvl, causal=causal, window=window,
                              softmax_scale=scale)
    assert args.k_strides == k.stride()[:3]
    if sq == 1:
        assert args.variant == "dec" and args.plan == dec_plan(b, skv, hq, hkv)
        assert isinstance(args.plan, DecPlan) and 1 <= args.plan.splits <= DEC_MAX_SPLITS
    else:
        assert args.variant == "pf" and args.plan == pf_plan(b, sq, hq, d)
        assert isinstance(args.plan, PfPlan)
        rows = 192 if d == 64 else 128          # three consumer warpgroups at D = 64
        assert args.plan.rows == rows and args.plan.blocks == -(-sq // rows) * hq * b
    assert variant_for(torch.bfloat16, d, sq=sq, hq=hq, hkv=hkv, causal=causal,
                       window=window) == args.variant
    # the same operands in float32 take the float32 kernels: one row without
    # a mask the decode one
    want32 = "f32_dec" if sq == 1 and not causal and window is None else "f32"
    assert variant_for(torch.float32, d, sq=sq, hq=hq, hkv=hkv, causal=causal,
                       window=window) == want32


@pytest.mark.parametrize("skv", [0, 1, 16, 64, 65, 256, 1500, 2048, 4097])
def test_dec_plan_splits_a_slot_by_its_ring_alone(skv):
    """A slot's splits depend on the ring length only: the same at every
    batch size and whatever the other slots' key lengths are, so a slot
    launched alone runs the same splits, in the same order, as in a batch."""
    plans = [dec_plan(b, skv, 16, 2) for b in (1, 3, 4, 64)]
    assert len({(p.split, p.splits) for p in plans}) == 1
    p = plans[0]
    assert p.split % 64 == 0 and 1 <= p.splits <= DEC_MAX_SPLITS
    assert p.split * p.splits >= skv and (p.splits - 1) * p.split < max(skv, 1)
    assert [pl.blocks for pl in plans] == [p.splits * 2 * b for b in (1, 3, 4, 64)]
    assert dec_plan(1, skv, 32, 1).blocks == 2 * p.splits        # 32 heads: two groups of 16
    # 8 or more head blocks a slot: splits of at least 128 keys
    many = dec_plan(1, skv, 16, 16)
    assert many.split == max(128, p.split) and many.split % 64 == 0
    for b in (1, 5):
        q = torch.empty((b, 1, 16, 128), dtype=torch.bfloat16, device="meta")
        k = _ring(2, b, skv, 2, 128)
        args = _flash_launch_args(q, k, k, None, torch.empty((b,), dtype=torch.int32,
                                                               device="meta"))
        assert (args.plan.split, args.plan.splits) == (p.split, p.splits)


def _dec_split_model(q, k, v, kvl, scale, split):
    """The decode kernel's arithmetic in float32: each split of ``split``
    keys keeps its own (m, l, o) in the log2 domain, and the splits merge in
    order: o = sum_j 2^(m_j - M) o_j / max(sum_j 2^(m_j - M) l_j, 1e-30)."""
    b, _, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kx = k.float().repeat_interleave(hq // hkv, dim=2)
    vx = v.float().repeat_interleave(hq // hkv, dim=2)
    x = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kx) * (scale * 1.4426950408889634)
    valid = torch.arange(skv)[None, :] < kvl[:, None]
    x = torch.where(valid[:, None], x, torch.full((), -1e30))
    out = torch.zeros((b, hq, d))
    for r in range(b):
        ms, ls, os_ = [], [], []
        for j0 in range(0, max(skv, 1), split):
            xs, ok = x[r, :, j0:j0 + split], valid[r, j0:j0 + split]
            m = xs.amax(dim=-1)
            p = torch.where(ok[None], torch.exp2(xs - m[:, None]), torch.zeros(()))
            ms.append(m)
            ls.append(p.sum(-1))
            os_.append(torch.einsum("hk,khd->hd", p, vx[r, j0:j0 + split]))
        mx = torch.stack(ms).amax(0)
        w = [torch.exp2(m - mx) for m in ms]
        den = torch.clamp_min(sum(wj * lj for wj, lj in zip(w, ls)), 1e-30)
        out[r] = sum(wj[:, None] * oj for wj, oj in zip(w, os_)) / den[:, None]
    return out[:, None]


@pytest.mark.parametrize("skv,lens", [(256, [1, 17, 255, 256]), (1500, [0, 1500, 700]),
                                      (300, [0, 1, 300, 150])])
def test_decode_split_merge_matches_the_plain_version(skv, lens):
    rng = np.random.default_rng(skv)
    b, hq, hkv, d = len(lens), 8, 2, 32
    q = _t(rng.standard_normal((b, 1, hq, d)).astype(np.float32))
    k = _t(rng.standard_normal((b, skv, hkv, d)).astype(np.float32))
    v = _t(rng.standard_normal((b, skv, hkv, d)).astype(np.float32))
    kvl = _t(np.asarray(lens, np.int32))
    split = dec_plan(b, skv, hq, hkv).split
    got = _dec_split_model(q, k, v, kvl, d ** -0.5, split)
    want = flash_mha_plain(q, k, v, None, kvl)
    _close(got.numpy(), want.numpy())
    for r, n in enumerate(lens):
        if n == 0:                                    # a slot with no key: 0
            assert torch.all(got[r] == 0)


def test_flash_launch_args_refuse_what_the_decode_and_prefill_kernels_do_not_take():
    q1 = torch.empty((4, 1, 16, 64), dtype=torch.bfloat16, device="meta")
    ring = _ring(2, 4, 256, 16, 64)
    assert _flash_launch_args(q1, ring, ring).variant == "dec"
    wide = torch.empty((4, 256, 16, 72), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="16 bytes at a time"):      # base off 16 bytes
        _flash_launch_args(q1, wide[..., 1:65], ring)
    with pytest.raises(ValueError, match="unit stride"):
        _flash_launch_args(q1, torch.empty((4, 256, 64, 16), dtype=torch.bfloat16,
                                           device="meta").transpose(2, 3), ring)
    qp = torch.empty((2, 100, 16, 64), dtype=torch.bfloat16, device="meta")
    kp = torch.empty((2, 100, 16, 64), dtype=torch.bfloat16, device="meta")
    assert _flash_launch_args(qp, kp, kp, causal=True).variant == "pf"
    padded = torch.empty((2, 100, 16, 68), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="Hopper kernel's TMA"):     # 136-byte head stride
        _flash_launch_args(qp, padded[..., :64], kp)
    with pytest.raises(ValueError, match="Hopper kernel's TMA"):     # base off 16 bytes
        _flash_launch_args(qp, wide[:2, :100, :, 1:65], kp)
    # what neither kernel takes stays on the tensor-core kernel
    bias1 = torch.empty((4, 16, 1, 256), device="meta")
    assert _flash_launch_args(q1, ring, ring, bias1).variant == "tc"            # a bias
    assert _flash_launch_args(q1, ring, ring, causal=True).variant == "tc"      # a mask at Sq = 1
    assert _flash_launch_args(q1, ring, ring, window=8).variant == "tc"
    q32 = torch.empty((4, 1, 16, 32), dtype=torch.bfloat16, device="meta")
    assert _flash_launch_args(q32, q32, q32).variant == "tc"                   # D = 32
    assert _flash_launch_args(qp, kp, kp, softmax_scale=0.0).variant == "tc"   # scale <= 0
    assert _flash_launch_args(qp, kp, kp, softmax_scale=-0.1).plan is None
    assert _flash_launch_args(q1, ring, ring, softmax_scale=-0.1).variant == "dec"
    q16 = torch.empty((2, 100, 4, 16), dtype=torch.bfloat16, device="meta")
    assert _flash_launch_args(q16, q16, q16, causal=True).variant == "tc"
    f = torch.empty((2, 100, 4, 64), device="meta")
    assert _flash_launch_args(f, f, f, causal=True).variant == "f32"
    assert _flash_launch_args(f[:, :1], f, f).variant == "f32_dec"


# --------------------------------------------------------------------------
# head dims: float32 at every multiple of 8 on the float32 kernels (the
# zoo's 96, 192 and 256 among them), above 256 in either type too; any
# other head dim padded with zero columns
# --------------------------------------------------------------------------
#: (name, b, sq, skv, hq, hkv): the zoo's float32 decode and prefill calls
#: at a small length (phi-3: MHA 32 heads; MLA: 16; recurrentgemma: MQA)
ZOO_F32 = [("decode", 4, 1, 64, 32, 32), ("prefill", 2, 64, 64, 16, 16),
           ("mqa-decode", 2, 1, 64, 16, 1)]


@pytest.mark.parametrize("d", (96, 192, 256))
@pytest.mark.parametrize("case", ZOO_F32, ids=lambda c: c[0])
def test_flash_launch_args_take_float32_at_the_zoos_head_dims(case, d):
    _, b, sq, skv, hq, hkv = case
    q = torch.empty((b, sq, hq, d), device="meta")
    kv = torch.empty((b, skv, hkv, d), device="meta")
    args = _flash_launch_args(q, kv, kv, causal=sq > 1)
    assert args.variant == ("f32" if sq > 1 else "f32_dec")
    assert args.sizes[5] == d == args.head_dim
    assert args.scale == pytest.approx(1.0 / d ** 0.5)


#: (dtype, true head dim, sq, the head dim it launches at): float32 at the
#: next multiple of 8, bf16 at the next head dim its kernel takes
PADDED = [(torch.float32, 20, 64, 24), (torch.float32, 44, 64, 48), (torch.float32, 76, 1, 80),
          (torch.bfloat16, 24, 64, 32), (torch.bfloat16, 48, 64, 64),
          (torch.bfloat16, 80, 64, 96), (torch.bfloat16, 48, 1, 64)]


@pytest.mark.parametrize("dt,d,sq,dp", PADDED,
                         ids=lambda v: str(v).replace("torch.", "") if not isinstance(v, int)
                         else str(v))
def test_flash_launch_args_pad_other_head_dims(dt, d, sq, dp):
    """A head dim no variant takes launches at the next one that does, the
    operands zero-padded, the softmax scale the true head dim's."""
    q = torch.empty((2, sq, 4, d), dtype=dt, device="meta")
    kv = torch.empty((2, 64, 4, d), dtype=dt, device="meta")
    args, qp, kp, vp = _flash_launch(q, kv, kv)
    assert args.sizes[5] == dp and args.head_dim == d
    assert args.variant == variant_for(dt, dp, sq=sq, hq=4, hkv=4)
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == dp
    assert args.scale == pytest.approx(1.0 / d ** 0.5)
    # above 256 the float32 kernel takes the call in either type (bf16
    # widened), at the next multiple of 8
    big = torch.empty((2, sq, 4, 321), dtype=dt, device="meta")
    args = _flash_launch_args(big, big, big)
    assert args.variant == "f32" and args.sizes[5] == 328 and args.head_dim == 321
    assert args.widened == (dt == torch.bfloat16) and args.qkv_is_bf16 == 0


@pytest.mark.parametrize("dt", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("d", (24, 48, 80))
def test_flash_padded_plain_equals_the_plain_version_at_the_true_head_dim(d, dt):
    """What the kernel computes on the padded operands, sliced back, is the
    plain version at the true head dim within 1e-6 (bias, GQA, a key
    length, a causal mask).  Float32 takes every multiple of 8, so there
    the head dim is 4 below ``d``."""
    d = d if dt == torch.bfloat16 else d - 4
    q, k, v, bias = _attn_inputs(2, 24, 24, 4, 2, d, bias_b=1)
    q, k, v = (_t(a).to(dt) for a in (q, k, v))
    kvl = torch.tensor([24, 9], dtype=torch.int32)
    args, qp, kp, vp = _flash_launch(q, k, v, _t(bias), kvl, causal=True)
    assert qp.shape[-1] > d
    got = flash_mha_plain(qp, kp, vp, _t(bias), kvl, causal=True,
                          softmax_scale=args.scale)[..., :d]
    want = flash_mha_plain(q, k, v, _t(bias), kvl, causal=True)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=0, atol=1e-6)
    assert torch.all(flash_mha_plain(qp, kp, vp, _t(bias), kvl, causal=True,
                                     softmax_scale=args.scale)[..., d:] == 0)


# --------------------------------------------------------------------------
# the float32 kernels: the decode plan, head dims above 256 (either type),
# and the split-W matmul at any H (meta tensors, and the plain versions
# against the interpreted Pallas kernels)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("skv", [16, 256, 2048])
@pytest.mark.parametrize("hq,hkv,d", [(16, 1, 256), (32, 32, 96), (16, 16, 192)],
                         ids=("mqa-256", "mha-96", "mha-192"))
def test_f32_dec_plan_does_not_change_with_b(skv, hq, hkv, d):
    """The float32 decode kernel takes the decode kernel's plan: a slot's
    splits from the ring length and the head counts alone, the same at
    every batch size (a slot alone computes what it computes in a batch)."""
    plans = set()
    for b in (1, 2, 4, 7):
        q = torch.empty((b, 1, hq, d), device="meta")
        kv = torch.empty((b, skv, hkv, d), device="meta")
        kvl = torch.empty((b,), dtype=torch.int32, device="meta")
        args = _flash_launch_args(q, kv, kv, None, kvl)
        assert args.variant == "f32_dec" and args.plan == dec_plan(b, skv, hq, hkv)
        assert args.plan.blocks == args.plan.splits * hkv * -(-(hq // hkv) // 16) * b
        plans.add((args.plan.split, args.plan.splits))
    assert len(plans) == 1


@pytest.mark.parametrize("dt", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("sq", (1, 64))
def test_flash_launch_args_take_head_dim_320(dt, sq):
    """Above 256 (Queue 3 item 9): the float32 kernels in either type (bf16
    widened); a causal prefill on the float32 kernel in one panel of all 320
    columns (the paired-warp instance: the logits computed once); a decode
    row on the float32 decode one (a 320-column instance).  At 648 three
    panels of 216 columns (at most 256, each above 128)."""
    q = torch.empty((2, sq, 8, 320), dtype=dt, device="meta")
    kv = torch.empty((2, 100, 2, 320), dtype=dt, device="meta")
    args, qp, kp, vp = _flash_launch(q, kv, kv, causal=sq > 1)
    assert args.sizes[5] == args.head_dim == 320
    if sq > 1:
        assert args.variant == "f32" and args.plan == f32_plan(2, sq, 8, 320)
        assert (args.plan.dv, args.plan.cols, args.plan.panels, args.plan.rows) == \
            (320, 320, 1, 64)
        assert args.plan.blocks == -(-sq // 64) * 8 * 2
    else:
        assert args.variant == "f32_dec" and args.plan == dec_plan(2, 100, 8, 2)
    assert qp.dtype == kp.dtype == vp.dtype == torch.float32
    assert args.widened == (dt == torch.bfloat16) and args.qkv_is_bf16 == 0
    big = torch.empty((2, sq, 8, 648), dtype=dt, device="meta")
    plan = _flash_launch_args(big, big, big, causal=True).plan
    assert plan.panels == 3 and plan.dv == 216 and plan.rows == 64


def test_f32_instances_are_the_c_entry_points():
    """The wrapper owns the float32 kernel's plan; the C entry point only
    launches the instance the plan names.  Its instances (columns, keys a
    tile, query rows a block) are exactly ``F32_INSTANCES``."""
    src = (build.CSRC / "flash_f32.cu").read_text()
    c = [tuple(int(x) for x in m)
         for m in re.findall(r"^\s*F32_INSTANCE\((\d+), (\d+), (\d+)\)\s*$", src, re.M)]
    assert sorted(c) == sorted(fa.F32_INSTANCES)


@pytest.mark.parametrize("sq", (1, 64, 300))
def test_f32_plan_names_an_instance_that_fits(sq):
    """Every head dim the float32 kernel takes (multiples of 8 up to 1,600):
    the plan's instance exists, holds its panel, fits a block's shared
    memory, and its panels cover the head dim (one panel: the head dim
    itself)."""
    for d in range(8, 1601, 8):
        plan = f32_plan(2, sq, 4, d)
        assert (plan.cols, plan.bk, plan.rows) in fa.F32_INSTANCES
        assert plan.dv <= plan.cols and plan.dv % 8 == 0
        assert plan.smem == fa._f32_smem(d, plan.cols, plan.bk, plan.rows, plan.q_smem)
        assert plan.smem <= fa.F32_SMEM_LIMIT
        assert (plan.panels - 1) * plan.dv < d <= plan.panels * plan.dv
        assert (plan.panels == 1) == (plan.dv == d)
        assert plan.blocks == -(-sq // plan.rows) * 4 * 2 * plan.panels


#: (H, bits, W type, D, the variant): bf16 at H = 640 and H = 48 (bits 4),
#: which the bf16 kernels do not take, on the split-W kernel (one part)
MATMUL_ANY_H = [(640, 4, torch.bfloat16, 128, "wide"), (48, 4, torch.bfloat16, 128, "wide"),
                (640, 8, torch.bfloat16, 96, "wide"), (50, 4, torch.bfloat16, 64, "wide"),
                (640, 4, torch.float32, 128, "f32"), (48, 4, torch.float32, 4, "f32"),
                (512, 4, torch.bfloat16, 4, "tc"), (512, 4, torch.bfloat16, 128, "wg")]


@pytest.mark.parametrize("h,bits,dt,d,variant", MATMUL_ANY_H,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_matmul_launch_args_take_any_h(h, bits, dt, d, variant):
    t = 300
    hp = (h + 1) // 2 if bits == 4 else h
    meta = dict(device="meta")
    args = tmm._matmul_launch_args(
        torch.empty((t, hp), dtype=torch.int8, **meta), torch.empty((t, 1), **meta),
        torch.empty((t, 4), dtype=torch.bfloat16, **meta),
        torch.empty((t, 4), dtype=torch.int32, **meta), torch.empty((h, d), dtype=dt, **meta),
        bits=bits, out_dtype=dt)
    assert args.variant == variant == tmm.variant_for(dt, h, d, bits)
    assert (args.t, args.h, args.d, args.k) == (t, h, d, 4)


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_flash_plain_matches_pallas_at_head_dim_320(dt):
    """D = 320 against the interpreted Pallas kernel: the wrapper's CPU
    result, and the plain version on the operands the launch takes (bf16
    widened to float32, the output rounded once)."""
    q, k, v, bias = _attn_inputs(2, 20, 24, 4, 2, 320, bias_b=1, seed=9)
    kvl = np.asarray([24, 11], np.int32)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    want = flash_mha_pallas(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(bias),
                            jnp.asarray(kvl), causal=True, block_q=16, block_k=16,
                            interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (_t(a).to(tdt) for a in (q, k, v))
    got = flash_mha_kernel(tq, tk, tv, _t(bias), _t(kvl), causal=True)
    rtol = 1e-5 if dt == "f32" else 2.0 ** -7
    _close(got.float().numpy(), want, rtol=rtol)
    args, qp, kp, vp = _flash_launch(tq, tk, tv, _t(bias), _t(kvl), causal=True)
    assert args.variant == "f32" and qp.dtype == torch.float32
    launched = flash_mha_plain(qp, kp, vp, _t(bias), _t(kvl), causal=True,
                               softmax_scale=args.scale).to(tdt)
    _close(launched.float().numpy(), want, rtol=rtol)


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_aaq_matmul_plain_matches_pallas_at_h_640(dt):
    """H = 640 (above the bf16 kernels' 512) against the interpreted Pallas
    kernel, bits 4 with 4 outliers, W and y in either type."""
    t, h, d = 40, 640, 96
    x = _activations(t, h, seed=640)
    w = (np.random.default_rng(7).standard_normal((h, d)) / np.sqrt(h)).astype(np.float32)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    q, s, ov, oi = (np.asarray(a) for a in jax_quant_ref(jnp.asarray(x), 4, 4))
    want = aaq_matmul_pallas(jnp.asarray(q), jnp.asarray(s), jnp.asarray(ov), jnp.asarray(oi),
                             jnp.asarray(w).astype(jdt), bits=4, block_t=32, block_d=64,
                             out_dtype=jdt, interpret=True)
    got = aaq_matmul_kernel(_t(q), _t(s), _t(ov.astype(np.float32)).to(torch.bfloat16),
                            _t(oi), _t(w).to(tdt), bits=4, out_dtype=tdt)
    assert got.dtype == tdt and tmm.variant_for(tdt, h, d, 4) == ("f32" if dt == "f32" else "wide")
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           rtol=1e-5 if dt == "f32" else 2.0 ** -7)


def test_split_w_parts_sum_to_w_exactly():
    """The float32 matmul's three bf16 parts of W sum to W exactly (in
    float64, and in float32 in order), so the plain version on their sum is
    bitwise the plain version on W, and the three parts' products summed
    agree with it within float32 rounding."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((128, 96)) * np.exp(rng.uniform(-8, 8, (128, 96)))).astype(np.float32)
    tw = _t(w)
    parts = tmm.split_w(tw)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    assert torch.equal(sum(p.double() for p in parts), tw.double())
    summed = (parts[0].float() + parts[1].float()) + parts[2].float()
    assert torch.equal(summed, tw)
    x = _activations(64, 128, seed=12)
    q, s, ov, oi = (np.asarray(a) for a in jax_quant_ref(jnp.asarray(x), 4, 4))
    ops = (_t(q), _t(s), _t(ov.astype(np.float32)).to(torch.bfloat16), _t(oi))
    whole = tmm.aaq_matmul_ref(*ops, tw, bits=4)
    assert torch.equal(tmm.aaq_matmul_ref(*ops, summed, bits=4), whole)
    by_part = sum(tmm.aaq_matmul_ref(*ops, p.float(), bits=4) for p in parts)
    _close(by_part.numpy(), whole.numpy())
