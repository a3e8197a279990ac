"""CPU parity of ``repro_torch.core`` and the parameter bridge with the JAX
reference (``repro.core``).

The same numpy inputs go through both packages.  Tolerances:
  * bitwise: int4 pack/unpack (all 256 bytes), quantize (inliers, scales,
    outlier values and indices, dequantize) on f32 and bf16 inputs including
    ties, the policy of every site, the bridge round trip;
  * rtol/atol 1e-5: the float32 products (qmatmul, scheme linears, the
    five comparison schemes' linears), which both sides sum in a different
    order; the comparison schemes' ``act`` and ``weight`` are bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs import reduce_ppm_config as jax_reduce_cfg  # noqa: E402
from repro.models.ppm import init_ppm as jax_init_ppm  # noqa: E402
from repro.models.ppm import pair_activation_inventory as jax_inventory  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import reduce_ppm_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.ppm import init_ppm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of a
    thread per core in each of them oversubscribes the CPU many times."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    """numpy (incl. bfloat16) -> torch CPU tensor, bit for bit."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, (a.shape, b.shape)
    if a.dtype.kind == "f" or a.dtype == ml_dtypes.bfloat16:
        view = {2: np.uint16, 4: np.uint32}[a.dtype.itemsize]
        a, b = a.view(view), b.view(view)
    np.testing.assert_array_equal(a, b)


def _activations(rows, h, seed):
    """Random activations with the hard cases: all-zero (padded) tokens,
    ties on the largest |x|, equal magnitudes of opposite sign."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, h)) * 2).astype(np.float32)
    x[0] = 0.0
    x[1, : h // 2] = 1.5
    x[2, 3], x[2, 7] = 4.0, -4.0
    x[3, 5] = 60.0
    x[4] = np.round(x[4])                       # many exact ties
    return x


# --------------------------------------------------------------------------
# qtensor
# --------------------------------------------------------------------------
def test_unpack_int4_all_256_bytes():
    p = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    ju = np.asarray(jcore.unpack_int4(jnp.asarray(p)))
    tu = tcore.unpack_int4(_t(p)).numpy()
    np.testing.assert_array_equal(ju, tu)
    assert tu.min() == -8 and tu.max() == 7
    np.testing.assert_array_equal(tcore.pack_int4(_t(tu)).numpy(), p)


def test_pack_int4_matches_reference():
    q = np.random.default_rng(0).integers(-8, 8, (7, 64)).astype(np.int8)
    np.testing.assert_array_equal(np.asarray(jcore.pack_int4(jnp.asarray(q))),
                                  tcore.pack_int4(_t(q)).numpy())
    with pytest.raises(ValueError):
        tcore.pack_int4(_t(q[:, :3]))


# --------------------------------------------------------------------------
# quantize
# --------------------------------------------------------------------------
@pytest.mark.parametrize("h", [32, 33, 128])
@pytest.mark.parametrize("bits,k", [(4, 4), (8, 4), (4, 0), (8, 0)])
def test_quantize_bitwise_f32(h, bits, k):
    x = _activations(41, h, seed=h * 10 + bits + k)
    jq = jcore.quantize(jnp.asarray(x), bits, k)
    tq = tcore.quantize(_t(x), bits, k)
    for f in ("inliers", "scales", "outlier_values", "outlier_idx"):
        _bits_equal(np.asarray(getattr(jq, f)), _np(getattr(tq, f)))
    assert (tq.bits, tq.k_outliers, tq.feature_dim) == (bits, k, h)
    assert tq.nbytes() == jq.nbytes()
    _bits_equal(np.asarray(jcore.dequantize(jq)), tcore.dequantize(tq).numpy())
    _bits_equal(np.asarray(jcore.fake_quant(jnp.asarray(x), bits, k)),
                tcore.fake_quant(_t(x), bits, k).numpy())
    np.testing.assert_allclose(float(jcore.quant_rmse(jnp.asarray(x), bits, k)),
                               float(tcore.quant_rmse(_t(x), bits, k)), rtol=1e-6)


@pytest.mark.parametrize("bits,k", [(4, 4), (8, 0)])
def test_quantize_bitwise_bf16(bits, k):
    x = _activations(19, 64, seed=7).astype(ml_dtypes.bfloat16)
    jq = jcore.quantize(jnp.asarray(x), bits, k)
    tq = tcore.quantize(_t(x), bits, k)
    for f in ("inliers", "scales", "outlier_values", "outlier_idx"):
        _bits_equal(np.asarray(getattr(jq, f)), _np(getattr(tq, f)))
    _bits_equal(np.asarray(jcore.dequantize(jq)), _np(tcore.dequantize(tq)))


def test_topk_ties_go_to_lower_index():
    x = torch.tensor([[0.0, 2.0, -2.0, 1.0, 2.0, 0.0]])
    from repro_torch.core.quantize import topk_lower_index
    assert topk_lower_index(x.abs(), 4).tolist() == [[1, 2, 4, 3]]
    _, jidx = jax.lax.top_k(jnp.abs(jnp.asarray(x.numpy())), 4)
    assert np.asarray(jidx).tolist() == [[1, 2, 4, 3]]


# --------------------------------------------------------------------------
# policy
# --------------------------------------------------------------------------
def _all_sites():
    sites = {s for s, _ in jax_inventory(jax_reduce_cfg(), 8)}
    for sc in ("tri_mul_out", "tri_mul_in", "tri_attn_start", "tri_attn_end", "pair_trans"):
        sites |= {f"{sc}.gate", f"{sc}.probs", f"{sc}.residual", f"{sc}.ab"}
    return sorted(sites | {"unnamed", ""})


def test_site_table_copied_exactly():
    jt = [(p, (g.bits, g.k_outliers, g.name)) for p, g in jcore.policy.DEFAULT_SITE_TABLE]
    tt = [(p, (g.bits, g.k_outliers, g.name)) for p, g in tcore.policy.DEFAULT_SITE_TABLE]
    assert jt == tt
    for name in ("GROUP_A", "GROUP_B", "GROUP_C", "NO_QUANT"):
        jg, tg = getattr(jcore, name), getattr(tcore, name)
        assert (jg.bits, jg.k_outliers, jg.name) == (tg.bits, tg.k_outliers, tg.name)


@pytest.mark.parametrize("site", _all_sites())
def test_policy_for_every_site(site):
    for jcfg, tcfg in (
        (jcore.AAQConfig(), tcore.AAQConfig()),
        (jcore.DISABLED, tcore.DISABLED),
        (jcore.AAQConfig(overrides={site: jcore.GROUP_A}),
         tcore.AAQConfig(overrides={site: tcore.GROUP_A})),
    ):
        jp, tp = jcfg.policy_for(site), tcfg.policy_for(site)
        assert (jp.bits, jp.k_outliers, jp.name, jp.enabled) == \
               (tp.bits, tp.k_outliers, tp.name, tp.enabled)
        assert jp.bits_per_value(128) == tp.bits_per_value(128)


def test_act_bytes_match_over_inventory():
    """Every scheme of the reference's zoo is registered in the port and
    prices the pair inventory identically (admission prices from it)."""
    cfg = jax_reduce_cfg()
    assert list(tcore.SCHEMES) == list(jcore.SCHEMES)
    for name in jcore.SCHEMES:
        js, ts = jcore.make_scheme(name), tcore.make_scheme(name)
        assert ts.name == js.name == name
        for site, shape in jax_inventory(cfg, 48, batch=2):
            assert js.act_bytes(site, shape) == ts.act_bytes(site, shape)
            assert js.act_bits(site, shape[-1]) == ts.act_bits(site, shape[-1])
        assert js.weight_bits() == ts.weight_bits()
    for make in (jcore.make_scheme, tcore.make_scheme):
        with pytest.raises(KeyError):
            make("no_such_scheme")


# --------------------------------------------------------------------------
# qmatmul and scheme linears (float32 sums in another order: 1e-5)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bits,k", [(4, 4), (8, 4), (4, 0)])
def test_qmatmul_matches_reference(bits, k):
    rng = np.random.default_rng(bits + k)
    x = _activations(3 * 11, 32, seed=5).reshape(3, 11, 32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    jy = np.asarray(jcore.qmatmul_fused_ref(jnp.asarray(x), jnp.asarray(w), bits, k))
    ty = tcore.qmatmul_fused_ref(_t(x), _t(w), bits, k).numpy()
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5 * np.abs(jy).max())


@pytest.mark.parametrize("name", ["baseline_fp16", "lightnobel_aaq"])
@pytest.mark.parametrize("site", ["tri_mul_out.post_ln", "pair_trans.proj_in"])
def test_scheme_linear_and_act_match_reference(name, site):
    rng = np.random.default_rng(3)
    x = _activations(2 * 9, 32, seed=9).reshape(2, 9, 32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    js, ts = jcore.make_scheme(name), tcore.make_scheme(name)
    jy = np.asarray(js.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), site))
    ty = ts.linear(_t(x), _t(w), _t(b), site).numpy()
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5 * np.abs(jy).max())
    _bits_equal(np.asarray(js.act(jnp.asarray(x), site)), ts.act(_t(x), site).numpy())


COMPARISON_SCHEMES = ["smoothquant", "llm_int8", "ptq4protein", "tender", "mefold"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", COMPARISON_SCHEMES)
def test_comparison_scheme_matches_reference(name, dtype):
    """The five comparison schemes, plain PyTorch against the reference's
    jnp code on the same input: ``act`` and ``weight`` bitwise (the same
    divisions, half-to-even rounding and clips; no exception was needed),
    ``linear`` allclose 1e-5 (float32 sums in another order; SmoothQuant's
    smoothing factor is a float power on both sides).  The input has an
    outlier channel above LLM.int8's threshold and a (2, 9) token grid,
    so token-, channel- and tensor-wide scales all differ."""
    rng = np.random.default_rng(17)
    x = 3 * _activations(2 * 9, 32, seed=19).reshape(2, 9, 32)
    x[..., 5] += 9.0
    w = (rng.standard_normal((32, 16)) / 4).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    if dtype == "bfloat16":
        x, w, b = (a.astype(ml_dtypes.bfloat16) for a in (x, w, b))
    js, ts = jcore.make_scheme(name), tcore.make_scheme(name)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    tx, tw, tb = _t(x), _t(w), _t(b)
    _bits_equal(np.asarray(js.act(jx, "tri_mul_out.ab")), _np(ts.act(tx, "tri_mul_out.ab")))
    _bits_equal(np.asarray(js.weight(jw)), _np(ts.weight(tw)))
    jy = np.asarray(js.linear(jx, jw, jb, "tri_mul_out.post_ln")).astype(np.float32)
    ty = ts.linear(tx, tw, tb, "tri_mul_out.post_ln").float().numpy()
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5 * np.abs(jy).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", ["tri_mul_out.pre_ln", "tri_attn_end.post_ln",
                                  "tri_mul_in.ab", "pair_trans.proj_in", "seq.none"])
def test_scheme_act_same_bits_on_every_backend(site, dtype):
    """``AAQScheme.act`` routes through ``dispatch.fake_quant``: ``auto`` and
    ``ref`` take the reference dataflow on the CPU, ``kernel`` the
    aaq_fake_quant kernel's plain version; all three give the JAX act's bits
    (groups A, B and C, and a site the override disables)."""
    from repro_torch.kernels import dispatch
    x = _activations(3 * 7, 128, seed=21).reshape(3, 7, 128)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    cfg = dict(overrides={"seq.none": jcore.NO_QUANT})
    js = jcore.schemes.AAQScheme(cfg=jcore.AAQConfig(**cfg))
    ts = tcore.schemes.AAQScheme(cfg=tcore.AAQConfig(
        overrides={"seq.none": tcore.NO_QUANT}))
    want = np.asarray(js.act(jnp.asarray(x), site))
    enabled = ts.cfg.policy_for(site).enabled
    dispatch.reset_counters()
    for backend in ("auto", "ref", "kernel"):
        with dispatch.use_backend(backend):
            got = ts.act(_t(x), site)
        assert got.dtype == _t(x).dtype
        _bits_equal(want, _np(got))
    assert dispatch.counters["fakequant.ref"] == 2 * enabled
    assert dispatch.counters["fakequant.kernel"] == enabled
    assert dispatch.plain_counts()["aaq_fake_quant"] == enabled
    dispatch.reset_counters()


# --------------------------------------------------------------------------
# parameter bridge and device policy
# --------------------------------------------------------------------------
def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_every_leaf(dtype):
    import dataclasses
    jcfg = dataclasses.replace(jax_reduce_cfg(), dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, jax_init_ppm(jax.random.PRNGKey(0), jcfg))
    cfg = dataclasses.replace(reduce_ppm_config(), dtype=dtype)
    params = params_from_numpy(tree, cfg, device="cpu")
    assert len(params["trunk"]) == cfg.blocks
    assert params["trunk"][1]["tri_mul_out"]["a_proj"]["w"].shape == (cfg.hz, cfg.tri_hidden)
    back = params_to_numpy(params)
    jl, bl = dict(_leaf_paths(tree)), dict(_leaf_paths(back))
    assert jl.keys() == bl.keys()
    for path in jl:
        _bits_equal(jl[path], bl[path])
    # block i of the port is slice i of the reference's stacked trunk
    _bits_equal(tree["trunk"]["opm"]["out"]["w"][1],
                _np(params["trunk"][1]["opm"]["out"]["w"]))


def test_init_layout_matches_reference():
    jcfg, cfg = jax_reduce_cfg(), reduce_ppm_config()
    tree = jax.tree_util.tree_map(np.asarray, jax_init_ppm(jax.random.PRNGKey(0), jcfg))
    mine = init_ppm(cfg, seed=0, device="cpu")
    ref = dict(_leaf_paths(params_to_numpy(params_from_numpy(tree, cfg, device="cpu"))))
    got = dict(_leaf_paths(params_to_numpy(mine)))
    assert ref.keys() == got.keys()
    for path in ref:
        assert ref[path].shape == got[path].shape and ref[path].dtype == got[path].dtype, path
    from repro.models import common as jcm
    assert cm.count_params(mine) == jcm.count_params(tree)
    assert cm.param_bytes(mine) == jcm.param_bytes(tree)
    again = init_ppm(cfg, seed=0, device="cpu")
    _bits_equal(_np(mine["trunk"][0]["seq_attn"]["qkv"]["w"]),
                _np(again["trunk"][0]["seq_attn"]["qkv"]["w"]))


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        init_ppm(reduce_ppm_config(), seed=0)
    with pytest.raises(RuntimeError):
        params_from_numpy({"trunk": {}}, reduce_ppm_config())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
