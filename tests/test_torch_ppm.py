"""CPU parity of the port's folding model with the JAX reference, on the
reduced float32 config with the reference's own parameters (bridged).

Gates:
  * building blocks (layernorm, dense, masks, structural metrics): 1e-5;
  * ``ppm_forward`` under ``baseline_fp16``: allclose 1e-4 (float32 sums in
    another order), B in {1, 2}, masked and unmasked — as
    ``tests/test_chunking.py`` holds the chunked trunk;
  * ``ppm_forward`` under ``lightnobel_aaq``: TM-score >= 0.995 per protein.
    AAQ is not bitwise across frameworks: a float32 sum in another order
    moves a value across a 4-bit rounding boundary now and then, and the two
    JAX routes differ from each other by as much.  Lengths are 56-64 so that
    TM's d0 (2.5-2.7 A) is not clamped to its 0.5 A floor, where TM reads
    sub-angstrom noise as misfolding.
  Both routes of triangular attention are held: JAX ``auto`` (einsum at
  N < 256 on the CPU) against the port's CPU default, and JAX
  ``use_backend("pallas")`` (interpreted kernels, rows-as-batch flash)
  against the port's ``kernel`` mode (the same dataflow through the plain
  versions).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduce_ppm_config as jax_reduce_cfg  # noqa: E402
from repro.core import make_scheme as jax_make_scheme  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models.ppm import init_ppm as jax_init_ppm  # noqa: E402
from repro.models.ppm import model as jmodel  # noqa: E402
from repro.models.ppm import structure as jst  # noqa: E402
from repro.models.ppm import trunk as jtrunk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_ppm_config, reduce_ppm_config  # noqa: E402
from repro_torch.core import make_scheme  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.ppm import model as tmodel  # noqa: E402
from repro_torch.models.ppm import structure as tst  # noqa: E402
from repro_torch.models.ppm import trunk as ttrunk  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of a
    thread per core in each of them oversubscribes the CPU many times."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


CFG = reduce_ppm_config()
JCFG = jax_reduce_cfg()


@functools.lru_cache(maxsize=None)
def _params():
    """The reference's parameters and the port's bridged copy (made on first
    use, not at import: every test worker imports this module)."""
    jparams = jax_init_ppm(jax.random.PRNGKey(0), JCFG)
    return jparams, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), CFG,
                                      device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(b, n, masked, seed):
    rng = np.random.default_rng(seed)
    aat = rng.integers(0, 21, (b, n)).astype(np.int32)
    mask = np.ones((b, n), bool)
    if masked:
        for i in range(b):
            mask[i, n - 8 * (i + 1):] = False     # contiguous padded suffix
    return aat, mask


def _jax_forward(scheme, aat, mask, route):
    with jax_dispatch.use_backend(route):
        out = jmodel.ppm_forward(_params()[0], jnp.asarray(aat), JCFG, jax_make_scheme(scheme),
                                 mask=None if mask is None else jnp.asarray(mask))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_forward(scheme, aat, mask, route):
    with dispatch.use_backend(route):
        out = tmodel.ppm_forward(_params()[1], _t(aat), CFG, make_scheme(scheme),
                                 mask=None if mask is None else _t(mask))
    return {k: v.numpy() for k, v in out.items()}


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------
def test_layernorm_dense_and_masks_match_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 32)) * 3 + 1).astype(np.float32)
    p = {"g": rng.standard_normal(32).astype(np.float32),
         "b": rng.standard_normal(32).astype(np.float32)}
    want = np.asarray(jcm.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = cm.layernorm({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    d = {"w": rng.standard_normal((32, 7)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    np.testing.assert_allclose(
        cm.dense({k: _t(v) for k, v in d.items()}, _t(x)).numpy(),
        np.asarray(jcm.dense({k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    mask = np.array([[True, True, False], [True, False, False]])
    np.testing.assert_array_equal(cm.key_padding_bias(_t(mask)).numpy(),
                                  np.asarray(jcm.key_padding_bias(jnp.asarray(mask))))
    assert cm.NEG_INF == jcm.NEG_INF == -1e9


def test_structural_metrics_match_reference():
    rng = np.random.default_rng(1)
    P = rng.standard_normal((40, 3)).astype(np.float32) * 5
    Q = P @ np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32).T \
        + rng.standard_normal((40, 3)).astype(np.float32) * 0.3
    for name in ("kabsch_align", "tm_score", "rmsd"):
        want = np.asarray(getattr(jst, name)(jnp.asarray(P), jnp.asarray(Q)))
        got = getattr(tst, name)(_t(P), _t(Q)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_inventory_and_score_shape_match_reference():
    for ns, batch in ((32, 1), (256, 2)):
        assert tmodel.pair_activation_inventory(CFG, ns, batch) == \
            jmodel.pair_activation_inventory(JCFG, ns, batch)
        assert tmodel.score_tensor_shape(CFG, ns, batch) == \
            jmodel.score_tensor_shape(JCFG, ns, batch)
    full = get_ppm_config()
    assert (full.blocks, full.hm, full.hz, full.seq_heads, full.pair_heads, full.dtype) == \
        (48, 1024, 128, 16, 4, "bfloat16")
    assert full.torch_dtype == torch.bfloat16 and ttrunk.CHUNKED_ATTN_LEN == 256


def test_tri_attn_both_dataflows_agree_under_fp():
    """The rows-as-batch flash dataflow and the einsum dataflow compute the
    same function when nothing is quantized (AAQ quantizes probs only in
    the einsum branch)."""
    rng = np.random.default_rng(2)
    z = _t(rng.standard_normal((2, 12, 12, CFG.hz)).astype(np.float32))
    mask = torch.ones(2, 12, dtype=torch.bool)
    mask[1, 9:] = False
    p = _params()[1]["trunk"][0]["tri_attn_end"]
    fp = make_scheme("baseline_fp16")
    with dispatch.use_backend("ref"):
        a = ttrunk.tri_attn_apply(p, z, fp, False, "tri_attn_end", CFG.pair_heads, mask=mask)
    with dispatch.use_backend("kernel"):
        b = ttrunk.tri_attn_apply(p, z, fp, False, "tri_attn_end", CFG.pair_heads, mask=mask)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
    jp = jax.tree_util.tree_map(lambda x: x[0], _params()[0]["trunk"])["tri_attn_end"]
    want = jtrunk.tri_attn_apply(jp, jnp.asarray(z.numpy()), jax_make_scheme("baseline_fp16"),
                                 False, "tri_attn_end", CFG.pair_heads,
                                 mask=jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# whole forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b,masked", [(1, False), (1, True), (2, False), (2, True)])
def test_fp_forward_allclose(b, masked):
    aat, mask = _case(b, 24, masked, seed=b)
    m = mask if masked else None
    want = _jax_forward("baseline_fp16", aat, m, "auto")
    got = _port_forward("baseline_fp16", aat, m, "auto")
    for key in ("coords", "distogram", "s", "z"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("routes", [("auto", "auto"), ("pallas", "kernel")],
                         ids=["einsum-route", "kernel-route"])
@pytest.mark.parametrize("b,masked", [(1, False), (2, True)])
def test_aaq_forward_tm(routes, b, masked):
    aat, mask = _case(b, 64, masked, seed=10 + b)
    m = mask if masked else None
    want = _jax_forward("lightnobel_aaq", aat, m, routes[0])
    got = _port_forward("lightnobel_aaq", aat, m, routes[1])
    for i in range(b):
        n = int(mask[i].sum())
        tm = float(tst.tm_score(_t(got["coords"][i, :n]), _t(want["coords"][i, :n])))
        assert tm >= 0.995, (i, tm)
    assert np.isfinite(got["distogram"]).all()


def test_kernel_route_reaches_every_kernel_plain_version():
    aat, mask = _case(1, 16, True, seed=3)
    dispatch.reset_counters()
    _port_forward("lightnobel_aaq", aat, mask, "kernel")
    plain = dispatch.plain_counts()
    blocks = CFG.blocks
    # per block: 22 quantized pair linears, 23 fake-quant sites (7 in each
    # tri_mul, 3 in each tri_attn on the rows-as-batch route, 3 in
    # pair_trans), seq attention + 2 triangular attentions; then one
    # attention per structure-module iteration
    assert plain == {"aaq_quantize": 22 * blocks, "aaq_fake_quant": 23 * blocks,
                     "aaq_matmul": 22 * blocks, "flash_mha": 3 * blocks + CFG.ipa_iters}
    assert dispatch.counters["attention.ref"] == 0 and dispatch.counters["qmatmul.ref"] == 0
    assert dispatch.counters["fakequant.ref"] == 0
    dispatch.reset_counters()


def test_bf16_forward_runs_and_stays_close_to_f32():
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, _params()[0]), cfg,
                               device="cpu", dtype=torch.bfloat16)
    aat, mask = _case(1, 64, True, seed=4)
    with dispatch.use_backend("kernel"):
        out = tmodel.ppm_forward(params, _t(aat), cfg, make_scheme("lightnobel_aaq"),
                                 mask=_t(mask))
    ref = _port_forward("baseline_fp16", aat, mask, "auto")
    n = int(mask[0].sum())
    assert out["z"].dtype == torch.bfloat16 and torch.isfinite(out["coords"]).all()
    tm = float(tst.tm_score(out["coords"][0, :n], _t(ref["coords"][0, :n])))
    assert tm >= 0.95, tm
