"""The port's row-chunked trunk (``repro_torch/models/ppm/chunking.py``) and
the long-fold planner's arithmetic, against the unchunked port and the JAX
reference on the CPU.

Gates:
  * ``effective_chunk_size``, ``chunk_candidates`` and ``parse_chunk_spec``
    give the reference's answers exactly (framework-free arithmetic);
  * chunked vs unchunked port, ``baseline_fp16``: allclose 1e-4 (only a
    matmul's blocking over fewer rows can move a last bit), on several
    (B, N, chunk) cases, one with N prime (the chunk degrades to 1), on both
    triangular-attention dataflows (einsum, and rows-as-batch through the
    kernels' plain versions);
  * chunked vs unchunked port, ``lightnobel_aaq``: TM-score >= 0.995 at
    N >= 56 (a last-bit difference upstream can flip a 4-bit bin);
  * the port's chunked forward vs the JAX chunked forward on the same
    bridged parameters: FP allclose 1e-4, AAQ TM >= 0.995.
The config is one block at narrow widths: every chunked op runs, and the
file stays well inside a minute on one worker.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_scheme as jax_make_scheme  # noqa: E402
from repro.models.ppm import init_ppm as jax_init_ppm  # noqa: E402
from repro.models.ppm import ppm_forward as jax_ppm_forward  # noqa: E402
from repro.models.ppm.chunking import effective_chunk_size as jax_effective_chunk_size  # noqa: E402
from repro.models.ppm.trunk import PPMConfig as JaxPPMConfig  # noqa: E402
from repro.serving.longfold import chunk_candidates as jax_chunk_candidates  # noqa: E402
from repro.serving.longfold import parse_chunk_spec as jax_parse_chunk_spec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import make_scheme  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models.ppm import ppm_forward, tm_score  # noqa: E402
from repro_torch.models.ppm.chunking import effective_chunk_size  # noqa: E402
from repro_torch.models.ppm.trunk import PPMConfig  # noqa: E402
from repro_torch.serving.longfold import (AUTO, FIXED, MIN_CHUNK, OFF,  # noqa: E402
                                          chunk_candidates, parse_chunk_spec)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; torch's default of a
    thread per core in each of them oversubscribes the CPU many times."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_TINY = dict(blocks=1, hm=32, hz=16, seq_heads=2, pair_heads=2, tri_hidden=16,
             vocab=23, recycles=1, ipa_iters=1, dtype="float32")
CFG, JCFG = PPMConfig(**_TINY), JaxPPMConfig(**_TINY)


@functools.lru_cache(maxsize=None)
def _params():
    jparams = jax_init_ppm(jax.random.PRNGKey(0), JCFG)
    return jparams, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), CFG,
                                      device="cpu")


def _case(b: int, n: int):
    """(aatype, ragged mask, lengths): row i keeps n - 5*i real tokens."""
    rng = np.random.default_rng(1000 * b + n)
    aat = rng.integers(0, 20, (b, n)).astype(np.int32)
    lens = [n - 5 * i for i in range(b)]
    mask = np.zeros((b, n), bool)
    for i, ln in enumerate(lens):
        mask[i, :ln] = True
    return aat, mask, lens


@functools.lru_cache(maxsize=None)
def _port(scheme: str, b: int, n: int, chunk: int, route: str):
    aat, mask, _ = _case(b, n)
    with torch.inference_mode(), dispatch.use_backend(route):
        out = ppm_forward(_params()[1], torch.from_numpy(aat), CFG, make_scheme(scheme),
                          mask=torch.from_numpy(mask), chunk_size=chunk or None)
    return {k: v.numpy() for k, v in out.items()}


def _tm_rows(got, want, lens):
    return [float(tm_score(torch.from_numpy(np.array(got[i, :ln])),
                           torch.from_numpy(np.array(want[i, :ln]))))
            for i, ln in enumerate(lens)]


# --------------------------------------------------------------------------
# planner arithmetic, exactly the reference's
# --------------------------------------------------------------------------
def test_chunk_arithmetic_matches_reference():
    for n in range(1, 301):
        for c in sorted({1, 2, 3, 7, 8, 16, 24, 31, 64, 100, 128, n - 1, n, n + 5} - {0}):
            assert effective_chunk_size(n, c) == jax_effective_chunk_size(n, c), (n, c)
        for floor in (MIN_CHUNK, 1, 4):
            assert chunk_candidates(n, floor) == jax_chunk_candidates(n, floor), (n, floor)
    assert effective_chunk_size(37, 8) == 1                      # prime: chunk 1
    for spec in (None, "off", "OFF", "none", "0", "", " auto ", "AUTO", "64", " 16 ", 64, 1, 0):
        assert parse_chunk_spec(spec) == jax_parse_chunk_spec(spec), spec
    for bad in (-1, "-4", "x", "1.5", 1.5, True):
        with pytest.raises(ValueError):
            parse_chunk_spec(bad)
        with pytest.raises(ValueError):
            jax_parse_chunk_spec(bad)
    assert (OFF, AUTO, FIXED, MIN_CHUNK) == ("off", "auto", "fixed", 16)


# --------------------------------------------------------------------------
# chunked vs unchunked, the port against itself
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b,n,chunk,route", [
    (1, 40, 16, "auto"),         # chunk 8 of 40 (a divisor below 16)
    (2, 37, 8, "auto"),          # 37 is prime: every slab is one row
    (2, 48, 32, "auto"),         # 32 does not divide 48: slabs of 24
    (2, 40, 16, "kernel"),       # rows-as-batch tri-attention, block-broadcast bias
])
def test_chunked_fp_matches_unchunked(b, n, chunk, route):
    want = _port("baseline_fp16", b, n, 0, route)
    got = _port("baseline_fp16", b, n, chunk, route)
    for key in ("coords", "distogram", "s", "z"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)


def test_chunk_of_full_length_is_the_unchunked_path_bitwise():
    """A chunk that degenerates to N runs one slab per op: the same calls
    on the same shapes as the unchunked path."""
    want = _port("baseline_fp16", 2, 32, 0, "auto")
    got = _port("baseline_fp16", 2, 32, 32, "auto")
    for key in ("coords", "z"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("b,n,chunk,route", [(1, 64, 16, "auto"), (2, 56, 8, "kernel")])
def test_chunked_aaq_matches_unchunked_by_tm(b, n, chunk, route):
    want = _port("lightnobel_aaq", b, n, 0, route)
    got = _port("lightnobel_aaq", b, n, chunk, route)
    tms = _tm_rows(got["coords"], want["coords"], _case(b, n)[2])
    assert min(tms) >= 0.995, tms
    assert np.isfinite(got["distogram"]).all()


# --------------------------------------------------------------------------
# the port's chunked forward vs the JAX chunked forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scheme,b,n,chunk", [
    ("baseline_fp16", 2, 40, 16),
    ("lightnobel_aaq", 1, 64, 16),
])
def test_chunked_forward_matches_jax_chunked(scheme, b, n, chunk):
    aat, mask, lens = _case(b, n)
    out = jax_ppm_forward(_params()[0], jnp.asarray(aat), JCFG, jax_make_scheme(scheme),
                          mask=jnp.asarray(mask), chunk_size=chunk)
    want = {k: np.asarray(v) for k, v in out.items()}
    got = _port(scheme, b, n, chunk, "auto")
    if scheme == "baseline_fp16":
        for key in ("coords", "distogram", "s", "z"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                       err_msg=key)
    else:
        tms = _tm_rows(got["coords"], want["coords"], lens)
        assert min(tms) >= 0.995, tms


COMPARISON_SCHEMES = ("smoothquant", "llm_int8", "ptq4protein", "tender", "mefold")


@pytest.mark.parametrize("scheme", COMPARISON_SCHEMES)
def test_comparison_schemes_chunked_match_jax_chunked(scheme):
    """The five comparison schemes take tensor-, channel- or all-token-wide
    statistics, so a slab's scales see the slab: the port's chunked fold
    must slab as the reference's does to see the same statistics.  Held by
    the AAQ gate of ``test_chunked_forward_matches_jax_chunked`` (TM >=
    0.995), at N = 64 in slabs of 16."""
    b, n, chunk = 1, 64, 16
    aat, mask, lens = _case(b, n)
    out = jax_ppm_forward(_params()[0], jnp.asarray(aat), JCFG, jax_make_scheme(scheme),
                          mask=jnp.asarray(mask), chunk_size=chunk)
    got = _port(scheme, b, n, chunk, "auto")
    tms = _tm_rows(got["coords"], np.asarray(out["coords"]), lens)
    assert min(tms) >= 0.995, tms


# --------------------------------------------------------------------------
# the capture-safe forms of the forward's helpers
# --------------------------------------------------------------------------
def test_capture_safe_helpers_match_their_old_forms_bitwise():
    """``key_padding_bias`` builds no tensor from a host value, and the
    per-row key lengths use no ``repeat_interleave`` (whose output size is
    read back from the card): both are bitwise their earlier forms."""
    from repro_torch.models import common as cm
    from repro_torch.models.ppm.trunk import rows_valid_len
    rng = np.random.default_rng(7)
    mask = torch.from_numpy(rng.random((3, 45)) < 0.7)
    old = torch.where(mask, torch.tensor(0.0), torch.tensor(cm.NEG_INF)).float()
    new = cm.key_padding_bias(mask)
    assert new.dtype == old.dtype == torch.float32
    assert torch.equal(new.view(torch.int32), old.view(torch.int32))
    lens = mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    for rows in (1, 7, 45):
        got, want = rows_valid_len(lens, rows), lens.repeat_interleave(rows)
        assert got.dtype == want.dtype and torch.equal(got, want)


# --------------------------------------------------------------------------
# the long fold's memory repair: slabbed stages, bf16 partner, in-place adds
# --------------------------------------------------------------------------
def _pair(b: int, n: int, hz: int, dtype=torch.float32, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, n, n, hz), generator=g).to(dtype)


@pytest.mark.parametrize("stage", ["input_embedding", "structure_pair_bias", "distogram_head"])
@pytest.mark.parametrize("n,chunk", [(40, 16), (37, 8)])
def test_slabbed_stages_match_unslabbed_bitwise(stage, n, chunk):
    """The chunked path builds the input embedding, the structure module's
    pair bias and the distogram head by row slabs (no full-size addend or
    float32 LayerNorm temporary): in f32 on the CPU every element is the
    same arithmetic in the same order, so the slabbed form is bitwise the
    unslabbed one (37 is prime: one-row slabs)."""
    from repro_torch.models.ppm import model as md
    from repro_torch.models.ppm import structure as st
    params = _params()[1]
    if stage == "input_embedding":
        aat = torch.from_numpy(_case(2, n)[0])
        want, got = (md.input_embedding(params, aat, CFG, c) for c in (None, chunk))
    else:
        z = _pair(2, n, CFG.hz)
        fn = ((lambda c: st.pair_bias(params["structure"], z, c)) if stage == "structure_pair_bias"
              else (lambda c: md.distogram_head(params["distogram"], z, c)))
        want, got = fn(None), fn(chunk)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert w.dtype == g.dtype == torch.float32 and w.shape == g.shape
        assert torch.equal(w.view(torch.int32), g.view(torch.int32)), stage


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunked_opm_outer_product_is_the_float32_einsum_rounded(dtype):
    """The chunked OPM forms its outer product in the activations' dtype:
    bitwise the float32 einsum rounded to that dtype (a product of two bf16
    values is exact in float32), and so the chunked OPM is bitwise the
    unchunked one."""
    from repro_torch.models.ppm import chunking as ck
    from repro_torch.models.ppm import trunk as tk
    g = torch.Generator().manual_seed(5)
    a = (torch.randn((2, 9, 32), generator=g) * 3).to(dtype)
    b = (torch.randn((2, 11, 32), generator=g) * 3).to(dtype)
    want = torch.einsum("bic,bjd->bijcd", a.float(), b.float()).to(dtype)
    got = a[:, :, None, :, None] * b[:, None, :, None, :]
    assert got.dtype == dtype and torch.equal(got, want)
    p = _params()[1]["trunk"][0]["opm"]
    s = torch.randn((2, 24, CFG.hm), generator=g)
    assert torch.equal(ck.opm_chunked(p, s, 8), tk.opm_apply(p, s))


@pytest.mark.parametrize("scheme", ["baseline_fp16", "lightnobel_aaq"])
@pytest.mark.parametrize("outgoing", [True, False])
def test_bf16_chunked_tri_mul_matches_float32_product(scheme, outgoing):
    """At bf16 the chunked tri-mul keeps its resident operand in bf16 and
    multiplies bf16 slabs with float32 accumulation; the unchunked op
    multiplies float32 copies.  The inputs are bf16 values, so every product
    is exact and only the summation order differs: at most one bf16 ulp of
    the product, which the LayerNorm and projections carry to the output.
    Tolerance: 2^-6 of the output's largest magnitude (two bf16 ulps)."""
    from repro_torch.models.ppm import chunking as ck
    from repro_torch.models.ppm import trunk as tk
    from repro_torch.models.ppm import init_ppm
    cfg = PPMConfig(**{**_TINY, "dtype": "bfloat16"})
    p = init_ppm(cfg, seed=0, device="cpu")["trunk"][0]
    sc = "tri_mul_out" if outgoing else "tri_mul_in"
    z = _pair(2, 48, cfg.hz, torch.bfloat16)
    mask = torch.from_numpy(_case(2, 48)[1])
    want = tk.tri_mul_apply(p[sc], z, make_scheme(scheme), outgoing, sc, mask=mask)
    got = ck.tri_mul_chunked(p[sc], z, make_scheme(scheme), outgoing, sc, 16, mask=mask)
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max()
    assert float(err) <= 2.0 ** -6 * float(want.float().abs().max()), float(err)


def test_in_place_block_matches_out_of_place_residual_adds_bitwise():
    """``block_apply_chunked`` adds each op's slabs into z in place; the
    residual adds ``z = z + op(z)`` of the same ops give the same bits."""
    from repro_torch.models.ppm import chunking as ck
    from repro_torch.models.ppm import trunk as tk
    params = _params()[1]
    p = params["trunk"][0]
    aat, mask, _ = _case(2, 40)
    mask = torch.from_numpy(mask)
    g = torch.Generator().manual_seed(5)
    s = torch.randn((2, 40, CFG.hm), generator=g)
    z = _pair(2, 40, CFG.hz, seed=6)
    scheme = make_scheme("lightnobel_aaq")
    with torch.inference_mode():
        s1, z1 = ck.block_apply_chunked(p, s, z.clone(), CFG, scheme, 16, mask=mask)
        pb = ck.seq_pair_bias_chunked(p["seq_attn"], z, 16)
        s2 = s + tk.seq_attn_apply(p["seq_attn"], s, z, CFG.seq_heads, mask=mask, pair_bias=pb)
        s2 = s2 + tk.seq_transition_apply(p["seq_trans"], s2)
        z2 = z + ck.opm_chunked(p["opm"], s2, 16)
        z2 = z2 + ck.tri_mul_chunked(p["tri_mul_out"], z2, scheme, True, "tri_mul_out", 16,
                                     mask=mask)
        z2 = z2 + ck.tri_mul_chunked(p["tri_mul_in"], z2, scheme, False, "tri_mul_in", 16,
                                     mask=mask)
        z2 = z2 + ck.tri_attn_chunked(p["tri_attn_start"], z2, scheme, True, "tri_attn_start",
                                      CFG.pair_heads, 16, mask=mask)
        z2 = z2 + ck.tri_attn_chunked(p["tri_attn_end"], z2, scheme, False, "tri_attn_end",
                                      CFG.pair_heads, 16, mask=mask)
        z2 = z2 + ck.pair_transition_chunked(p["pair_trans"], z2, scheme, 16)
    assert torch.equal(s1, s2)
    assert torch.equal(z1.view(torch.int32), z2.view(torch.int32))


def test_chunked_stack_refuses_a_grid():
    """A ``PairGrid`` is not refused any more: the row-chunked stack takes
    the production layout as it takes the serving tier's j split.  On a
    1 x 1 grid, its parameters cut by ``grid_params`` (whole at one rank),
    the chunked trunk is bitwise the single chunked trunk (the multi-rank
    grids: ``test_torch_train_mesh.py``)."""
    from repro_torch.configs import reduce_ppm_config
    from repro_torch.models.ppm import init_ppm
    from repro_torch.models.ppm import trunk as tk
    from repro_torch.parallel import sharding as sh
    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device="cpu")
    local, grid = sh.grid_params(params, sh.PairGrid(None, None, 1, 1, 0, 0, ((0,),)))
    g = torch.Generator().manual_seed(3)
    s, z = torch.randn(1, 16, cfg.hm, generator=g), torch.randn(1, 16, 16, cfg.hz, generator=g)
    scheme = make_scheme("baseline_fp16")
    with torch.no_grad(), sh.sharded(grid, 16):
        got = tk.trunk_apply(local["trunk"], s.clone(), z.clone(), cfg, scheme,
                             chunk_size=8, shard=grid)
    with torch.no_grad():
        want = tk.trunk_apply(params["trunk"], s.clone(), z.clone(), cfg, scheme, chunk_size=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
