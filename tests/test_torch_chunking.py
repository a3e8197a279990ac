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
