"""CPU parity of the port's dense LM (configs, RoPE, transformer, the unified
``models.lm`` API) with the JAX reference, on each dense config reduced to
float32 with the reference's own parameters (bridged).

Gates:
  * ``apply_rope`` at rotary_frac 1.0 and 0.5 (ChatGLM): allclose 1e-6;
  * ``lm_forward`` / ``prefill_fn`` of every dense config: allclose 1e-4
    (float32 sums in another order);
  * ``decode_step`` with the raw and the INT8 cache: logits allclose 1e-4
    over several steps; ``_quant_kv_row`` on identical rows bitwise
    (int8 values and scales).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES as jax_arch_names  # noqa: E402
from repro.configs import LM_SHAPES as jax_lm_shapes  # noqa: E402
from repro.configs import cell_supported as jax_cell_supported  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.configs import shapes_for as jax_shapes_for  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.bridge import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, cell_supported, get_config,  # noqa: E402
                                 reduce_config, shapes_for)
from repro_torch.kernels.aaq_quant.aaq_quant import _launch_shape  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

#: the dense decoder-only configs, the ones ``--mode lm`` serves
DENSE_NAMES = tuple(n for n in ARCH_NAMES if get_config(n).kind == "dense")
#: reference fields that only training reads: the port's ``ArchConfig``
#: carries them since the training slice (``launch/steps.py``, remat)
_TRAINING_FIELDS = ("scan_layers", "train_microbatches")

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(name):
    jcfg = jax_reduce_config(jax_get_config(name)).replace(dtype="float32")
    tcfg = reduce_config(get_config(name)).replace(dtype="float32")
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jp, lm_params_from_numpy(tree, tcfg, device="cpu")


def _fields(cfg) -> dict:
    """Every dataclass field of a config, the training ones included, the
    nested family configs as dicts."""
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(cfg) for v in (getattr(cfg, f.name),)}


def test_dense_configs_match_the_reference_fields():
    """Every config of the zoo (all ten) and its reduced CPU form carry the
    reference's numbers, field for field (the training fields too), with
    the derived properties."""
    assert ARCH_NAMES == tuple(jax_arch_names) and len(ARCH_NAMES) == 10
    assert DENSE_NAMES == tuple(n for n in jax_arch_names
                                if jax_get_config(n).kind == "dense")
    assert {f.name for f in dataclasses.fields(get_config("qwen2.5-3b"))} \
        >= set(_TRAINING_FIELDS)
    for name in ARCH_NAMES:
        j, t = jax_get_config(name), get_config(name)
        for jc, tc in ((j, t), (jax_reduce_config(j), reduce_config(t))):
            assert _fields(tc) == _fields(jc), name
            assert (tc.hd, tc.attention_free, tc.subquadratic) == \
                (jc.hd, jc.attention_free, jc.subquadratic), name
            for shape in jax_lm_shapes:
                assert cell_supported(tc, shape) == jax_cell_supported(jc, shape), name
    assert [dataclasses.asdict(s) for s in shapes_for("qwen2.5-3b") + shapes_for("esmfold_ppm")] \
        == [dataclasses.asdict(s) for s in jax_shapes_for("qwen2.5-3b")
            + jax_shapes_for("esmfold_ppm")]


@pytest.mark.parametrize("name", DENSE_NAMES)
def test_kv_rows_of_every_served_config_take_the_quantize_kernel(name):
    """A KV row (one token's head) is 16-byte aligned in bf16 at every dense
    config's head dim, so ``aaq_quantize`` takes it unpadded."""
    cfg = get_config(name)
    x = torch.empty((4 * cfg.n_kv_heads, cfg.hd), dtype=torch.bfloat16, device="meta")
    assert _launch_shape(x, 4, 0, "kv") == (4 * cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_apply_rope_matches_jax(frac):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    want = np.asarray(jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, frac))
    got = cm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, frac)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # only the leading rotary_frac of the head dim moves
    rot = int(16 * frac)
    np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])


def test_rope_freqs_causal_mask_and_mha_match_jax():
    from repro.kernels.flash_attention.ops import mha as jmha
    from repro_torch.kernels.flash_attention.ops import mha
    for frac in (1.0, 0.5):
        np.testing.assert_allclose(cm.rope_freqs(128, 1e6, frac).numpy(),
                                   np.asarray(jcm.rope_freqs(128, 1e6, frac)), rtol=1e-6)
    for window, off in ((None, 0), (4, 3)):
        np.testing.assert_array_equal(
            cm.causal_mask(5, 9, window=window, q_offset=off).numpy(),
            np.asarray(jcm.causal_mask(5, 9, window=window, q_offset=off)))
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 7, 2, 16)).astype(np.float32) for _ in range(2))
    want = np.asarray(jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                           window=3))
    for use_kernel in (False, True):        # mha_ref / the kernel's plain version
        got = mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=3,
                  use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", DENSE_NAMES)
def test_lm_forward_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    want = np.asarray(jtf.lm_forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg))
    got = tf.lm_forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    last = lm.prefill_fn(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)
    np.testing.assert_allclose(last.numpy(), want[:, -1:], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("quantized", [False, True], ids=["raw", "int8"])
def test_decode_step_matches_jax(quantized):
    jcfg, tcfg = _cfgs("qwen2.5-3b")          # GQA: 4 query heads over 1 KV head
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(9)
    jcache = jlm.make_cache(jcfg, 2, 8, quantized=quantized)
    tcache = lm.make_cache(tcfg, 2, 8, quantized=quantized, device="cpu")
    for step in range(10):                    # past the ring's 8 rows
        tok = rng.integers(0, tcfg.vocab, (2, 1)).astype(np.int32)
        jl, jcache = jlm.decode_fn(jp, {"tokens": jnp.asarray(tok)}, jcache, jcfg)
        tl, tcache = lm.decode_fn(tp, {"tokens": torch.from_numpy(tok)}, tcache, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {step}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == 10
    if quantized:
        # the rings' int8 values: the same up to a rounding boundary that a
        # float32 sum in another order crosses
        d = np.abs(tcache["k"].numpy().astype(np.int32) - np.asarray(jcache["k"], np.int32))
        assert d.max() <= 1
    else:
        np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-4)


def test_quant_kv_row_is_bitwise_on_identical_rows():
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((2, 3, 4, 16)) * rng.uniform(0.01, 30, (2, 3, 4, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0                           # an all-zero row: scale 1e-12
    jq, js = jtf._quant_kv_row(jnp.asarray(x))
    tq, ts = tf._quant_kv_row(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
