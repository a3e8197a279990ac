"""CPU parity of the port's model zoo (MoE with MLA, Mixtral's MoE with a
sliding window, the RG-LRU hybrid, SSD, the encoder-decoder, the VLM) with
the JAX reference, through ``models.lm``'s unified API: each non-dense
config reduced to float32 with the reference's own parameters (bridged),
one torch thread.

Gates:
  * ``prefill_fn`` under ``DISABLED`` and ``AAQConfig()``: last-position
    logits allclose 1e-4 (float32 sums in another order).  Under AAQ the
    reference runs op by op (``jax.disable_jit``): its compiled ``scan``
    body quantizes through XLA's reciprocal product, not an IEEE division,
    and its fake-quant bins move (mixtral reads 2.8e-4 between the
    reference's compiled and op-by-op forwards; the port is within 1.5e-6
    of the op-by-op one);
  * ``decode_fn`` over 8 steps from an empty ``make_cache``: every step's
    logits allclose 1e-4, and the cache's shapes and dtypes the reference's.
  * the unified API's entry points: ``loss_fn`` trains every kind
    (parity in ``test_torch_train_loss*.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduce_config as jax_reduce_config  # noqa: E402
from repro.core.policy import AAQConfig as JAXAAQConfig  # noqa: E402
from repro.core.policy import DISABLED as JAX_DISABLED  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.bridge import lm_params_from_numpy  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config, reduce_config  # noqa: E402
from repro_torch.core.policy import DISABLED, AAQConfig  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ZOO = tuple(n for n in ARCH_NAMES if get_config(n).kind != "dense")
_MODELS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(name):
    """(reference cfg, port cfg, reference params, port params), built once."""
    if name not in _MODELS:
        jcfg = jax_reduce_config(jax_get_config(name)).replace(dtype="float32")
        tcfg = reduce_config(get_config(name)).replace(dtype="float32")
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _MODELS[name] = (jcfg, tcfg, jp, tp)
    return _MODELS[name]


def _batch(cfg, seed=1, b=2, s=12):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.kind == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.kind == "encdec":
        batch["audio_frames"] = rng.standard_normal(
            (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_zoo_covers_every_kind_the_reference_has():
    assert {get_config(n).kind for n in ZOO} == {"vlm", "moe", "hybrid", "ssm", "encdec"}
    assert len(ZOO) == 6


@pytest.mark.parametrize("aaq", ["disabled", "aaq"])
@pytest.mark.parametrize("name", ZOO)
def test_prefill_matches_jax(name, aaq):
    jcfg, tcfg, jp, tp = _model(name)
    batch = _batch(tcfg)
    jaaq, taaq = (JAX_DISABLED, DISABLED) if aaq == "disabled" else (JAXAAQConfig(), AAQConfig())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # under AAQ the reference runs op by op: compiled, its scan body's
    # quantizers divide by a reciprocal product (XLA), which moves rounding
    # boundaries; mixtral then reads 2.8e-4 against its own eager blocks
    with jax.disable_jit(aaq == "aaq"):
        want = np.asarray(jlm.prefill_fn(jp, jbatch, jcfg, jaaq))
    got = lm.prefill_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg, taaq)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 1, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ZOO)
def test_decode_matches_jax(name):
    """8 decode steps from an empty cache (written in place by the port,
    returned anew by the reference), each step's logits allclose 1e-4; the
    enc-dec's cross-attention reads the reference's ``encode`` output,
    written into both caches' ``enc_out`` first."""
    jcfg, tcfg, jp, tp = _model(name)
    jcache = jlm.make_cache(jcfg, 2, 16)
    tcache = lm.make_cache(tcfg, 2, 16, device="cpu")
    want_leaves, got_leaves = list(_leaves(jcache)), list(_leaves(tcache))
    assert [(a.shape, str(a.dtype)) for a in want_leaves] == \
        [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in got_leaves]
    if tcfg.kind == "encdec":
        frames = _batch(tcfg)["audio_frames"]
        jcache = {**jcache, "enc_out": jed.encode(jp, jnp.asarray(frames), jcfg)}
        tcache["enc_out"].copy_(ed.encode(tp, torch.from_numpy(frames), tcfg))
        np.testing.assert_allclose(tcache["enc_out"].numpy(), np.asarray(jcache["enc_out"]),
                                   atol=1e-4, rtol=1e-4)
        assert float(np.abs(np.asarray(jcache["enc_out"])).max()) > 0.5
    rng = np.random.default_rng(9)
    for step in range(8):
        tok = rng.integers(0, tcfg.vocab, (2, 1)).astype(np.int32)
        jl, jcache = jlm.decode_fn(jp, {"tokens": jnp.asarray(tok)}, jcache, jcfg)
        tl, tcache = lm.decode_fn(tp, {"tokens": torch.from_numpy(tok)}, tcache, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} step {step}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == 8
    for t, j in zip(_leaves(tcache), _leaves(jcache)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ("qwen2.5-3b",) + ZOO)
def test_make_cache_defaults_to_the_card(name):
    """``make_cache`` with no device means CUDA, as every entry point of the
    port does, and raises when no card is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduce_config(get_config(name)).replace(dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.make_cache(cfg, 2, 16)
    assert all(t.device.type == "cpu" for t in _leaves(lm.make_cache(cfg, 2, 16, device="cpu")))


def test_loss_fn_waits_for_training():
    """The training slice has landed: ``loss_fn`` gives the mean token
    cross-entropy, finite, near log(vocab) for random weights."""
    _, tcfg, _, tp = _model("mamba2-780m")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    loss = lm.loss_fn(tp, batch, tcfg)
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert abs(float(loss) - np.log(tcfg.vocab)) < 1.0
