"""Shared by ``test_torch_train_loss*.py``: ``lm.loss_fn``'s value and every
gradient leaf against the reference's ``jax.value_and_grad`` of its
``loss_fn``, with the reference's own parameters (bridged), on the same
numpy batch, at ``reduce_config`` in float32."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.core.policy import AAQConfig as JaxAAQConfig
from repro.core.policy import DISABLED as JAX_DISABLED
from repro.models import lm as jlm
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.kernels import dispatch
from repro_torch.models import lm
from repro_torch.tree import leaves

#: loss and gradients, absolute and relative: float32 sums in another order
#: (the readings are below 6e-6 on gradients up to 4)
TOL = 1e-4


def batch_for(cfg, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.kind == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.kind == "encdec":
        batch["audio_frames"] = rng.standard_normal(
            (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def check_loss_and_grads(name, ste: bool):
    """Under ``AAQConfig(ste=True)`` the reference runs op by op
    (``jax.disable_jit``): compiled, its scanned blocks quantize through
    XLA's reciprocal product instead of the IEEE division, which moves
    fake-quant bins (the prefill parity's rule, ``test_torch_zoo.py``)."""
    jcfg = jax_reduce_config(jax_get_config(name)).replace(dtype="float32")
    tcfg = reduce_config(get_config(name)).replace(dtype="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    batch = batch_for(tcfg)
    jaaq, taaq = (JaxAAQConfig(ste=True), AAQConfig(ste=True)) if ste else (JAX_DISABLED,
                                                                             DISABLED)
    with jax.disable_jit(ste):
        want, jgrads = jax.value_and_grad(lambda p: jlm.loss_fn(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, aaq=jaaq))(jp)
    flat = leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    dispatch.reset_counters()
    got = lm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg, aaq=taaq)
    grads = torch.autograd.grad(got, flat, allow_unused=True)
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL, atol=TOL)
    wgrads = leaves(lm_params_from_numpy(jax.tree.map(np.asarray, jgrads), tcfg, device="cpu"))
    assert len(wgrads) == len(grads)
    for i, (g, w) in enumerate(zip(grads, wgrads)):
        assert g is not None, f"{name}: leaf {i} gets no gradient"
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{name} leaf {i}")
    assert float(sum((g.double() ** 2).sum() for g in grads)) > 0
    # every act site under STE takes the straight-through fake-quant (its
    # forward routed with grad mode off: fakequant.ref on the CPU); the
    # attention of grad-requiring operands is the plain one (ref_grad)
    c = dispatch.counters
    assert c["fakequant.ref_grad"] == 0 and (c["fakequant.ref"] > 0) == ste
    assert c["attention.kernel"] == 0 and c["attention.ref"] == 0
    assert (c["attention.ref_grad"] > 0) == (tcfg.kind != "ssm")
