"""Step functions (port of ``repro/launch/steps.py``):

    train_step(params, opt_state, batch)  -> (params', opt_state', metrics)
    prefill_step(params, batch)           -> logits
    serve_step(params, batch, cache)      -> (logits, cache')
    fold_step(params, aatype)             -> coords/distogram   (PPM)

The reference jits these; the port runs them eagerly.  ``train_step``
updates the parameter and optimizer tensors in place (``adamw.update``)
and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.core.schemes import FP16Baseline, QuantScheme
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.tree import leaves, unflatten


def value_and_grad(params, batch, cfg: ArchConfig, *, aaq: AAQConfig = DISABLED,
                   remat: bool = True):
    """(loss, grads): ``lm.loss_fn`` and its gradient in every parameter
    (zeros where a parameter does not reach the loss), the gradient tree
    shaped as ``params``.  The parameters require grad only for the call."""
    flat = leaves(params)
    try:
        with torch.enable_grad():
            for p in flat:
                p.requires_grad_(True)
            loss = lm.loss_fn(params, batch, cfg, aaq=aaq, remat=remat)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig | None = None,
                    aaq: AAQConfig = DISABLED, remat: bool = True,
                    microbatches: int | None = None, grad_compress=None):
    """One optimizer step.  ``microbatches > 1`` accumulates the gradient of
    that many slices of the batch in float32 (activation memory divided by
    it; ``cfg.train_microbatches`` when not given).  ``grad_compress``
    optionally maps the gradient tree before the update (AAQ error-feedback
    compression, ``optim/grad_compress.py``)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    n_micro = microbatches or cfg.train_microbatches

    def train_step(params, opt_state, batch):
        if n_micro > 1:
            mb = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                  for k, v in batch.items()}
            lsum, gsum = None, None
            for i in range(n_micro):
                loss, grads = value_and_grad(params, {k: v[i] for k, v in mb.items()}, cfg,
                                             aaq=aaq, remat=remat)
                g = [x.float() for x in leaves(grads)]
                gsum = g if gsum is None else [a.add_(b) for a, b in zip(gsum, g)]
                lsum = loss if lsum is None else lsum + loss
            loss = lsum / n_micro
            grads = unflatten(params, [g / n_micro for g in gsum])
        else:
            loss, grads = value_and_grad(params, batch, cfg, aaq=aaq, remat=remat)
        if grad_compress is not None:
            grads = grad_compress(grads)
        lr_scale = warmup_cosine(opt_state["step"])
        params, opt_state, metrics = adamw.update(params, grads, opt_state, opt_cfg, lr_scale)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, aaq: AAQConfig = DISABLED):
    def prefill_step(params, batch):
        return lm.prefill_fn(params, batch, cfg, aaq=aaq)
    return prefill_step


def make_serve_step(cfg: ArchConfig, aaq: AAQConfig = DISABLED):
    def serve_step(params, batch, cache):
        return lm.decode_fn(params, batch, cache, cfg, aaq=aaq)
    return serve_step


def make_fold_step(cfg, scheme: QuantScheme | None = None):
    """PPM inference step (the paper's workload)."""
    from repro_torch.models.ppm import ppm_forward

    def fold_step(params, aatype):
        out = ppm_forward(params, aatype, cfg, scheme or FP16Baseline())
        return {"coords": out["coords"], "distogram": out["distogram"]}

    return fold_step
