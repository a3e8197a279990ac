"""Step functions (port of ``repro/launch/steps.py``):

    train_step(params, opt_state, batch)  -> (params', opt_state', metrics)
    prefill_step(params, batch)           -> logits
    serve_step(params, batch, cache)      -> (logits, cache')
    fold_step(params, aatype[, mask])     -> coords/distogram   (PPM)

The reference jits these; the port runs them eagerly.  ``train_step``
updates the parameter and optimizer tensors in place (``adamw.update``)
and returns them.

Sharded (the parameters, moments and batch DTensors of
``parallel.sharding``'s placements, the reference's GSPMD step): DTensor
propagates the placements through the loss and its backward, and each
gradient is redistributed to its parameter's placements (or
``grad_shardings``'), so a partial sum is reduced (reduce-scatter
where the parameter is sharded) and a replicated parameter's gradient is
all-reduced over ``data``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.core.schemes import FP16Baseline, QuantScheme
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel import sharding as sh
from repro_torch.tree import leaves, unflatten


def _placed(g, p, s):
    """Gradient ``g`` on its parameter's placements (``s``'s when given):
    a partial sum reduced, a shard scattered."""
    if not sh.is_dtensor(g):
        return g
    to = s.placements if s is not None else p.placements
    return sh.redistribute(g, tuple(to))


def value_and_grad(params, batch, cfg: ArchConfig, *, aaq: AAQConfig = DISABLED,
                   remat: bool = True, grad_shardings=None):
    """(loss, grads): ``lm.loss_fn`` and its gradient in every parameter
    (zeros where a parameter does not reach the loss), the gradient tree
    shaped as ``params``.  The parameters require grad only for the call.
    DTensor gradients come on their parameters' placements, or on
    ``grad_shardings``' (a ``NamedSharding`` tree) when given."""
    flat = leaves(params)
    shards = leaves(grad_shardings) if grad_shardings is not None else [None] * len(flat)
    try:
        with torch.enable_grad(), sh.mixed_ops(params):
            for p in flat:
                p.requires_grad_(True)
            loss = lm.loss_fn(params, batch, cfg, aaq=aaq, remat=remat)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [_placed(torch.zeros_like(p) if g is None else g, p, s)
                     for p, g, s in zip(flat, grads, shards)]
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss.detach(), unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig | None = None,
                    aaq: AAQConfig = DISABLED, remat: bool = True,
                    microbatches: int | None = None, grad_compress=None,
                    grad_shardings=None):
    """One optimizer step.  ``microbatches > 1`` accumulates the gradient of
    that many slices of the batch in float32 (activation memory divided by
    it; ``cfg.train_microbatches`` when not given).  ``grad_compress``
    optionally maps the gradient tree before the update (AAQ error-feedback
    compression, ``optim/grad_compress.py``).  ``grad_shardings``: a
    ``NamedSharding`` tree each (microbatch) gradient is redistributed to,
    so partial sums stay sharded instead of all-reduced; DTensor gradients
    take their parameters' placements without it."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    n_micro = microbatches or cfg.train_microbatches

    def micro(v, i):
        """Microbatch ``i`` of ``v``: its i-th slice of rows as the
        reference's reshape cuts them; a batch sharded on its rows takes
        every ``n_micro``-th row from ``i`` instead, so that each rank's
        rows stay its own (DTensor cannot cut a sharded dim in uneven
        blocks; the sum over the microbatches is the same)."""
        if sh.is_dtensor(v):
            return v.reshape(v.shape[0] // n_micro, n_micro, *v.shape[1:])[:, i]
        return v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]

    def train_step(params, opt_state, batch):
        if n_micro > 1:
            lsum, gsum = None, None
            for i in range(n_micro):
                loss, grads = value_and_grad(params, {k: micro(v, i) for k, v in batch.items()},
                                             cfg, aaq=aaq, remat=remat,
                                             grad_shardings=grad_shardings)
                g = [x.float() for x in leaves(grads)]
                gsum = g if gsum is None else [a.add_(b) for a, b in zip(gsum, g)]
                lsum = loss if lsum is None else lsum + loss
            with sh.mixed_ops(params):
                loss = lsum / n_micro
                grads = unflatten(params, [g / n_micro for g in gsum])
        else:
            loss, grads = value_and_grad(params, batch, cfg, aaq=aaq, remat=remat,
                                         grad_shardings=grad_shardings)
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


def make_fold_step(cfg, scheme: QuantScheme | None = None, shard=None,
                   chunk_size: int | None = None):
    """PPM inference step (the paper's workload); ``shard`` runs this
    rank's part of a sharded fold: a ``sharding.PairShard`` (j over
    ``model``) or a ``sharding.PairGrid`` (i over the data axes, j over
    ``model``; the parameters the rank's shards where ``grid_params`` cut
    them, the reference's production layout).  ``chunk_size`` runs the
    row-chunked pair stack (``ppm_forward``'s)."""
    from repro_torch.models.ppm import ppm_forward

    def fold_step(params, aatype, mask=None):
        out = ppm_forward(params, aatype, cfg, scheme or FP16Baseline(), mask=mask,
                          chunk_size=chunk_size, shard=shard)
        return {"coords": out["coords"], "distogram": out["distogram"]}

    return fold_step
