"""AdamW with global-norm clipping over a parameter tree (port of
``repro/optim/adamw.py``).

Parameters are nested dicts/lists of tensors (the models' layout); the
moments have the same tree, in float32 whatever the parameter dtype (mixed-
precision discipline), and ``step`` is an int32 scalar tensor.  ``update``
follows the reference's arithmetic leaf by leaf and writes the new values
into the parameter and moment tensors in place (an optimizer step must not
hold a second copy of a model that fills the card); it returns them.

On DTensors (a sharded train step) the moments take their parameter's
placements (``opt_state_shardings``: ZeRO-by-TP), ``step`` is replicated,
``global_norm`` is the whole tree's norm on every rank (each shard's sum
of squares reduced over its mesh), and the update runs on each rank's
shards in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.parallel import sharding as sh
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params) -> dict[str, Any]:
    f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    first = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if sh.is_dtensor(first):
        step = sh.distribute(step, first.device_mesh, sh.P())
    return {"m": tree_map(f32, params), "v": tree_map(f32, params), "step": step}


def global_norm(tree) -> torch.Tensor:
    total = None
    with sh.mixed_ops(tree):
        for x in leaves(tree):
            s = torch.sum(torch.square(x.float()))
            if sh.is_dtensor(s):               # a shard's sum -> the whole leaf's
                s = sh.redistribute(s, sh.placements(sh.P(), s.device_mesh))
            total = s if total is None else total + s
        return torch.sqrt(total)


@torch.no_grad()
def update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (params, state, metrics), the tensors updated in place;
    ``metrics['grad_norm']`` is the norm before clipping."""
    with sh.mixed_ops(params):
        return _update(params, grads, state, cfg, lr_scale)


def _update(params, grads, state, cfg: AdamWConfig, lr_scale):
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr * (lr_scale.float() if isinstance(lr_scale, torch.Tensor) else
                   torch.as_tensor(lr_scale, dtype=torch.float32, device=gnorm.device))
    s = step.float()
    bc1 = 1 - torch.pow(torch.full((), cfg.b1, device=s.device), s)
    bc2 = 1 - torch.pow(torch.full((), cfg.b2, device=s.device), s)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]), leaves(state["v"])):
        # the reference's expressions, one rounding an operation, with the
        # temporaries reused in place (a mixtral expert stack is 3.2 GB a leaf)
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        g2 = (1 - cfg.b2) * g
        v.mul_(cfg.b2).add_(g2.mul_(g))
        del g, g2
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        upd = (m / bc1).div_(denom)
        del denom
        pf = p.float()
        upd.add_(cfg.weight_decay * pf)
        p.copy_((pf - lr * upd).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
