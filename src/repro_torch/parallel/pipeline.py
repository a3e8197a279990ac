"""Pipeline parallelism over the pod axis (port of
``repro/parallel/pipeline.py``): the GPipe schedule, each stage one rank of
the ``axis`` group of a ``DeviceMesh``.

Cross-pod links are the slow tier, so instead of all-reducing full
gradients every step (DP over pods) each pod owns a contiguous *stage* of
the layer stack and only microbatch activations cross pods: bytes a step
drop from O(params) to O(n_micro x mb x S x D).

Schedule: fill-drain over ``n_micro + p - 1`` ticks; the bubble is
(p - 1) / (n_micro + p - 1).  Stage s owns layers [s L/p, (s+1) L/p) of
the port's list of layers (the reference shards a stacked layer axis over
``axis``).  At each tick a stage runs its layers on its input (stage 0 the
next microbatch, the others what the previous stage sent at the last
tick), then every stage hands its output to the next
(``collectives.permute``, whose backward sends the gradient back).  A
stage skips its inactive ticks (the reference computes and masks them:
the same result).  The last stage's outputs reach every rank through
``collectives.all_reduce_sum``.  The embedding and the unembedding run
on every rank.

Gradients: each rank's backward sends, at every tick in reverse, the
gradient of what it received back to its sender, so every rank's graph
holds every tick's exchange (an inactive tick passes its input on times
zero, and each exchange also hangs on a zero that depends on the stage's
layers and the embedding); ask for the gradients of every parameter, as
``launch.steps.value_and_grad`` does.  Rank s's stage layers get their whole gradient on rank s; the
parameters every rank uses (embedding, final norm, unembedding) get theirs
whole on the first stage, which both feeds the pipeline and computes the
loss.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tf
from repro_torch.parallel import collectives as coll


def _stage(mesh, axis: str):
    """(this rank's stage, the stage count, the group along ``axis``)."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_local_rank(dim), mesh.size(dim), mesh.get_group(dim)


def _apply_local_stack(blocks, x, cfg, positions, block_fn):
    for p in blocks:
        x = block_fn(p, x, cfg, positions=positions)
    return x


def _anchor(x, local):
    """Zero that depends on ``x`` and on every layer of the stage: each
    exchange takes it as an input, so every rank's backward (which
    ``torch.autograd.grad`` prunes to the nodes that reach the tensors it
    is asked for) runs every exchange whenever the embedding's or the
    stages' gradients are asked for, even where the exchange's own input
    needs none (a stage's first inactive tick)."""
    from repro_torch.tree import leaves
    terms = [t for t in (x, *leaves(local)) if t.requires_grad]
    return sum(0.0 * t.reshape(-1)[0] for t in terms) if terms else None


def gpipe_apply(blocks, x, cfg, *, mesh, n_micro: int, block_fn=None, axis: str = "pod"):
    """x: (B, S, D) embedded activations, the same on every rank of the
    ``axis`` group; blocks: the model's list of layers (this rank runs its
    stage's).  Returns the final activations (B, S, D) on every rank."""
    block_fn = block_fn or tf.block_apply
    stage, p, group = _stage(mesh, axis)
    b, s, d = x.shape
    if b % n_micro:
        raise ValueError(f"gpipe_apply: batch {b} does not split into {n_micro} microbatches")
    if len(blocks) % p:
        raise ValueError(f"gpipe_apply: {len(blocks)} layers do not split into {p} stages")
    per = len(blocks) // p
    local = blocks[stage * per:(stage + 1) * per]
    mb = b // n_micro
    positions = torch.arange(s, device=x.device)[None].expand(mb, s)
    xmb = x.reshape(n_micro, mb, s, d)
    perm = [(i, i + 1) for i in range(p - 1)]
    recv = torch.zeros((mb, s, d), dtype=x.dtype, device=x.device)
    anchor = _anchor(x, local) if torch.is_grad_enabled() else None
    outs = [None] * n_micro
    for t in range(n_micro + p - 1):
        # stage 0 feeds the next microbatch; the term in recv (zeros there)
        # keeps this tick's exchange in its graph
        inp = xmb[min(t, n_micro - 1)] + 0.0 * recv if stage == 0 else recv
        active = stage <= t and t - stage < n_micro
        y = _apply_local_stack(local, inp, cfg, positions, block_fn) if active else 0.0 * inp
        if active and stage == p - 1:
            outs[t - (p - 1)] = y
        recv = coll.permute(y, perm, group, anchor)
    zero = torch.zeros((mb, s, d), dtype=x.dtype, device=x.device)
    out = torch.stack([o if o is not None else zero for o in outs]) + 0.0 * recv
    # the last stage's outputs to every rank (each keeps its own term's gradient)
    return coll.all_reduce_sum(out, group).reshape(b, s, d)


def gpipe_loss(params, batch, cfg, *, mesh, n_micro: int = 4, axis: str = "pod"):
    """Dense-LM loss with the layer stack pipelined over ``axis``."""
    x = tf._embed_inputs(params, batch, cfg)
    x = gpipe_apply(params["blocks"], x, cfg, mesh=mesh, n_micro=n_micro, axis=axis)
    x = tf.apply_norm(params["final_norm"], x, cfg)
    return tf.chunked_xent(params, x, batch["labels"], cfg)
