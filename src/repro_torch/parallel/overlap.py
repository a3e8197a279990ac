"""Communication/compute overlap primitives (port of
``repro/parallel/overlap.py``), over the process group of one mesh axis
(``DeviceMesh.get_group(axis)``), each rank calling with its shard.

``ring_ag_matmul``: y = all_gather(x) @ w computed as a ring: each step
multiplies the resident block while the next one is on its way
(``collectives.RingShift``: the send and receive are issued before the
product), so the transfer hides behind the product.  The manual form of
XLA's collective matmul; the ring's shifts move the bytes an all-gather
would, and expose none of them when a step's product takes at least as
long as its shift.

``psum_scatter_matmul``: the row-parallel dual, the local product
reduce-scattered.

The products are plain ``torch.matmul`` in float32, as the reference's
``jnp.einsum``/``jnp.dot`` are (no kernel of the reference computes them).
"""
from __future__ import annotations

import torch

from repro_torch.parallel import collectives as coll


def _ring(x: torch.Tensor, group, weight_rows):
    """sum over the ring's p blocks of block @ weight_rows(owner): rank idx
    holds block idx at step 0 and block (idx - i) mod p at step i."""
    p = coll.group_size(group)
    idx = torch.distributed.get_rank(group)
    blk = x
    acc = None
    for i in range(p):
        nxt = coll.RingShift(blk, group) if i < p - 1 else None   # in flight meanwhile
        y = torch.matmul(blk.float(), weight_rows((idx - i) % p).float())
        acc = y if acc is None else acc + y
        if nxt is not None:
            blk = nxt.wait()
    return acc


def ring_ag_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """x (m, k/p) this rank's shard; w (k/p, n) the matching rows of the
    weight; -> all_gather(x) @ w_full (m, n) float32 on every rank,
    without gathering x.  The weight's row blocks are gathered once
    (resident, as the reference's ``all_gather(w)``)."""
    w_stacked = coll.all_gather(w.contiguous(), 0, group).reshape(
        coll.group_size(group), *w.shape)
    return _ring(x, group, lambda src: w_stacked[src])


def ring_ag_matmul_ws(x: torch.Tensor, w_full: torch.Tensor, group) -> torch.Tensor:
    """Weight-stationary: w_full (k, n) already resident (parameters); x
    (m, k/p) the sharded activation.  Each ring step takes one k-block of
    w: no weight gather at all."""
    kl = w_full.shape[0] // coll.group_size(group)
    return _ring(x, group, lambda src: w_full[src * kl:(src + 1) * kl])


def psum_scatter_matmul(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Row-parallel linear: x (m, k_local), w (k_local, n) -> this rank's
    (m/p, n) rows of the group's summed product."""
    y = torch.matmul(x.float(), w.float())
    return coll.reduce_scatter(y, 0, group)
