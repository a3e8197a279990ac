"""AAQ gradient compression with error feedback (port of
``repro/optim/grad_compress.py``): the paper's token-wise quantizer applied
to a gradient reduction, each row of a weight matrix a 'token'.  Token-wise
INT8 quarters the bytes of an f32 gradient on the wire; the error-feedback
residual keeps the sum of what was sent plus the residual equal to the sum
of the true gradients.

    state = init_state(params)
    grads, state = compress_decompress(grads, state, bits=8)

Off the launcher's default path (``--grad-compress``).  It quantizes
through ``core.quantize.fake_quant``, the plain reference dataflow, as the
reference does: its rows can be vocabulary-wide (a tied unembedding's last
axis is 151,936 for qwen1.5-0.5b), beyond any row the quantize kernel takes.
A DTensor gradient (a sharded train step) is quantized as each rank's
whole rows (``sharding.on_rows``: a sharded last dim is gathered first);
its residual keeps the gradient's placements.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import fake_quant
from repro_torch.parallel import sharding as sh
from repro_torch.tree import leaves, tree_map, unflatten


def init_state(params):
    """Error-feedback residuals, one float32 tensor per parameter."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _rows_fake_quant(gf, bits: int, k_outliers: int):
    flat = gf.reshape(-1, gf.shape[-1]) if gf.dim() > 1 else gf.reshape(1, -1)
    return fake_quant(flat, bits, k_outliers).reshape(gf.shape)


def _quant_one(g, r, bits: int, k_outliers: int):
    gf = g.float() + r
    if sh.is_dtensor(gf):
        q = sh.redistribute(sh.on_rows("grad_compress", lambda t: _rows_fake_quant(
            t, bits, k_outliers), gf), gf.placements)
    else:
        q = _rows_fake_quant(gf, bits, k_outliers)
    return q.to(g.dtype), gf - q


def compress_decompress(grads, state, bits: int = 8, k_outliers: int = 0):
    """Quantize (what the wire would carry) and keep the residual locally."""
    outs = [_quant_one(g, r, bits, k_outliers) for g, r in zip(leaves(grads), leaves(state))]
    return (unflatten(grads, [o[0] for o in outs]), unflatten(grads, [o[1] for o in outs]))


def wire_bytes(params, bits: int = 8) -> int:
    """Bytes a compressed reduction moves: the quantized values and one
    float32 scale a row."""
    total = 0
    for p in leaves(params):
        rows = p.numel() // p.shape[-1] if p.dim() > 1 else 1
        total += p.numel() * bits // 8 + rows * 4
    return total
