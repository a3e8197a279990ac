"""Dequantization-free quantized matmul — reference path.

Port of ``repro/core/qmatmul.py``:

    y[t, :] = sigma[t] * (q[t, :] @ W) + sum_j ovals[t, j] * W[oidx[t, j], :]

The integer contraction accumulates in float32 and the per-token scale is
applied once, after accumulation.  The outlier term is a rank-k correction.
"""
from __future__ import annotations

import torch

from repro_torch.core.qtensor import QTensor, unpack_int4


def qmatmul(qt: QTensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y = dequant(qt) @ w, computed without materializing dequant(qt)."""
    if w.shape[0] != qt.feature_dim:
        raise ValueError(f"w rows {w.shape[0]} != feature dim {qt.feature_dim}")
    out_dtype = out_dtype or qt.orig_dtype
    q = unpack_int4(qt.inliers) if qt.bits == 4 else qt.inliers
    q = q[..., :qt.feature_dim]
    wf = w.float()
    y = torch.matmul(q.float(), wf) * qt.scales              # scale once, at the end
    if qt.k_outliers:
        wo = wf[qt.outlier_idx.long()]                         # (..., k, D)
        y = y + torch.einsum("...k,...kd->...d", qt.outlier_values.float(), wo)
    return y.to(out_dtype)


def qmatmul_fused_ref(x: torch.Tensor, w: torch.Tensor, bits: int,
                      k_outliers: int, out_dtype=None) -> torch.Tensor:
    """quantize(x) then qmatmul — the end-to-end op models call."""
    from repro_torch.core.quantize import quantize
    return qmatmul(quantize(x, bits, k_outliers), w, out_dtype or x.dtype)
