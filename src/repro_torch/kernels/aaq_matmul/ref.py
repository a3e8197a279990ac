"""Plain PyTorch version of the dequantization-free AAQ matmul kernel."""
from __future__ import annotations

import torch

from repro_torch.core.qtensor import unpack_int4


def aaq_matmul_ref(inliers, scales, ovals, oidx, w, *, bits: int,
                   out_dtype=torch.float32):
    """y = sigma * (q @ w) + sum_k ovals_k * w[oidx_k, :].

    inliers (T,H or T,H/2 packed) int8; scales (T,1) f32; ovals (T,K) bf16;
    oidx (T,K) int32; w (H,D).
    """
    q = unpack_int4(inliers) if bits == 4 else inliers
    wf = w.float()
    y = torch.matmul(q[:, :w.shape[0]].float(), wf) * scales
    if ovals.shape[-1]:
        wo = wf[oidx.long()]                                  # (T,K,D)
        y = y + torch.einsum("tk,tkd->td", ovals.float(), wo)
    return y.to(out_dtype)
