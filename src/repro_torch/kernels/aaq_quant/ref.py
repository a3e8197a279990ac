"""Plain PyTorch version of the AAQ runtime-quantization kernel.

Port of ``repro/kernels/aaq_quant/ref.py``; same signature as the kernel
wrapper:  x (T, H) -> (inliers, scales, ovals, oidx).
"""
from __future__ import annotations

import torch

from repro_torch.core.qtensor import pack_int4, qmax
from repro_torch.core.quantize import scale_for, topk_lower_index


def aaq_quantize_ref(x: torch.Tensor, bits: int, k_outliers: int):
    """Token-wise symmetric quantization with top-k outlier split.

    x: (T, H) float.  Returns:
      inliers: int8 (T, H) for 8-bit / (T, H//2) nibble-packed for 4-bit
      scales:  f32 (T, 1)
      ovals:   bf16 (T, k)
      oidx:    int32 (T, k)
    """
    t, h = x.shape
    xf = x.float()
    if k_outliers > 0:
        oidx = topk_lower_index(xf.abs(), k_outliers)
        ovals = torch.gather(xf, -1, oidx)
        onehot = torch.zeros((t, h), dtype=torch.bool, device=x.device)
        onehot.scatter_(-1, oidx, True)
        inl = torch.where(onehot, torch.zeros((), device=x.device), xf)
    else:
        oidx = torch.zeros((t, 0), dtype=torch.int32, device=x.device)
        ovals = torch.zeros((t, 0), dtype=torch.float32, device=x.device)
        inl = xf
    m = inl.abs().amax(dim=-1, keepdim=True)
    scales = scale_for(m, bits)
    q = torch.clamp(torch.round(inl / scales), -qmax(bits), qmax(bits)).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return q, scales, ovals.to(torch.bfloat16), oidx.to(torch.int32)
