"""Plain PyTorch version of the AAQ runtime-quantization kernel.

Port of ``repro/kernels/aaq_quant/ref.py``; same signatures as the kernel
wrappers:  x (T, H) -> (inliers, scales, ovals, oidx), and the fake-quant
form x (T, H) -> x_hat (T, H).
"""
from __future__ import annotations

import torch

from repro_torch.core.qtensor import QTensor, pack_int4, qmax
from repro_torch.core.quantize import dequantize, scale_for, topk_lower_index


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


def aaq_fake_quant_ref(x: torch.Tensor, bits: int, k_outliers: int) -> torch.Tensor:
    """x_hat = dequantize(aaq_quantize_ref(x)) in x's dtype."""
    q, scales, ovals, oidx = aaq_quantize_ref(x, bits, k_outliers)
    return dequantize(QTensor(inliers=q, scales=scales, outlier_values=ovals,
                              outlier_idx=oidx, bits=bits, k_outliers=k_outliers,
                              feature_dim=x.shape[-1], orig_dtype=x.dtype))
