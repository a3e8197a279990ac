"""Public ops: AAQ runtime quantization (kernel-backed, QTensor-returning)
and its fake-quant form."""
from __future__ import annotations

import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels.aaq_quant.aaq_quant import aaq_fake_quant_kernel, aaq_quantize_kernel


def aaq_quantize(x: torch.Tensor, bits: int, k_outliers: int) -> QTensor:
    """Quantize an activation of any rank through the kernel; token axis = -1."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1]).contiguous()
    inl, scales, ovals, oidx = aaq_quantize_kernel(flat, bits=bits, k_outliers=k_outliers)
    lead = shape[:-1]
    return QTensor(
        inliers=inl.reshape(*lead, -1),
        scales=scales.reshape(*lead, 1),
        outlier_values=ovals.reshape(*lead, k_outliers),
        outlier_idx=oidx.reshape(*lead, k_outliers),
        bits=bits, k_outliers=k_outliers, feature_dim=shape[-1],
        orig_dtype=x.dtype)


def aaq_fake_quant(x: torch.Tensor, bits: int, k_outliers: int) -> torch.Tensor:
    """Fake-quantize an activation of any rank through the kernel; token
    axis = -1.  The result has x's shape and dtype (contiguous)."""
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    return aaq_fake_quant_kernel(flat, bits, k_outliers).reshape(x.shape)
