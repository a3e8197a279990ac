"""Public op: fused AAQ linear  y = dequant-free-matmul(quantize(x), W)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel
from repro_torch.kernels.aaq_quant.ops import aaq_quantize


def aaq_linear(x: torch.Tensor, w: torch.Tensor, *, bits: int,
               k_outliers: int) -> torch.Tensor:
    """x (..., H) @ w (H, D) through the two kernels (quantize, then the
    dequantization-free matmul).  Neither kernel has a backward: on a device
    other than the CPU, an x or w that requires grad under grad mode is
    refused before either launches."""
    if x.device.type != "cpu":
        build.refuse_grad("aaq_linear", x, w)
    lead = x.shape[:-1]
    qt = aaq_quantize(x, bits, k_outliers)
    nt = math.prod(lead)
    flat = lambda a: a.reshape(nt, a.shape[-1])  # noqa: E731
    y = aaq_matmul_kernel(flat(qt.inliers), flat(qt.scales), flat(qt.outlier_values),
                          flat(qt.outlier_idx), w.contiguous(), bits=bits,
                          out_dtype=x.dtype)
    return y.reshape(*lead, w.shape[-1])
