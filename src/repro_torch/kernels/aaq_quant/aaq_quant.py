"""CUDA kernel wrapper: fused token-wise AAQ runtime quantization.

Replaces ``repro/kernels/aaq_quant/aaq_quant.py:aaq_quantize_pallas``.  The
kernel (``csrc/aaq_quant.cu``) gives each token one warp: k rounds of a
warp-shuffle argmax on (|x|, -index) pick the outliers with ties to the
lower index, then one max reduction, IEEE division and round-half-even
produce the inliers, nibble-packed for 4 bits.  It is bound by bytes on the
H100; the row stays in registers from load to store.

On a CUDA tensor the wrapper launches the kernel or raises.  On a CPU
tensor it computes the plain version (``ref.aaq_quantize_ref``) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.aaq_quant.ref import aaq_quantize_ref

MAX_H = 512
launches = 0        # kernel launches (CUDA tensors only)
plain_calls = 0     # calls that computed the plain version (CPU tensors)


def aaq_quantize_kernel(x: torch.Tensor, *, bits: int, k_outliers: int):
    """x (T, H) bf16/f32 -> (inliers, scales (T,1), ovals (T,k), oidx (T,k))."""
    global launches, plain_calls
    if x.device.type == "cpu":
        plain_calls += 1
        return aaq_quantize_ref(x, bits, k_outliers)
    if x.device.type != "cuda":
        raise ValueError(f"aaq_quantize_kernel: unsupported device {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"aaq_quantize_kernel: need a contiguous (T, H) tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"aaq_quantize_kernel: dtype {x.dtype} not bf16/f32")
    t, h = x.shape
    if bits not in (4, 8):
        raise ValueError(f"aaq_quantize_kernel: bits {bits} not 4/8")
    if not 0 < h <= MAX_H or (bits == 4 and h % 2):
        raise ValueError(f"aaq_quantize_kernel: H={h} must be in (0, {MAX_H}] "
                         "and even for 4 bits")
    if not 0 <= k_outliers <= min(4, h):
        raise ValueError(f"aaq_quantize_kernel: k={k_outliers} not in [0, min(4, H)]")
    kk = max(k_outliers, 1)
    dev = x.device
    q = torch.empty((t, h // 2 if bits == 4 else h), dtype=torch.int8, device=dev)
    scales = torch.empty((t, 1), dtype=torch.float32, device=dev)
    ovals = torch.empty((t, kk), dtype=torch.bfloat16, device=dev)
    oidx = torch.empty((t, kk), dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.aaq_quantize_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            scales.data_ptr(), ovals.data_ptr(), oidx.data_ptr(), t, h, bits,
            k_outliers, stream)
    build.check(err, "aaq_quantize")
    launches += 1
    return q, scales, ovals[:, :k_outliers], oidx[:, :k_outliers]
