"""CUDA kernel wrapper: dequantization-free AAQ matmul.

y[t, :] = sigma[t] * (q[t, :] @ W)  +  sum_j ovals[t, j] * W[oidx[t, j], :]

Replaces ``repro/kernels/aaq_matmul/aaq_matmul.py:aaq_matmul_pallas``.  The
kernel (``csrc/aaq_matmul.cu``) gives each block one (64-token, 64-column)
output tile: int4 inliers are unpacked with sign extension and widened to
float32 (exact), multiplied against W widened to float32, and the deferred
per-token scale and the rank-k outlier gather are applied in the epilogue.
At the main-path shapes it is bound by bytes on the H100 (the (T, D) output
write dominates); this first version runs the product on the CUDA cores in
float32 and is far from that bound, tensor cores are later work.

On a CUDA tensor the wrapper launches the kernel or raises.  On a CPU
tensor it computes the plain version (``ref.aaq_matmul_ref``) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.aaq_matmul.ref import aaq_matmul_ref

launches = 0        # kernel launches (CUDA tensors only)
plain_calls = 0     # calls that computed the plain version (CPU tensors)


def aaq_matmul_kernel(inliers, scales, ovals, oidx, w, *, bits: int,
                      out_dtype=torch.float32):
    """inliers (T, H/2 or H) int8, scales (T,1) f32, ovals (T,k) bf16,
    oidx (T,k) int32, w (H, D) -> y (T, D) in ``out_dtype``."""
    global launches, plain_calls
    if inliers.device.type == "cpu":
        plain_calls += 1
        return aaq_matmul_ref(inliers, scales, ovals, oidx, w, bits=bits,
                              out_dtype=out_dtype)
    if inliers.device.type != "cuda":
        raise ValueError(f"aaq_matmul_kernel: unsupported device {inliers.device}")
    t, hp = inliers.shape
    h, d = w.shape
    k = ovals.shape[-1]
    if bits not in (4, 8) or hp != ((h + 1) // 2 if bits == 4 else h):
        raise ValueError(f"aaq_matmul_kernel: inliers {tuple(inliers.shape)} do not "
                         f"match w {tuple(w.shape)} at {bits} bits")
    if w.dtype not in (torch.bfloat16, torch.float32) or out_dtype != w.dtype:
        raise ValueError(f"aaq_matmul_kernel: w {w.dtype} and out {out_dtype} must be "
                         "the same type, bf16 or f32")
    checks = ((inliers, torch.int8, (t, hp)), (scales, torch.float32, (t, 1)),
              (ovals, torch.bfloat16, (t, k)), (oidx, torch.int32, (t, k)),
              (w, w.dtype, (h, d)))
    for a, dt, shape in checks:
        if a.device != inliers.device or a.dtype != dt or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"aaq_matmul_kernel: operand {a.dtype} {tuple(a.shape)} on "
                             f"{a.device} is not a contiguous {dt} {shape}")
    if k > 4:
        raise ValueError(f"aaq_matmul_kernel: k={k} > 4")
    y = torch.empty((t, d), dtype=out_dtype, device=w.device)
    lib = build.library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.aaq_matmul_launch(
            inliers.data_ptr(), scales.data_ptr(), ovals.data_ptr(), oidx.data_ptr(),
            w.data_ptr(), y.data_ptr(), int(w.dtype == torch.bfloat16), t, h, d,
            bits, k, max(k, 1), stream)
    build.check(err, "aaq_matmul")
    launches += 1
    return y
