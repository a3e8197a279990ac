"""CUDA kernel wrapper: dequantization-free AAQ matmul.

y[t, :] = sigma[t] * (q[t, :] @ W)  +  sum_j ovals[t, j] * W[oidx[t, j], :]

Replaces ``repro/kernels/aaq_matmul/aaq_matmul.py:aaq_matmul_pallas``.  Two
variants of the kernel (``csrc/aaq_matmul.cu``), chosen by a fixed rule on
W's type and counted apart:

* bf16 W (every main-path call): the tensor-core kernel.  W stays resident
  in shared memory, a persistent grid streams 128-token q tiles through a
  two-stage ``cp.async`` ring, int4/int8 inliers are widened to bf16 in
  registers (exact) and multiplied with ``mma.sync`` into float32; sigma
  and the rank-k outlier gather are applied in the epilogue.  It is bound
  by bytes on the H100 (the packed q read and the (T, D) write).
* f32 W: the SIMT kernel, IEEE float32 on the CUDA cores.

On a CUDA tensor the wrapper launches the kernel or raises.  On a CPU
tensor it computes the plain version (``ref.aaq_matmul_ref``) instead.
The kernel has no backward: an operand that requires grad under grad mode
is refused (``build.refuse_grad``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.aaq_matmul.ref import aaq_matmul_ref

MAX_TC_H = 512
launches = 0        # tensor-core kernel launches (bf16 W)
f32_launches = 0    # SIMT kernel launches (f32 W)
plain_calls = 0     # calls that computed the plain version (CPU tensors)


def aaq_matmul_kernel(inliers, scales, ovals, oidx, w, *, bits: int,
                      out_dtype=torch.float32):
    """inliers (T, H/2 or H) int8, scales (T,1) f32, ovals (T,k) bf16,
    oidx (T,k) int32, w (H, D) -> y (T, D) in ``out_dtype``."""
    global launches, f32_launches, plain_calls
    build.refuse_dtensor("aaq_matmul_kernel", inliers, scales, ovals, oidx, w)
    if inliers.device.type == "cpu":
        plain_calls += 1
        return aaq_matmul_ref(inliers, scales, ovals, oidx, w, bits=bits,
                              out_dtype=out_dtype)
    build.refuse_grad("aaq_matmul_kernel", scales, ovals, w)
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
    tc = w.dtype == torch.bfloat16
    if tc and (h > MAX_TC_H or h % (32 if bits == 4 else 16)):
        raise ValueError(f"aaq_matmul_kernel: the bf16 kernel takes H <= {MAX_TC_H}, a "
                         f"multiple of {32 if bits == 4 else 16} at {bits} bits; got H={h}")
    if tc and any(a.data_ptr() % 16 for a in (inliers, scales, ovals, oidx, w)):
        raise ValueError("aaq_matmul_kernel: the bf16 kernel copies its operands 16 bytes "
                         "at a time; a base pointer is not 16-byte aligned")
    y = torch.empty((t, d), dtype=out_dtype, device=w.device)
    lib = build.library()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        launch = lib.aaq_matmul_launch if tc else lib.aaq_matmul_f32_launch
        err = launch(inliers.data_ptr(), scales.data_ptr(), ovals.data_ptr(), oidx.data_ptr(),
                     w.data_ptr(), y.data_ptr(), t, h, d, bits, k, max(k, 1), stream)
    build.check(err, "aaq_matmul" if tc else "aaq_matmul_f32")
    if tc:
        launches += 1
    else:
        f32_launches += 1
    return y
