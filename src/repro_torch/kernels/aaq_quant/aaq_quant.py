"""CUDA kernel wrappers: fused token-wise AAQ runtime quantization, in two
output forms.

Replaces ``repro/kernels/aaq_quant/aaq_quant.py:aaq_quantize_pallas``.  The
kernel (``csrc/aaq_quant.cu``) gives each token of a row up to 512 wide a
group of H/16 lanes (a power of two), each owning 16 consecutive columns
read with 16-byte loads; every lane keeps the sorted top 4 of its
(|x|, column) keys and butterfly shuffles merge the lists, so ties go to
the lower index; one more butterfly gives the inlier max, then
round-half-even of the IEEE quotient x / scale (a reciprocal product,
divided exactly near rounding ties) produces the inliers, bitwise with the
plain version.  A wider row (up to ``MAX_H``, the LM zoo's residual
stream) takes one warp, each lane walking 16-column chunks strided by 512;
the merges also carry the fifth key, which gives the inlier max, and a
second walk re-reads the row to quantize.  Its bound on the H100 is bytes.

No kernel has a backward: a wrapper refuses (``build.refuse_grad``) an
input that requires grad while grad mode is on, so a gradient can never
silently stop at a kernel's output.  Nor does a wrapper take a DTensor
(``build.refuse_dtensor``): a sharded caller hands it each rank's rows.

* ``aaq_quantize_kernel`` writes q (nibble-packed for 4 bits), the scales
  and the outliers: the input of ``aaq_matmul``.
* ``aaq_fake_quant_kernel`` writes only x_hat = dequantize(quantize(x)) in
  x's dtype: the fold's fake-quant ``act``.

On a CUDA tensor a wrapper launches its kernel or raises.  On a CPU tensor
it computes the plain version (``ref.py``) instead.  Each form counts its
launches and its plain calls apart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.aaq_quant.ref import aaq_fake_quant_ref, aaq_quantize_ref

MAX_H = 8192
launches = 0            # aaq_quantize kernel launches (CUDA tensors only)
fake_launches = 0       # aaq_fake_quant kernel launches
plain_calls = 0         # aaq_quantize calls that computed the plain version (CPU)
fake_plain_calls = 0    # aaq_fake_quant calls that computed the plain version


def _launch_shape(x: torch.Tensor, bits: int, k_outliers: int, what: str) -> tuple[int, int]:
    """Validate a launch without allocating (``meta`` tensors work): (T, H)."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: need a contiguous (T, H) tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: dtype {x.dtype} not bf16/f32")
    t, h = x.shape
    if bits not in (4, 8):
        raise ValueError(f"{what}: bits {bits} not 4/8")
    if not 0 < h <= MAX_H or (bits == 4 and h % 2):
        raise ValueError(f"{what}: H={h} must be in (0, {MAX_H}] and even for 4 bits")
    if not 0 <= k_outliers <= min(4, h):
        raise ValueError(f"{what}: k={k_outliers} not in [0, min(4, H)]")
    # the kernel reads each lane's columns with 16-byte loads
    if (h * x.element_size()) % 16 or (x.device.type != "meta" and x.data_ptr() % 16):
        raise ValueError(f"{what}: rows must be 16-byte aligned (H={h} x "
                         f"{x.element_size()} bytes from a 16-byte aligned address)")
    return t, h


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def aaq_quantize_kernel(x: torch.Tensor, *, bits: int, k_outliers: int):
    """x (T, H) bf16/f32 -> (inliers, scales (T,1), ovals (T,k), oidx (T,k))."""
    global launches, plain_calls
    build.refuse_dtensor("aaq_quantize_kernel", x)
    if x.device.type == "cpu":
        plain_calls += 1
        return aaq_quantize_ref(x, bits, k_outliers)
    build.refuse_grad("aaq_quantize_kernel", x)
    if x.device.type != "cuda":
        raise ValueError(f"aaq_quantize_kernel: unsupported device {x.device}")
    t, h = _launch_shape(x, bits, k_outliers, "aaq_quantize_kernel")
    kk = max(k_outliers, 1)
    dev = x.device
    q = torch.empty((t, h // 2 if bits == 4 else h), dtype=torch.int8, device=dev)
    scales = torch.empty((t, 1), dtype=torch.float32, device=dev)
    ovals = torch.empty((t, kk), dtype=torch.bfloat16, device=dev)
    oidx = torch.empty((t, kk), dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.aaq_quantize_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            scales.data_ptr(), ovals.data_ptr(), oidx.data_ptr(), t, h, bits,
            k_outliers, _stream(dev))
    build.check(err, "aaq_quantize")
    launches += 1
    return q, scales, ovals[:, :k_outliers], oidx[:, :k_outliers]


def aaq_fake_quant_kernel(x: torch.Tensor, bits: int, k_outliers: int) -> torch.Tensor:
    """x (T, H) bf16/f32 -> x_hat (T, H) in x's dtype: bitwise
    ``quantize.fake_quant(x, bits, k_outliers)``."""
    global fake_launches, fake_plain_calls
    build.refuse_dtensor("aaq_fake_quant_kernel", x)
    if x.device.type == "cpu":
        fake_plain_calls += 1
        return aaq_fake_quant_ref(x, bits, k_outliers)
    build.refuse_grad("aaq_fake_quant_kernel", x)
    if x.device.type != "cuda":
        raise ValueError(f"aaq_fake_quant_kernel: unsupported device {x.device}")
    t, h = _launch_shape(x, bits, k_outliers, "aaq_fake_quant_kernel")
    dev = x.device
    xhat = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.aaq_fake_quant_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), xhat.data_ptr(), t, h, bits,
            k_outliers, _stream(dev))
    build.check(err, "aaq_fake_quant")
    fake_launches += 1
    return xhat
