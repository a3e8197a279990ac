"""CUDA kernel wrapper: dequantization-free AAQ matmul.

y[t, :] = sigma[t] * (q[t, :] @ W)  +  sum_j ovals[t, j] * W[oidx[t, j], :]

Replaces ``repro/kernels/aaq_matmul/aaq_matmul.py:aaq_matmul_pallas``.  Four
variants of the kernel (``csrc/aaq_matmul.cu``), chosen by a fixed rule on
W's type, H, D and the bits (:func:`variant_for`) and counted apart:

* bf16 W, int4 inliers, H and D multiples of 128 whose resident W and ring
  fit one block's shared memory (:func:`wg_plan`; every main-path call but
  the triangular bias's D = 4): the Hopper kernel.  A persistent block an
  SM holds all of W in shared memory in wgmma's swizzled layout; up to four
  warpgroups, each on its own 64-token tiles, load their own ring stages
  (q by TMA, sigma and the outliers by bulk copies), widen the nibbles to
  bf16 in registers (bit operations, exact) straight into ``wgmma``'s A
  fragments, scale by sigma, add the rank-k outlier term (a second
  ``wgmma`` on a bf16 tile holding each token's outliers at their k) and
  store y by TMA, asynchronously.
* every other bf16 W with H up to 512, a multiple of 32 at 4 bits or of 16
  at 8 (D = 4, int8 inliers, a shape the plan cannot take): the
  tensor-core kernel with Ampere's ``mma.sync``: W resident, a persistent
  grid streaming 128-token q tiles through a two-stage ``cp.async`` ring.
* f32 W (counted as ``aaq_matmul_f32``), and every bf16 W neither kernel
  above takes (H above 512 or off their multiples, counted as
  ``aaq_matmul_wide``): the split-W kernel, any H and D.  A float32 W is
  split as it is staged into three bf16 parts that sum to it exactly
  (:func:`split_w`), so the three bf16 products by an inlier (exact in bf16)
  are exact and their float32 sum keeps float32's precision; a bf16 W is
  its own one part.  H streams in 128-column panels (W resident where it
  fits a block), and the outlier term is added in float32 from W itself.

All are bound by bytes on the H100 (the packed q read and the (T, D) write).
A token's sum runs in the same order whatever tile or launch it falls in (no
atomics, no split-K), so a row launched alone is bitwise its row of a batch.

On a CUDA tensor the wrapper launches the kernel or raises.  On a CPU
tensor it computes the plain version (``ref.aaq_matmul_ref``) instead.
The kernel has no backward: an operand that requires grad under grad mode
is refused (``build.refuse_grad``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.aaq_matmul.ref import aaq_matmul_ref

MAX_TC_H = 512      # the tensor-core kernel's widest H (W resident in one block)
TC, WG, F32, WIDE = "tc", "wg", "f32", "wide"
# variant -> its name in ``dispatch.launch_counts``
VARIANT_NAMES = {TC: "aaq_matmul", WG: "aaq_matmul_wg", F32: "aaq_matmul_f32",
                 WIDE: "aaq_matmul_wide"}
# the Hopper kernel (csrc: namespace mmwg): tokens a tile, output columns a
# product and a store, outliers a token at most, warpgroups a block at most,
# shared memory of a block, the deepest ring taken
WG_BT, WG_BN, WG_KMAX, WG_MAX_WARPGROUPS = 64, 64, 4, 4
WG_SMEM_LIMIT = 232448
WG_MAX_STAGES = 8
launches = 0        # tensor-core kernel launches (bf16 W)
wg_launches = 0     # Hopper kernel launches (bf16 W, int4, H and D multiples of 128)
f32_launches = 0    # split-W kernel launches, f32 W (three bf16 parts)
wide_launches = 0   # split-W kernel launches, bf16 W (one part)
plain_calls = 0     # calls that computed the plain version (CPU tensors)


@dataclasses.dataclass(frozen=True)
class WgPlan:
    """How the Hopper kernel lays out one block."""
    warpgroups: int     # each on its own 64-token tiles
    stages: int         # ring stages: a 64-token q tile with its sigma and outliers each
    out_buffers: int    # staged 64 x 64 output chunks a warpgroup (1 or 2)
    smem_bytes: int


def wg_stage_bytes(h: int) -> int:
    """One ring stage: the q tile, sigma, and room for 4 outliers a token."""
    return WG_BT * h // 2 + WG_BT * 4 + WG_BT * WG_KMAX * 6


def wg_smem_bytes(h: int, d: int, warpgroups: int, stages: int, out_buffers: int,
                  outliers: bool) -> int:
    """The block's shared memory (csrc: ``mmwg::smem_bytes``): alignment
    slack, W, each warpgroup's staged output chunks and, with
    outliers, its outlier tile (64 tokens x 128 k, bf16), the ring and its
    barriers."""
    per_wg = out_buffers * WG_BT * WG_BN * 2 + (WG_BT * 128 * 2 if outliers else 0)
    return 1024 + h * d * 2 + warpgroups * per_wg + stages * wg_stage_bytes(h) + 8 * stages


def wg_plan(h: int, d: int, bits: int, k: int = WG_KMAX) -> WgPlan | None:
    """The Hopper kernel's block for W (H, D) at ``bits`` with ``k`` outliers
    a token, or None where it does not take the shape: int8 inliers, H not a
    multiple of 128 up to 512 (a TMA row of q is at most 256 bytes), D not a
    multiple of 128, or W too large to stay resident beside the rest.  The
    most warpgroups (up to 4: more tiles in flight hide each one's latency),
    then the deepest ring (up to 8 stages, a multiple of the warpgroups:
    each stage serves one warpgroup, which loads it), then two staged output
    chunks a warpgroup over one (the store of one overlaps the next's
    epilogue).  That order is the one the card's times give (PERF.md, PR
    26)."""
    if bits != 4 or h % 128 or not 128 <= h <= 512 or d % 128 or d < 128:
        return None
    for warpgroups in range(WG_MAX_WARPGROUPS, 1, -1):
        best = None
        for out_buffers in (2, 1):
            fixed = wg_smem_bytes(h, d, warpgroups, 0, out_buffers, k > 0)
            stages = min(WG_MAX_STAGES, (WG_SMEM_LIMIT - fixed) // (wg_stage_bytes(h) + 8))
            stages -= stages % warpgroups   # each stage serves one warpgroup
            if stages > 0 and (best is None or stages > best.stages):
                best = WgPlan(warpgroups, stages, out_buffers,
                              wg_smem_bytes(h, d, warpgroups, stages, out_buffers, k > 0))
        if best is not None:
            return best
    return None


def variant_for(w_dtype: torch.dtype, h: int, d: int, bits: int) -> str:
    """The kernel a launch takes: a fixed rule on W's type, H, D and the
    bits.  bf16 W goes to the Hopper kernel wherever its plan takes the
    shape at 4 outliers a token (D >= 128 at the fold's shapes), else to the
    tensor-core kernel where its H fits (up to 512, a multiple of 32 at 4
    bits or of 16 at 8: the triangular bias's D = 4, where the tensor-core
    kernel already beats cuBLAS, and int8 inliers), else to the split-W
    kernel with W as its one part; f32 W to the split-W kernel with three."""
    if w_dtype != torch.bfloat16:
        return F32
    if wg_plan(h, d, bits) is not None:
        return WG
    return TC if h <= MAX_TC_H and h % (32 if bits == 4 else 16) == 0 else WIDE


def split_w(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split-W kernel's three bf16 parts of a float32 W (csrc:
    ``mmsp::w_parts``, as W is staged): w1 = bf16(w), w2 = bf16(w - w1),
    w3 = bf16(w - w1 - w2), each difference exact in float32, and w3 exact
    in bf16 (the last 8 of w's 24 significant bits), so w1 + w2 + w3 == w.
    The kernel splits W itself; this is its plain version."""
    w1 = w.to(torch.bfloat16)
    r1 = w - w1.float()
    w2 = r1.to(torch.bfloat16)
    return w1, w2, (r1 - w2.float()).to(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class MatmulLaunchArgs:
    """Everything a launch takes besides pointers and stream."""
    variant: str
    t: int
    h: int
    d: int
    k: int
    plan: WgPlan | None = None     # the Hopper variant's block


def _matmul_launch_args(inliers, scales, ovals, oidx, w, *, bits: int,
                        out_dtype) -> MatmulLaunchArgs:
    """Validate the operands of a launch and pick its variant.  Allocates and
    launches nothing, so it runs on ``meta`` tensors.  Raises on what no
    variant takes."""
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
    variant = variant_for(w.dtype, h, d, bits)
    if variant in (TC, WG) and any(a.data_ptr() % 16 for a in (inliers, scales, ovals, oidx, w)):
        how = "by TMA" if variant == WG else "16 bytes at a time"
        raise ValueError(f"aaq_matmul_kernel: the bf16 kernels read their operands {how}; "
                         "a base pointer is not 16-byte aligned")
    if t >= 2 ** 31 or t * max(k, 1) >= 2 ** 32:
        raise ValueError(f"aaq_matmul_kernel: {t} tokens exceed the kernels' 32-bit sizes")
    return MatmulLaunchArgs(variant, t, h, d, k,
                            wg_plan(h, d, bits, k) if variant == WG else None)


def aaq_matmul_kernel(inliers, scales, ovals, oidx, w, *, bits: int,
                      out_dtype=torch.float32):
    """inliers (T, H/2 or H) int8, scales (T,1) f32, ovals (T,k) bf16,
    oidx (T,k) int32, w (H, D) -> y (T, D) in ``out_dtype``."""
    global launches, wg_launches, f32_launches, wide_launches, plain_calls
    build.refuse_dtensor("aaq_matmul_kernel", inliers, scales, ovals, oidx, w)
    if inliers.device.type == "cpu":
        plain_calls += 1
        return aaq_matmul_ref(inliers, scales, ovals, oidx, w, bits=bits,
                              out_dtype=out_dtype)
    build.refuse_grad("aaq_matmul_kernel", scales, ovals, w)
    if inliers.device.type != "cuda":
        raise ValueError(f"aaq_matmul_kernel: unsupported device {inliers.device}")
    args = _matmul_launch_args(inliers, scales, ovals, oidx, w, bits=bits,
                               out_dtype=out_dtype)
    y = torch.empty((args.t, args.d), dtype=out_dtype, device=w.device)
    lib = build.library()
    ptrs = (inliers.data_ptr(), scales.data_ptr(), ovals.data_ptr(), oidx.data_ptr(),
            w.data_ptr(), y.data_ptr())
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        if args.variant == WG:
            err = lib.aaq_matmul_wg_launch(*ptrs, args.t, args.h, args.d, args.k,
                                           args.plan.warpgroups, args.plan.stages,
                                           args.plan.out_buffers, stream)
        else:
            launch = {TC: lib.aaq_matmul_launch, F32: lib.aaq_matmul_f32_launch,
                      WIDE: lib.aaq_matmul_wide_launch}[args.variant]
            err = launch(*ptrs, args.t, args.h, args.d, bits, args.k, max(args.k, 1), stream)
    build.check(err, VARIANT_NAMES[args.variant])
    if args.variant == WG:
        wg_launches += 1
    elif args.variant == TC:
        launches += 1
    elif args.variant == F32:
        f32_launches += 1
    else:
        wide_launches += 1
    return y
