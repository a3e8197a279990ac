"""QTensor: the packed token-wise quantized activation container.

Port of ``repro/core/qtensor.py``.  Per token the memory holds
``inliers | outlier values | scaling factor | outlier indices``:

  * token          = the trailing-axis vector of the activation (Hz in PPM).
  * inliers        = uniform symmetric INT4/INT8 with a per-token dynamic
                     scale sigma = max|inlier| / (2^(m-1) - 1).
  * outliers       = the k largest-|x| entries per token, kept as bf16 and
                     not sharing sigma.  Inlier slots at outlier positions
                     hold 0.
  * INT4 packing   = two nibbles per int8 carrier byte (low nibble = even
                     column).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Token-wise quantized activation. Token axis = -1 of the original."""

    inliers: torch.Tensor          # int8; (..., H) 8-bit, (..., H//2) packed 4-bit
    scales: torch.Tensor           # f32 (..., 1) per-token sigma
    outlier_values: torch.Tensor   # bf16 (..., k)
    outlier_idx: torch.Tensor      # int32 (..., k)
    bits: int                      # 4 or 8 (inlier precision)
    k_outliers: int                # static per policy group
    feature_dim: int               # H of the original activation
    orig_dtype: torch.dtype        # dtype to dequantize back to

    def nbytes(self) -> int:
        """Exact packed footprint in bytes."""
        return sum(t.numel() * t.element_size() for t in
                   (self.inliers, self.scales, self.outlier_values,
                    self.outlier_idx))


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8,7] pairwise into nibble-packed int8 carriers.

    torch's int8 ``<<`` wraps and ``|`` stays in int8, as in JAX."""
    if q.shape[-1] % 2:
        raise ValueError("int4 packing needs an even feature dim")
    lo = q[..., 0::2] & 0x0F
    hi = (q[..., 1::2] & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; arithmetic shifts restore the sign."""
    lo = (p << 4) >> 4                      # int8 wrap, then sign-extend
    hi = p >> 4                             # arithmetic shift: sign-extends
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2).to(torch.int8)
