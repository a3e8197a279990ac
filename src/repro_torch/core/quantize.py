"""Token-wise Adaptive Activation Quantization (AAQ) — reference path.

Port of ``repro/core/quantize.py``: the semantic definition the AAQ kernels
are held to.  Two rules keep it bitwise with the JAX reference:

  * top-k ties go to the lower index (``jax.lax.top_k``): a stable
    descending sort over ``|x|`` gives that order, ``torch.topk`` does not
    promise one;
  * ``torch.round`` rounds half to even, like ``jnp.round``.

``fake_quant_ste`` is the training path's fake-quant: the straight-through
estimator (forward ``dispatch.fake_quant``, the CUDA kernel on the card;
backward the identity), the reference's one custom gradient.
"""
from __future__ import annotations

import torch

from repro_torch.core.qtensor import QTensor, pack_int4, qmax, unpack_int4

_EPS = 1e-12


def scale_for(m: torch.Tensor, bits: int) -> torch.Tensor:
    """sigma = max(m / qmax, 1e-12) with an IEEE-rounded division.

    The divisor is a tensor on ``m``'s device: PyTorch's CUDA division by a
    Python scalar multiplies by the scalar's reciprocal, which can land one
    ulp away from the quotient the reference (and the CUDA kernel) computes.
    It is filled on the device (no host copy, which a CUDA graph capture
    does not allow).
    """
    q = torch.full((), float(qmax(bits)), dtype=m.dtype, device=m.device)
    return torch.clamp_min(m / q, _EPS)


def topk_lower_index(a: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of ``a`` along -1, ties to the
    lower index, in descending order (``jax.lax.top_k``'s order)."""
    return torch.sort(a, dim=-1, descending=True, stable=True).indices[..., :k]


def _split_outliers(x: torch.Tensor, k: int):
    """Top-k outlier split: (inlier_x, outlier_values, outlier_idx) with the
    outlier slots zeroed in ``inlier_x``."""
    if k == 0:
        zshape = (*x.shape[:-1], 0)
        return (x, torch.zeros(zshape, dtype=torch.bfloat16, device=x.device),
                torch.zeros(zshape, dtype=torch.int32, device=x.device))
    idx = topk_lower_index(x.abs(), k)
    vals = torch.gather(x, -1, idx)
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    mask.scatter_(-1, idx, True)
    inl = torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device), x)
    return inl, vals.to(torch.bfloat16), idx.to(torch.int32)


def quantize(x: torch.Tensor, bits: int, k_outliers: int) -> QTensor:
    """Uniform symmetric token-wise quantization with top-k outliers.

    M = max|inlier|;  sigma = max(M / qmax, 1e-12);  Q = round(x / sigma).
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    h = x.shape[-1]
    xf = x.float()
    inl, ovals, oidx = _split_outliers(xf, k_outliers)
    m = inl.abs().amax(dim=-1, keepdim=True)
    sigma = scale_for(m, bits)
    q = torch.clamp(torch.round(inl / sigma), -qmax(bits), qmax(bits)).to(torch.int8)
    if bits == 4:
        if q.shape[-1] % 2:                       # odd feature dim: pad a lane
            q = torch.nn.functional.pad(q, (0, 1))
        q = pack_int4(q)
    return QTensor(inliers=q, scales=sigma, outlier_values=ovals,
                   outlier_idx=oidx, bits=bits, k_outliers=k_outliers,
                   feature_dim=h, orig_dtype=x.dtype)


def dequantize(qt: QTensor) -> torch.Tensor:
    """Reconstruct x_hat: scaled inliers + outliers scattered back in place."""
    q = unpack_int4(qt.inliers) if qt.bits == 4 else qt.inliers
    q = q[..., :qt.feature_dim]                   # drop int4 pad lane if any
    x = q.float() * qt.scales
    if qt.k_outliers:
        x = x.scatter(-1, qt.outlier_idx.long(), qt.outlier_values.float())
    return x.to(qt.orig_dtype)


def fake_quant(x: torch.Tensor, bits: int, k_outliers: int) -> torch.Tensor:
    """quantize -> dequantize round trip (accuracy evaluation path)."""
    return dequantize(quantize(x, bits, k_outliers))


class _FakeQuantSTE(torch.autograd.Function):
    """``jax.custom_vjp`` of the reference's ``fake_quant_ste``: forward the
    routed fake-quant (autograd runs it with grad mode off, so on a CUDA
    tensor it is the ``aaq_fake_quant`` kernel), backward the incoming
    gradient unchanged.  Nothing is saved for the backward."""

    @staticmethod
    def forward(ctx, x, bits, k_outliers):
        # dispatch imports core (its plain versions): import it at call time
        from repro_torch.kernels import dispatch
        return dispatch.fake_quant(x, bits=bits, k_outliers=k_outliers)

    @staticmethod
    def backward(ctx, g):
        return g, None, None              # straight-through estimator


def fake_quant_ste(x: torch.Tensor, bits: int, k_outliers: int) -> torch.Tensor:
    """Fake-quant with straight-through gradients (the training path).  A
    DTensor (a sharded train step) runs the estimator on each rank's
    local rows, its last dim made whole first (``sharding.on_rows``):
    fake-quant is token-wise, so a row must sit on one rank."""
    from repro_torch.parallel import sharding as sh
    return sh.on_rows("fake_quant", lambda t: _FakeQuantSTE.apply(t, bits, k_outliers), x)


def quant_rmse(x: torch.Tensor, bits: int, k_outliers: int) -> torch.Tensor:
    """RMSE of the quantization round trip."""
    xf = x.float()
    return torch.sqrt(torch.mean((fake_quant(x, bits, k_outliers).float() - xf) ** 2))
