"""Device policy shared by every entry point of the port.

The port runs on the card.  ``resolve_device(None)`` means CUDA, and raises
when no CUDA device is present: the CPU is used only when the caller asks
for it (``device="cpu"``), as the CPU parity tests do.
"""
from __future__ import annotations

import contextlib
import threading

import torch


def set_precise_matmul() -> None:
    """Full-precision float32 products and no reduced-precision bf16 split
    reductions: the JAX reference accumulates every product in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path explicitly")
    set_precise_matmul()
    return dev


_ROWS = threading.local()


@contextlib.contextmanager
def rows_alone(on: bool = True):
    """A scope (a float32 fold: ``ppm_forward``) in which ``per_row`` runs a
    product on the card one batch row at a time.  cuBLAS picks a product's
    algorithm by its shape, so a batch of 4 would round a row otherwise
    than the same row alone, and the ~1e-6 it moves flips AAQ bins
    downstream; a row alone is the batch-1 product, so a fold's rows are
    bitwise the same protein folded alone.  ``on`` False (a bf16 fold: the
    main path, bitwise across batches already), the CPU and everything
    outside the scope are unchanged."""
    prev = getattr(_ROWS, "on", False)
    _ROWS.on = on
    try:
        yield
    finally:
        _ROWS.on = prev


def per_row(fn, *xs):
    """``fn(*xs)`` (a product of tensors that share their leading batch dim,
    row by row independent), one row at a time and concatenated where a
    ``rows_alone`` scope is on and ``xs[0]`` is a CUDA batch of more than
    one row (a float32 fold's products, and its fp16 ones under the
    baseline scheme); else ``fn(*xs)``.  In such a scope the result is
    contiguous at every batch size, as the concatenation is: an einsum's
    own result is a permuted view, and a reduction over it (the tri-mul's
    LayerNorm) sums in another order than over the contiguous batch."""
    x = xs[0]
    on = getattr(_ROWS, "on", False) and x.is_cuda
    if not (on and x.dim() >= 3 and x.shape[0] > 1):
        out = fn(*xs)
        return out.contiguous() if on else out
    return torch.cat([fn(*(t[i:i + 1] for t in xs)) for i in range(x.shape[0])])
