"""Device policy shared by every entry point of the port.

The port runs on the card.  ``resolve_device(None)`` means CUDA, and raises
when no CUDA device is present: the CPU is used only when the caller asks
for it (``device="cpu"``), as the CPU parity tests do.
"""
from __future__ import annotations

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
