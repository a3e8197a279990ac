"""repro_torch — the PyTorch/CUDA port of the LightNobel reproduction.

Mirrors ``src/repro`` module for module.  Plain tensor code is PyTorch; the
three Pallas TPU kernels (AAQ quantize, AAQ matmul, flash attention) are
CUDA C++ kernels for Hopper under ``csrc/``, built with nvcc at first use
and loaded through ctypes (``repro_torch.kernels.build``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise
(``repro_torch.device.resolve_device``).
"""
