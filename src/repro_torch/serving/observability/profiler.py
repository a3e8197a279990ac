"""Bridge from the serving tracer to the PyTorch profiler (port of
``repro/serving/observability/profiler.py``).

The span tracer times *host-side* phases; ``torch.profiler`` sees the
*device* kernels.  To line the two up, the engine core wraps its
dispatch/retire bodies in ``annotate(name)``: a
``torch.profiler.record_function`` range, plus an NVTX range when the card
is in use, so a profiled run shows the engine's batch phases as named
ranges beside the kernels they launched.

"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def annotate(name: str):
    """Name the enclosed host work in profiler traces (and NVTX on CUDA)."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
