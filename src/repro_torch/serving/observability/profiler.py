"""Bridge from the serving tracer to the PyTorch profiler (port of
``repro/serving/observability/profiler.py``).

The span tracer times *host-side* phases; ``torch.profiler`` sees the
*device* kernels.  To line the two up, the engine core wraps its
dispatch/retire bodies in ``annotate(name)``: a
``torch.profiler.record_function`` range, plus an NVTX range when the card
is in use, so a profiled run shows the engine's batch phases as named
ranges beside the kernels they launched.

``profile(dir)`` is the run-level context the launchers use (the
counterpart of the reference's ``jax_profile``, ``--profile DIR``): a
``torch.profiler`` capture of the host, every thread of the process (the
engine's ``--driver thread`` dispatches and retires on its own), and, when
the card is in use, its kernels, written on exit by
``tensorboard_trace_handler`` as one Chrome trace into ``dir`` (TensorBoard's
profiler plugin reads the directory; Perfetto opens the file), and a no-op
when ``dir`` is falsy or the profiler cannot start.
"""
from __future__ import annotations

import contextlib
from pathlib import Path

import torch


def _card_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def annotate(name: str):
    """Name the enclosed host work in profiler traces (and NVTX on CUDA)."""
    nvtx = _card_in_use()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def step_annotation(name: str, step: int):
    """A range named ``f"{name}:{step}"`` (the reference's fallback for
    its profiler step markers)."""
    return annotate(f"{name}:{step}")


#: whether a ``profile`` capture is recording: an all-thread capture is
#: not seen by ``_profiler_enabled()``, which reads this thread's state
_RECORDING = False


def _all_threads():
    """The profiler's setting that records every thread's ranges, or None
    where this torch lacks it (then only the starting thread's are)."""
    try:
        return torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def profile(log_dir: str | None):
    """Run-level ``torch.profiler`` capture into ``log_dir``; yields True
    while it records.  Yields False and records nothing when ``log_dir``
    is falsy or the profiler cannot start (another capture is active)."""
    global _RECORDING
    if not log_dir:
        yield False
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if _card_in_use():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    config = _all_threads()
    if config is None:
        print(f"# profile: torch {torch.__version__} records only this thread's ranges; "
              "those of other threads (the engine's --driver thread) are not recorded",
              flush=True)
    prof = torch.profiler.profile(activities=activities, experimental_config=config,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(
                                      log_dir))
    try:
        if _RECORDING or torch._C._autograd._profiler_enabled():
            # a second start would end the capture already running
            raise RuntimeError("another profiler capture is active")
        prof.start()
    except RuntimeError as e:
        print(f"# profile disabled ({e!r})", flush=True)
        yield False
        return
    _RECORDING = True
    before = set(Path(log_dir).glob("*.pt.trace.json"))
    try:
        yield True
    finally:
        _RECORDING = False
        prof.stop()
        for path in sorted(set(Path(log_dir).glob("*.pt.trace.json")) - before):
            print(f"# profile -> {path}", flush=True)
