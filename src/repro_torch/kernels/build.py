"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source is compiled for Hopper (``sm_90a``) by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  Nothing here runs at
import time: the first launch of a kernel builds the library, and the
library is cached under ``<repo>/build/`` by a hash of the sources and
flags, so a second process reuses it.  ptxas's resource report (registers
and spills of every kernel) is kept beside the library (``ptxas_resources``).

No ``--use_fast_math``: the quantize kernel divides with IEEE rounding
(``inl / sigma``, ``m / qmax``), as the reference does, and is held to it
bitwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_MATMUL = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_MATMUL_WG = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_FLASH = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
          _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _F, _P]
# ..., the plan's two ints (Hopper: rows a block, bias box; decode: keys a
# split, splits a slot), stream
_FLASH_PLAN = _FLASH[:-1] + [_I, _I, _P]
# ..., the float32 plan (panel columns, instance columns, rows a block, keys
# a tile, Q in shared memory), stream
_FLASH_F32 = _FLASH[:-1] + [_I, _I, _I, _I, _I, _P]
# C entry point -> argument types (pointers and the stream are void*;
# strides are int64_t)
SIGNATURES: dict[str, list] = {
    # x, x_is_bf16, q, scale, ovals, oidx, T, H, bits, k, stream
    "aaq_quantize_launch": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, x_is_bf16, xhat, T, H, bits, k, stream
    "aaq_fake_quant_launch": [_P, _I, _P, _I, _I, _I, _I, _P],
    # q, scale, ovals, oidx, w, y, T, H, D, bits, k, kk, stream
    "aaq_matmul_launch": _MATMUL,          # bf16 W, tensor cores
    "aaq_matmul_f32_launch": _MATMUL,      # f32 W: split-W, three bf16 parts
    "aaq_matmul_wide_launch": _MATMUL,     # bf16 W at any H: split-W, one part
    # q, scale, ovals, oidx, w, y, T, H, D, k, warpgroups, ring stages,
    # output buffers, stream
    "aaq_matmul_wg_launch": _MATMUL_WG,    # bf16 W, int4, H and D % 128: wgmma + TMA
    # q, k, v, bias, kvlen, o, qkv_is_bf16, bias_kind, B, Sq, Skv, Hq, Hkv, D,
    # Bb, q strides (b,s,h), k strides, v strides, bias strides (b,h,q,k),
    # causal, window, scale, stream
    "flash_mha_launch": _FLASH,            # bf16, D in 16..256, tensor cores
    "flash_mha_wg_launch": _FLASH_PLAN,    # the fold's: bf16, D 32/64, wgmma + TMA
    "flash_mha_dec_launch": _FLASH_PLAN,   # one query row, no bias: split keys, a cluster
    "flash_mha_pf_launch": _FLASH,         # prefill, no bias: wgmma + TMA
    # float32 (and D > 256), 3xTF32 mma.sync: the whole F32Plan, and the
    # decode kernel's (keys a split, splits a slot)
    "flash_mha_f32_launch": _FLASH_F32,
    "flash_mha_f32_dec_launch": _FLASH_PLAN,
}

_LIB: ctypes.CDLL | None = None
PTXAS_REPORT = "ptxas.txt"
build_seconds: float | None = None   # wall time of this process's build (None: cached)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda (in that order)."""
    cand = [Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"] if os.environ.get("CUDA_HOME") else []
    found = shutil.which("nvcc")
    cand += [Path(found)] if found else []
    cand.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cand:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit ($CUDA_HOME, $PATH or /usr/local/cuda)")


def compile_commands(nvcc: str, srcs: list[Path], out_dir: Path) -> list[list[str]]:
    """One ``nvcc -c`` per source; they run in parallel."""
    return [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(out_dir / f"{s.stem}.o")]
            for s in srcs]


def link_command(nvcc: str, objs: list[Path], lib: Path) -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in (*srcs, *headers()):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _build(lib: Path, srcs: list[Path]) -> None:
    nvcc = nvcc_path()
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        tmpd = Path(tmp)
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in compile_commands(nvcc, srcs, tmpd)]
        errors, reports = [], []
        for cmd, p in procs:
            out, _ = p.communicate()
            reports.append(out)
            if p.returncode:
                errors.append(f"$ {' '.join(cmd)}\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        (lib.parent / PTXAS_REPORT).write_text("".join(reports))
        staged = tmpd / lib.name
        res = subprocess.run(link_command(nvcc, [tmpd / f"{s.stem}.o" for s in srcs], staged),
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(staged, lib)       # atomic: a concurrent loader sees all or nothing


def _lib_path() -> Path:
    return BUILD_DIR / f"repro_torch_kernels-{_digest(sources())}" / "libreprokernels.so"


def ptxas_resources() -> dict[str, tuple[int, int]]:
    """The built library's kernels, by mangled name: (registers a thread,
    bytes spilled: stores plus loads), from ptxas's report."""
    out: dict[str, tuple[int, int]] = {}
    name, spill = None, 0
    for line in (_lib_path().parent / PTXAS_REPORT).read_text().splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spill = m[1], 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m[1]) + int(m[2])
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out[name] = (int(m[1]), spill)
            name = None
    return out


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB, build_seconds
    if _LIB is None:
        srcs = sources()
        lib = _lib_path()
        if not lib.exists():
            t0 = time.perf_counter()
            _build(lib, srcs)
            build_seconds = time.perf_counter() - t0
        cdll = ctypes.CDLL(str(lib))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = cdll
    return _LIB


# steps of a launch named in its status (csrc/hopper.cuh: hopper::status)
LAUNCH_STEPS = {1: "argument or device query", 2: "shared-memory attribute",
                3: "grid or occupancy", 4: "kernel launch", 5: "TMA tensor map",
                9: "an error pending before the launch"}


def check(err: int, what: str) -> None:
    """Raise on a non-zero launch status: the ``cudaError_t`` in the low 16
    bits and the failing step above them."""
    if err:
        code, step = err & 0xFFFF, err >> 16
        where = f" at step {step} ({LAUNCH_STEPS[step]})" if step in LAUNCH_STEPS else ""
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}{where}")


def refuse_dtensor(what: str, *tensors) -> None:
    """A kernel reads its operands' storage, which on a DTensor is one
    rank's shard: raise before anything reads it, whatever the device
    (on the CPU the plain version would otherwise compute on the DTensor
    unseen).  A sharded caller hands the kernel each rank's local rows
    (``parallel.sharding.on_rows``).  (No DTensor exists before
    ``torch.distributed.tensor`` is imported.)"""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is not None and any(isinstance(t, mod.DTensor) for t in tensors):
        raise TypeError(f"{what}: got a DTensor; a kernel takes local tensors "
                        "(run it on each rank's rows, parallel.sharding.on_rows)")


def refuse_grad(what: str, *tensors) -> None:
    """No kernel of the port has a backward, and its output carries no
    ``grad_fn``: raise when grad mode is on and an input requires grad,
    before anything touches a device, instead of cutting the gradient of
    everything upstream.  Differentiable callers run a plain version
    (``dispatch``'s rule) or a ``torch.autograd.Function`` whose forward
    calls the kernel with grad mode off (the AAQ straight-through
    estimator)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: an input requires grad and the kernel has no backward; "
                           "run the plain version (dispatch backend 'auto' or 'ref')")
