"""Kernel dispatch: one routing point between the CUDA kernels and the plain
PyTorch references (port of ``repro/kernels/dispatch.py``).

Every attention, quantized-matmul, fake-quant and quantize call site (the
folding model's seq attention, triangular attention, structure module,
``AAQScheme.linear`` and ``AAQScheme.act``; the LM's attention and its
quantized KV cache) goes through ``attention`` / ``quantized_linear`` /
``fake_quant`` / ``quantize``.
The backend of a call is, in order:

  1. an explicit ``backend=`` argument,
  2. the calling thread's scoped mode (``use_backend``; each engine scopes
     its own forward, and a fleet's replicas run theirs on their own driver
     threads), else the process-wide mode (``set_backend``, the
     ``--kernels {kernel,ref,auto}`` flag),
  3. in ``auto`` mode, the device of the operands: the hand-written kernel
     on a CUDA tensor, at every shape; the plain reference on a CPU tensor.

``ref`` is an explicit request for the plain reference on any device (the
reference's ``--kernels ref``).  ``kernel`` on a CPU tensor runs the
kernel-shaped dataflow with each kernel's plain version, as the reference's
``pallas`` mode does in interpret mode off-TPU.

Gradients.  No kernel has a backward (the Pallas kernels have none either:
the reference's training differentiates its plain attention, and its one
custom gradient is the AAQ straight-through estimator).  So, decided by the
operands alone and never by a failed build or launch:

  * in ``auto`` mode, a call whose tensor operands include one that
    requires grad while grad mode is on takes the plain reference, on any
    device, counted under ``<op>.ref_grad`` (``attention.ref_grad`` for the
    LM's attention in training), not under ``<op>.ref``;
  * an explicit ``kernel`` request with such operands reaches the kernel
    wrapper, which raises (``build.refuse_grad``): a kernel's output has no
    ``grad_fn``, and a silent launch would cut the gradient of everything
    upstream;
  * ``core.quantize.fake_quant_ste`` calls ``fake_quant`` from the forward
    of a ``torch.autograd.Function``, where grad mode is off, so its
    forward is the kernel on a CUDA tensor and its backward the identity.

DTensors.  Every routed call takes local tensors and raises on a DTensor
(``build.refuse_dtensor``): a sharded train step runs attention and
fake-quant on each rank's local rows (``parallel.sharding.local_attention``
and ``on_rows``, at the model's attention and act sites).

Counters: ``counters`` counts routed calls per route; each kernel wrapper
module counts the CUDA launches of each of its kernel variants and the
calls that computed a plain version on the CPU (``launch_counts`` per
variant / ``plain_counts`` per kernel).  ``MAIN_PATH`` names the variants a
fold launches.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.core.qmatmul import qmatmul_fused_ref
from repro_torch.core.quantize import fake_quant as fake_quant_ref
from repro_torch.core.quantize import quantize as quantize_ref
from repro_torch.kernels import build
from repro_torch.kernels.aaq_matmul import aaq_matmul as _aaq_matmul_mod
from repro_torch.kernels.aaq_matmul.ops import aaq_linear
from repro_torch.kernels.aaq_quant import aaq_quant as _aaq_quant_mod
from repro_torch.kernels.aaq_quant.ops import aaq_fake_quant, aaq_quantize
from repro_torch.kernels.flash_attention import flash_attention as _flash_mod
from repro_torch.kernels.flash_attention.flash_attention import flash_mha_kernel
from repro_torch.kernels.flash_attention.ref import mha_chunked

REF = "ref"
KERNEL = "kernel"
AUTO = "auto"
BACKENDS = (REF, KERNEL, AUTO)

# kernel -> (wrapper module, its count of plain-version calls)
KERNEL_PLAIN = {
    "aaq_quantize": (_aaq_quant_mod, "plain_calls"),
    "aaq_fake_quant": (_aaq_quant_mod, "fake_plain_calls"),
    "aaq_matmul": (_aaq_matmul_mod, "plain_calls"),
    "flash_mha": (_flash_mod, "plain_calls"),
}
# kernel variant -> (wrapper module, its launch counter)
KERNEL_VARIANTS = {
    "aaq_quantize": (_aaq_quant_mod, "launches"),           # q, scales, outliers
    "aaq_fake_quant": (_aaq_quant_mod, "fake_launches"),    # x_hat only
    "aaq_matmul": (_aaq_matmul_mod, "launches"),            # bf16 W, mma.sync (D = 4)
    "aaq_matmul_wg": (_aaq_matmul_mod, "wg_launches"),      # bf16 W, int4: wgmma + TMA
    "aaq_matmul_f32": (_aaq_matmul_mod, "f32_launches"),    # f32 W: three exact bf16 parts
    "aaq_matmul_wide": (_aaq_matmul_mod, "wide_launches"),  # bf16 W at any H: one part
    "flash_mha": (_flash_mod, "launches"),                  # bf16, tensor cores (mma.sync)
    "flash_mha_wg": (_flash_mod, "wg_launches"),            # the fold's: wgmma + TMA
    "flash_mha_dec": (_flash_mod, "dec_launches"),          # one query row: split keys, a cluster
    "flash_mha_pf": (_flash_mod, "pf_launches"),            # prefill, no bias: wgmma + TMA
    "flash_mha_f32": (_flash_mod, "f32_launches"),          # f32 (and D > 256): 3xTF32 mma.sync
    "flash_mha_f32_dec": (_flash_mod, "f32_dec_launches"),  # f32 decode: split keys, a cluster
}
# the variants every fold on the card launches (bf16 weights and activations;
# ``aaq_matmul`` is the triangular bias's D = 4 linear)
MAIN_PATH = ("aaq_quantize", "aaq_fake_quant", "aaq_matmul", "aaq_matmul_wg", "flash_mha_wg")

_MODE = AUTO
_SCOPED = threading.local()          # .mode: the thread's use_backend mode

#: routed calls: ``<op>.kernel``, ``<op>.ref`` and ``<op>.ref_grad`` (the
#: plain reference taken in ``auto`` mode because an operand requires grad)
counters: dict[str, int] = {f"{op}.{route}": 0
                            for op in ("attention", "qmatmul", "fakequant", "quantize")
                            for route in ("kernel", "ref", "ref_grad")}


def reset_counters() -> None:
    """Zero the routing counters and every kernel's launch/plain counts."""
    for k in counters:
        counters[k] = 0
    for mod, attr in (*KERNEL_VARIANTS.values(), *KERNEL_PLAIN.values()):
        setattr(mod, attr, 0)


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNEL_VARIANTS.items()}


def plain_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNEL_PLAIN.items()}


def _check(mode: str) -> str:
    if mode not in BACKENDS:
        raise ValueError(f"unknown kernel backend {mode!r}; pick one of {BACKENDS}")
    return mode


def set_backend(mode: str) -> None:
    """Set the process-wide backend mode (the ``--kernels`` flag)."""
    global _MODE
    _MODE = _check(mode)


def get_backend() -> str:
    """The calling thread's scoped mode, else the process-wide one."""
    return getattr(_SCOPED, "mode", None) or _MODE


@contextlib.contextmanager
def use_backend(mode: str):
    """Scoped backend mode for the calling thread."""
    prev = getattr(_SCOPED, "mode", None)
    _SCOPED.mode = _check(mode)
    try:
        yield
    finally:
        _SCOPED.mode = prev


def resolve(device: torch.device, *, backend: str | None = None) -> str:
    """The backend a call on ``device`` takes: ``kernel`` or ``ref``."""
    mode = _check(backend) if backend is not None else get_backend()
    if mode != AUTO:
        return mode
    return KERNEL if torch.device(device).type == "cuda" else REF


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _route(op: str, device: torch.device, backend: str | None, operands) -> bool:
    """Count and decide one routed call of ``op``: True for the kernel.
    Local tensors only: a DTensor operand raises on either route."""
    build.refuse_dtensor(op, *operands)
    mode = _check(backend) if backend is not None else get_backend()
    if mode == AUTO and _needs_grad(operands):
        counters[f"{op}.ref_grad"] += 1
        return False
    kernel = resolve(device, backend=mode) == KERNEL
    counters[f"{op}.{KERNEL if kernel else REF}"] += 1
    return kernel


def attention_is_kernel(device: torch.device, *, backend: str | None = None) -> bool:
    """Will ``attention`` take the kernel path on this device?  Triangular
    attention uses this to pick its rows-as-batch dataflow before building
    operands."""
    return resolve(device, backend=backend) == KERNEL


def describe(backend: str | None = None, device: torch.device | str = "cuda") -> str:
    """Report label for the backend a mode resolves to on ``device``:
    ``kernel``, ``ref``, ``auto:kernel``/``auto:ref``; a kernel request on
    the CPU reads ``kernel-plain`` (the plain versions compute it)."""
    mode = _check(backend) if backend is not None else get_backend()
    inner = resolve(device, backend=mode)
    if inner == KERNEL and torch.device(device).type == "cpu":
        inner = "kernel-plain"
    return f"auto:{inner}" if mode == AUTO else inner


# --------------------------------------------------------------------------
# routed ops
# --------------------------------------------------------------------------
def attention(q, k, v, *, bias=None, causal=False, window=None,
              kv_valid_len=None, softmax_scale=None, q_chunk=512, q_offset=0,
              backend=None):
    """Token-wise MHA: q (B,Sq,Hq,D); k (B,Skv,Hkv,D); v (B,Skv,Hkv,Dv) with
    Dv <= D; bias (Bb,Hq,Sq,Skv) with block batch-broadcast (bias row t
    covers B//Bb consecutive q rows).  -> (B,Sq,Hq,Dv).

    Kernel path: the CUDA flash kernel.  The kernel takes one head dim, so
    a narrower v (MLA: q/k 192, v 128) is padded with zero columns to D and
    the output sliced back: exact, the padded columns are sums of zeros.
    Ref path: ``mha_chunked``, v as it is (and the path of operands that
    require grad in ``auto`` mode: the reference's training attention).
    ``q_offset``: the keys' position of q's first row, for a block of the
    query rows under a causal or window mask (a sharded step's; the plain
    path takes it, the kernel raises).
    """
    if _route("attention", q.device, backend, (q, k, v, bias)):
        if q_offset and (causal or window is not None):
            raise ValueError("flash_mha_kernel: a causal or window mask at a query offset "
                             "is not a kernel launch; take the plain route")
        dv = v.shape[-1]
        if dv < q.shape[-1]:
            v = F.pad(v, (0, q.shape[-1] - dv))
        o = flash_mha_kernel(q, k, v, bias, kv_valid_len, causal=causal,
                             window=window, softmax_scale=softmax_scale)
        return o if o.shape[-1] == dv else o[..., :dv]
    return mha_chunked(q, k, v, bias=bias, causal=causal, window=window,
                       kv_valid_len=kv_valid_len, softmax_scale=softmax_scale,
                       q_chunk=q_chunk, q_offset=q_offset)


def quantized_linear(x, w, *, bits: int, k_outliers: int, bias=None,
                     backend=None):
    """AAQ linear  y = dequant-free-matmul(quantize(x), w) (+ bias).

    Kernel path: the aaq_quant + aaq_matmul CUDA kernels on INT4/INT8
    inliers with the deferred per-token scale.  Ref path:
    ``qmatmul_fused_ref`` (the same integer-path math in plain PyTorch).
    """
    if _route("qmatmul", x.device, backend, (x, w)):
        y = aaq_linear(x, w, bits=bits, k_outliers=k_outliers)
    else:
        y = qmatmul_fused_ref(x, w, bits, k_outliers)
    return y if bias is None else y + bias


def fake_quant(x, *, bits: int, k_outliers: int, backend=None):
    """AAQ fake-quant  x_hat = dequantize(quantize(x)), in x's dtype.

    Kernel path: the aaq_fake_quant CUDA kernel (one launch, x_hat is all it
    writes).  Ref path: ``quantize.fake_quant`` (the reference dataflow).
    ``quantize.fake_quant_ste`` wraps this call in a straight-through
    gradient.
    """
    if _route("fakequant", x.device, backend, (x,)):
        return aaq_fake_quant(x, bits, k_outliers)
    return fake_quant_ref(x, bits, k_outliers)


def quantize(x, *, bits: int, k_outliers: int, backend=None):
    """AAQ quantize  x -> QTensor (token axis -1), the packed form the LM's
    KV cache stores.

    Kernel path: the aaq_quantize CUDA kernel.  Ref path:
    ``quantize.quantize`` (the reference dataflow).
    """
    if _route("quantize", x.device, backend, (x,)):
        return aaq_quantize(x, bits, k_outliers)
    return quantize_ref(x, bits, k_outliers)
