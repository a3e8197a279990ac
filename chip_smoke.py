#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card (nvidia-smi name and power limit), torch, CUDA
     and nvcc versions; no CUDA device -> exit 1;
  2. build: the CUDA kernels from ``src/repro_torch/csrc``;
  3. each kernel variant against its plain PyTorch version on the card at
     the main path's shapes and at long N (seq attention at N = 1024 and
     2048, triangular attention at N = 1024), with its time at every
     main-path shape, the plain version's, the least time the card could
     take (``bound_ms``) and one PyTorch library call's; both forms of the
     AAQ quantize kernel (``aaq_quantize`` for the linears, the fake-quant
     ``aaq_fake_quant`` for the ``act`` sites) bitwise;
  4. whole forward, kernels vs the plain references, 2 blocks at full
     esmfold_ppm width, one padded request, with two controls that the
     lightnobel_aaq gate must reject;
  5. the sequential server at full esmfold_ppm width (48 blocks, bf16,
     seeded random weights): 4 short requests, then one of 1,000 residues
     in bucket 1,024; in each run every main-path kernel launched and no
     plain version ran; then one profiled fold per scheme at N = 250
     (device-busy share, top kernels, each kernel's device time) and the
     main-path launches per fold at each kernel shape, with one
     ``aaq_fake_quant`` launch for each enabled ``AAQScheme.act`` call;
  6. summary: one JSON line of the kernels, the card, and the last line
     ``{"ok": true, "device": {...}}``.

Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SERVE_BUCKETS = (96, 192, 256, 1024)
SERVE_N = 4
LONG_LEN = 1000             # one long request, served alone in bucket 1024
FWD_BUCKET = 256
FWD_LEN = 230
# TM floor of the kernels against the plain references over a 2-block
# full-width forward, under either scheme.  The bucket is 256 because there
# both routes take triangular attention's rows-as-batch dataflow; below 256
# the ref route takes the einsum one, which also fake-quantizes the
# probabilities, and the comparison would read that route difference, not
# the kernels.  The floor sits between the kernels' readings and two
# controls that must fall below it: a fold whose flash launches drop the
# bias, and one whose aaq_matmul launches drop the outlier term (readings
# in PERF.md).
TM_GATE = 0.9995

# kernel variant -> (CUDA source, the Pallas kernel it replaces)
VARIANTS = {
    "aaq_quantize": ("aaq_quant.cu", "src/repro/kernels/aaq_quant/aaq_quant.py:53"),
    "aaq_matmul": ("aaq_matmul.cu", "src/repro/kernels/aaq_matmul/aaq_matmul.py:47"),
    "flash_mha": ("flash_attention.cu", "src/repro/kernels/flash_attention/flash_attention.py:93"),
}
VARIANTS.update(aaq_fake_quant=VARIANTS["aaq_quantize"],
                aaq_matmul_f32=VARIANTS["aaq_matmul"], flash_mha_simt=VARIANTS["flash_mha"])
# (H, D) of every aaq_matmul call of a fold: the tri-attention bias, the
# pair projections, tri-attention's qkv, tri-mul's packed projection,
# the pair transition's down projection
MATMUL_SHAPES = ((128, 4), (128, 128), (128, 384), (128, 512), (512, 128))
# (H, bits, k) of every quantize call of a fold: group B (post-LayerNorm, the
# linears' and acts' most common), group C at H = 128 and at the pair
# transition's H = 512, group A (acts only)
QUANT_SHAPES = ((128, 4, 4), (128, 4, 0), (512, 4, 0), (128, 8, 4))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def call_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA events
    (includes the gaps where the device waits for the host to launch)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls: the summed duration
    of every device kernel and copy it ran, from ``torch.profiler`` (host
    gaps between launches excluded)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        fail("torch.profiler recorded no device time")
    return us / 1e3 / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@dataclasses.dataclass
class KernelRow:
    """One kernel variant at one shape: the JSON row of a variant is its
    first (timed) shape; ``shapes`` keeps every main-path shape."""
    name: str
    source: str
    replaces: str
    shape: str = ""
    max_abs_err: float = 0.0
    ms: float = 0.0
    plain_ms: float | None = 0.0
    bound_ms: float = 0.0
    bound_by: str = ""
    library_ms: float | None = None
    launches: int = 0
    call_ms: float = 0.0        # CUDA-event time of back-to-back calls (log only)

    def record(self) -> dict:
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "shape": self.shape,
                "launches": self.launches, "max_abs_err": self.max_abs_err,
                "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": self.bound_by,
                "library_ms": self.library_ms}

    def line(self) -> str:
        lib = "none" if self.library_ms is None else f"{self.library_ms:.4f}"
        plain = "not timed" if self.plain_ms is None else f"{self.plain_ms:.4f}"
        return (f"{self.name} [{self.shape}]: kernel_ms={self.ms:.4f} "
                f"call_ms={self.call_ms:.4f} "
                f"bound_ms={self.bound_ms:.4f} ({self.bound_by}, "
                f"{100 * self.bound_ms / self.ms:.1f}% of bound) plain_ms={plain} "
                f"library_ms={lib} max_abs_err={self.max_abs_err:.3e}")


def _row(name: str, shape: str) -> KernelRow:
    src, pallas = VARIANTS[name]
    return KernelRow(name, f"src/repro_torch/csrc/{src}", pallas, shape)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def _bitwise(torch, a, b) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _linear_input(torch, g, t: int, h: int):
    """A quantized linear's input as the fold makes it: a fake-quantized
    activation (group B at H = 128, group C after a ReLU at H = 512)."""
    from repro_torch.kernels.aaq_quant.aaq_quant import aaq_fake_quant_kernel
    x = torch.randn((t, h), generator=g, device="cuda").to(torch.bfloat16)
    return aaq_fake_quant_kernel(x, 4, 4) if h == 128 else aaq_fake_quant_kernel(x.relu(), 4, 0)


def check_quantize(torch, rows: dict) -> None:
    """Both forms of the quantize kernel, bitwise against their plain
    versions, then timed at every quantize shape of the main path."""
    from repro_torch.kernels.aaq_quant.aaq_quant import (aaq_fake_quant_kernel,
                                                         aaq_quantize_kernel)
    from repro_torch.kernels.aaq_quant.ref import aaq_fake_quant_ref, aaq_quantize_ref
    g = torch.Generator(device="cuda").manual_seed(1)
    t = 256 * 256
    cases = [(h, bits, k, dt) for h in (128, 512) for bits in (4, 8)
             for k in (0, 4) for dt in (torch.bfloat16,)]
    cases += [(128, 4, 4, torch.float32), (32, 4, 4, torch.float32)]
    for h, bits, k, dt in cases:
        for tt in (t, t - 1):                                    # odd T too
            x = (torch.randn((tt, h), generator=g, device="cuda") * 2).to(dt)
            x[:64] = 0                                          # all-zero (padded) tokens
            x[64:128, : h // 2] = 1.5                           # ties on many lanes
            x[128, 5] = 60.0
            x[129] = 0.25                                       # 16 equal maxima across
            x[129, 8:24] = torch.tensor([5.0, -5.0] * 8, device="cuda").to(dt)  # two lanes
            x[130, 16:20] = torch.tensor([50.0, -50.0, 40.0, -40.0], device="cuda").to(dt)
            got = aaq_quantize_kernel(x, bits=bits, k_outliers=k)
            want = aaq_quantize_ref(x, bits, k)
            torch.cuda.synchronize()
            for name, a, b in zip(("inliers", "scales", "ovals", "oidx"), got, want):
                if not _bitwise(torch, a, b):
                    fail(f"aaq_quantize {name} not bitwise equal at T={tt} H={h} "
                         f"bits={bits} k={k} {dt}")
            got = aaq_fake_quant_kernel(x, bits, k)
            want = aaq_fake_quant_ref(x, bits, k)
            torch.cuda.synchronize()
            if got.dtype != dt or not _bitwise(torch, got, want):
                fail(f"aaq_fake_quant x_hat not bitwise equal at T={tt} H={h} "
                     f"bits={bits} k={k} {dt}")
    # the linears' inputs on the fold are fake-quantized activations (many
    # exact zeros, values on a grid); the pair transition's follow a ReLU
    for h, bits, k in QUANT_SHAPES[:3]:
        x = _linear_input(torch, g, t, h)
        for name, a, b in zip(("inliers", "scales", "ovals", "oidx"),
                              aaq_quantize_kernel(x, bits=bits, k_outliers=k),
                              aaq_quantize_ref(x, bits, k)):
            if not _bitwise(torch, a, b):
                fail(f"aaq_quantize {name} not bitwise equal on a fake-quantized input "
                     f"H={h} bits={bits} k={k}")
    log(f"aaq_quantize, aaq_fake_quant: bitwise equal to their plain versions on "
        f"{2 * len(cases)} cases each (T = 65536 and 65535, all-zero rows, ties, 16 equal "
        "maxima across two lanes, all outliers in one lane); aaq_quantize also on 3 "
        "fake-quantized inputs")
    timed = ([("aaq_quantize", shape, False) for shape in QUANT_SHAPES]
             + [("aaq_quantize", shape, True) for shape in QUANT_SHAPES[:3]]
             + [("aaq_fake_quant", shape, False) for shape in QUANT_SHAPES])
    for name, (h, bits, k), linear_input in timed:   # the main path's shapes, bf16
        x = (_linear_input(torch, g, t, h) if linear_input else
             torch.randn((t, h), generator=g, device="cuda").to(torch.bfloat16))
        if name == "aaq_quantize":
            kern = lambda: aaq_quantize_kernel(x, bits=bits, k_outliers=k)  # noqa: E731
            plain = lambda: aaq_quantize_ref(x, bits, k)                    # noqa: E731
        else:
            kern = lambda: aaq_fake_quant_kernel(x, bits, k)                # noqa: E731
            plain = lambda: aaq_fake_quant_ref(x, bits, k)                  # noqa: E731
        out = kern()
        row = _row(name, f"x ({t}, {h}) bf16{' fake-quantized' if linear_input else ''}, "
                         f"bits {bits}, k {k}")
        row.ms = time_ms(torch, kern)
        row.call_ms = call_ms(torch, kern)
        row.plain_ms = time_ms(torch, plain, iters=5)
        row.bound_ms, row.bound_by = bound_ms(
            nbytes(x, *(out if isinstance(out, tuple) else (out,))), 0)
        rows.setdefault(name, []).append(row)
        log(row.line())


def check_matmul(torch, rows: dict) -> None:
    from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel
    from repro_torch.kernels.aaq_matmul.ref import aaq_matmul_ref
    from repro_torch.kernels.aaq_quant.ref import aaq_quantize_ref
    g = torch.Generator(device="cuda").manual_seed(2)
    t = 256 * 256
    # Both sides sum the same exact float32 products in different orders and
    # round once to the output type: allow one bf16 ulp (2^-7 relative) plus
    # float32 reassociation of H terms (1e-4 of the largest output).
    cases = [(128, 4, 4), (128, 128, 4), (128, 384, 4), (128, 512, 4), (512, 128, 4),
             (128, 128, 8), (512, 128, 8)]                     # (H, D, bits)
    worst, n_cases = 0.0, 0
    for h, d, bits in cases:
        for k in (0, 4):
            for dt in (torch.bfloat16, torch.float32) if (h, d) == (128, 128) else (torch.bfloat16,):
                x = torch.randn((t - 3, h), generator=g, device="cuda").to(dt)
                x[:64] = 0
                w = (torch.randn((h, d), generator=g, device="cuda") / math.sqrt(h)).to(dt)
                q, s, ov, oi = aaq_quantize_ref(x, bits, k)
                got = aaq_matmul_kernel(q, s, ov, oi, w, bits=bits, out_dtype=dt).float()
                want = aaq_matmul_ref(q, s, ov, oi, w, bits=bits, out_dtype=dt).float()
                torch.cuda.synchronize()
                rtol = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
                err = (got - want).abs()
                tol = rtol * want.abs() + 1e-4 * want.abs().max()
                if not bool((err <= tol).all()) or not bool(torch.isfinite(got).all()):
                    fail(f"aaq_matmul H={h} D={d} bits={bits} k={k} {dt}: max err "
                         f"{float(err.max()):.3e} over tolerance")
                worst = max(worst, float(err.max()))
                n_cases += 1
    log(f"aaq_matmul: allclose (rtol one bf16 ulp 2^-7 / 1e-5 for f32, atol 1e-4*max|y|) "
        f"on {n_cases} cases (T = 65533; bf16 W on the tensor cores, f32 W on the SIMT "
        f"kernel), worst max|err| {worst:.3e}")
    # timing at every main-path shape (bf16, bits 4, k 4), then the f32 variant
    timed = [("aaq_matmul", torch.bfloat16, hd) for hd in MATMUL_SHAPES]
    for name, dt, (h, d) in timed + [("aaq_matmul_f32", torch.float32, (128, 128))]:
        x = torch.randn((t, h), generator=g, device="cuda").to(dt)
        w = (torch.randn((h, d), generator=g, device="cuda") / math.sqrt(h)).to(dt)
        q, s, ov, oi = aaq_quantize_ref(x, 4, 4)
        y = aaq_matmul_kernel(q, s, ov, oi, w, bits=4, out_dtype=dt)
        want = aaq_matmul_ref(q, s, ov, oi, w, bits=4, out_dtype=dt)
        row = _row(name, f"q ({t}, {h // 2}) int4 packed, W ({h}, {d}) "
                         f"{'bf16' if dt == torch.bfloat16 else 'f32'}, bits 4, k 4")
        row.max_abs_err = float((y.float() - want.float()).abs().max())
        row.ms = time_ms(torch, lambda: aaq_matmul_kernel(q, s, ov, oi, w, bits=4,
                                                          out_dtype=dt))
        row.call_ms = call_ms(torch, lambda: aaq_matmul_kernel(q, s, ov, oi, w, bits=4,
                                                               out_dtype=dt))
        row.plain_ms = time_ms(torch, lambda: aaq_matmul_ref(q, s, ov, oi, w, bits=4,
                                                             out_dtype=dt), iters=5)
        row.library_ms = time_ms(torch, lambda: x @ w)       # unquantized x @ W
        row.bound_ms, row.bound_by = bound_ms(nbytes(q, s, ov, oi, w, y), 2 * t * h * d)
        rows.setdefault(name, []).append(row)
        log(row.line())


def _attn_case(torch, g, name, b, n, hq, hkv, d, dt, *, bias=None, causal=False,
               window=None, rows_as_batch=False, pad=0):
    """Inputs of one attention case.  ``bias="f32"``: a contiguous
    (B, H, N, N) f32 bias (the structure module's); ``bias="seq"``: seq
    attention's, an f32 bias permuted from (B, N, N, H).  ``rows_as_batch``:
    triangular attention's (B*N, N, H, D) views of a (B, N, N, 3*H*D)
    projection and a transposed bf16 (B, H, N, N) bias; ``pad`` trailing
    keys are padding."""
    kvlen = None
    if rows_as_batch:
        qkv = torch.randn((1, n, n, 3 * hq * d), generator=g, device="cuda").to(dt)
        q, k, v = (a.reshape(n, n, hq, d) for a in torch.split(qkv, hq * d, dim=-1))
        v = v * (torch.arange(n, device="cuda") < n - pad)[None, :, None, None].to(dt)
        bias = torch.randn((1, n, n, hq), generator=g, device="cuda").to(torch.bfloat16)
        bias = bias.permute(0, 3, 1, 2)
        kvlen = torch.full((n,), n - pad, dtype=torch.int32, device="cuda")
    else:
        q = torch.randn((b, n, hq, d), generator=g, device="cuda").to(dt)
        k = torch.randn((b, n, hkv, d), generator=g, device="cuda").to(dt)
        v = torch.randn((b, n, hkv, d), generator=g, device="cuda").to(dt)
        if bias == "f32":
            bias = torch.randn((b, hq, n, n), generator=g, device="cuda")
        elif bias == "seq":
            bias = torch.randn((b, n, n, hq), generator=g, device="cuda").permute(0, 3, 1, 2)
        if bias is not None and pad:
            bias[..., n - pad:] += -1e9                     # key-padding fold
    return dict(name=name, q=q, k=k, v=v, bias=bias, kvlen=kvlen, causal=causal,
                window=window)


def _flash_close(torch, got, want, v, name):
    """Same float32 online softmax as the plain version, summed in another
    order: one ulp of the output type (2^-7 bf16, 1e-5 f32) relative, plus
    1e-4 of max|v| for reassociation and expf/torch.exp differences."""
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    rtol = 2.0 ** -7 if v.dtype == torch.bfloat16 else 1e-5
    err = (got - want).abs()
    tol = rtol * want.abs() + 1e-4 * v.float().abs().max()
    if not bool((err <= tol).all()) or not bool(torch.isfinite(got).all()):
        fail(f"flash_mha {name}: max err {float(err.max()):.3e} over tolerance")
    return float(err.max())


def check_flash(torch, rows: dict) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (flash_mha_kernel,
                                                                     flash_mha_plain,
                                                                     variant_for)
    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    cases = []
    for n in (200, 256):
        cases += [
            _attn_case(torch, g, f"seq N={n}", 1, n, 16, 16, 64, bf, bias="seq", pad=n // 10),
            _attn_case(torch, g, f"tri N={n}", 1, n, 4, 4, 32, bf, rows_as_batch=True, pad=n // 10),
            _attn_case(torch, g, f"structure N={n}", 1, n, 16, 16, 64, bf, bias="f32"),
        ]
    cases += [
        _attn_case(torch, g, "seq N=1024", 1, 1024, 16, 16, 64, bf, bias="seq", pad=24),
        _attn_case(torch, g, "seq N=2048", 1, 2048, 16, 16, 64, bf, bias="seq", pad=48),
        _attn_case(torch, g, "causal", 2, 100, 4, 4, 64, torch.float32, causal=True),
        _attn_case(torch, g, "window", 2, 100, 4, 4, 32, torch.float32, causal=True, window=16),
        _attn_case(torch, g, "gqa", 2, 77, 8, 2, 16, torch.float32, bias="f32"),
        _attn_case(torch, g, "d8", 3, 70, 2, 2, 8, bf),
        _attn_case(torch, g, "d128", 1, 130, 2, 2, 128, bf, bias="f32"),
        _attn_case(torch, g, "bf16 causal window gqa", 2, 150, 8, 2, 64, bf, causal=True,
                   window=70),
        _attn_case(torch, g, "bf16 d16", 3, 90, 4, 4, 16, bf, bias="f32", pad=9),
    ]
    worst = 0.0
    for c in cases:
        args = (c["q"], c["k"], c["v"], c["bias"], c["kvlen"])
        kw = dict(causal=c["causal"], window=c["window"])
        got = flash_mha_kernel(*args, **kw)
        worst = max(worst, _flash_close(torch, got, flash_mha_plain(*args, **kw), c["v"],
                                        c["name"]))
    # triangular attention at N = 1024: the kernel over all rows, the plain
    # version on 8 of them with the same shared bias (over all rows it would
    # materialize (N, 4, N, N) f32 logits, 17 GB)
    tri = _attn_case(torch, g, "tri N=1024", 1, 1024, 4, 4, 32, bf, rows_as_batch=True, pad=24)
    got = flash_mha_kernel(tri["q"], tri["k"], tri["v"], tri["bias"], tri["kvlen"])
    sub = torch.tensor([0, 1, 137, 500, 511, 512, 999, 1023], device="cuda")
    want = flash_mha_plain(tri["q"][sub], tri["k"][sub], tri["v"][sub], tri["bias"],
                           tri["kvlen"][sub])
    tri_err = _flash_close(torch, got[sub], want, tri["v"], "tri N=1024 (8 rows)")
    worst = max(worst, tri_err)
    log(f"flash_mha: allclose on {len(cases) + 1} cases (seq/tri/structure at N=200,256, "
        f"seq at N=1024 and 2048, tri at N=1024 on 8 rows; causal, window, GQA, D=8/16/128; "
        f"bf16 on the tensor cores, f32 and D=8 on the SIMT kernel), worst max|err| {worst:.3e}")

    def timed(c, name, shape, *, plain=True, library=True, err=0.0):
        args = (c["q"], c["k"], c["v"], c["bias"], c["kvlen"])
        o = flash_mha_kernel(*args)
        b, n, h, d = c["q"].shape
        row = _row(name, shape)
        row.max_abs_err = err
        row.ms = time_ms(torch, lambda: flash_mha_kernel(*args))
        row.call_ms = call_ms(torch, lambda: flash_mha_kernel(*args))
        row.plain_ms = time_ms(torch, lambda: flash_mha_plain(*args), iters=3) if plain else None
        if plain:
            row.max_abs_err = float((o.float() - flash_mha_plain(*args).float()).abs().max())
        if library:
            # the library yardstick gets the bias expanded over the rows and
            # the key-length mask folded in (SDPA has no block broadcast)
            mask = c["bias"].float().expand(b, h, n, n).clone()
            if c["kvlen"] is not None:
                mask[..., int(c["kvlen"][0]):] = -1e30
            mask = mask.to(c["q"].dtype)
            qt, kt, vt = (a.transpose(1, 2) for a in (c["q"], c["k"], c["v"]))
            row.library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            del mask
        row.bound_ms, row.bound_by = bound_ms(nbytes(*args, o), 4 * b * h * n * n * d)
        rows.setdefault(name, []).append(row)
        log(row.line())

    by_name = {c["name"]: c for c in cases}
    timed(by_name["tri N=256"], "flash_mha", "tri: q,k,v (256, 256, 4, 32) bf16 views, "
          "bias (1, 4, 256, 256) bf16 transposed")
    timed(by_name["seq N=256"], "flash_mha", "seq: q,k,v (1, 256, 16, 64) bf16, "
          "bias (1, 16, 256, 256) f32 permuted")
    timed(by_name["structure N=256"], "flash_mha", "structure: q,k,v (1, 256, 16, 64) bf16, "
          "bias (1, 16, 256, 256) f32")
    timed(tri, "flash_mha", "tri: q,k,v (1024, 1024, 4, 32) bf16 views, "
          "bias (1, 4, 1024, 1024) bf16 transposed; error on 8 rows", plain=False,
          library=False, err=tri_err)
    timed(by_name["seq N=2048"], "flash_mha", "seq: q,k,v (1, 2048, 16, 64) bf16, "
          "bias (1, 16, 2048, 2048) f32 permuted")
    c = by_name["tri N=256"]
    f32 = dict(c, q=c["q"].float(), k=c["k"].float(), v=c["v"].float())
    assert variant_for(f32["q"].dtype, 32) == "simt"
    timed(f32, "flash_mha_simt", "tri: q,k,v (256, 256, 4, 32) f32, bias (1, 4, 256, 256) bf16")


# ---------------------------------------------------------------------------
# phases 4 and 5: the model
# ---------------------------------------------------------------------------
def _linear_outliers_dropped(x, w, *, bits, k_outliers):
    """The kernel route of an AAQ linear with the outlier term zeroed before
    the matmul kernel: the control a broken outlier gather would read."""
    from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel
    from repro_torch.kernels.aaq_quant.aaq_quant import aaq_quantize_kernel
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    q, s, ov, oi = aaq_quantize_kernel(flat, bits=bits, k_outliers=k_outliers)
    y = aaq_matmul_kernel(q, s, ov.zero_(), oi, w.contiguous(), bits=bits,
                          out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _flash_bias_dropped(q, k, v, bias, kv_valid_len, **kw):
    """The flash kernel launched without its additive bias: the control a
    kernel that lost the bias would read."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_mha_kernel
    return flash_mha_kernel(q, k, v, None, kv_valid_len, **kw)


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """Replace ``module.name`` by ``fn`` for the duration of a control fold."""
    sound = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, sound)


def check_forward(torch) -> None:
    from repro_torch.configs import get_ppm_config
    from repro_torch.core import make_scheme
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.kernels import dispatch
    from repro_torch.models.ppm import init_ppm, ppm_forward, tm_score
    from repro_torch.serving import pad_to_bucket
    cfg = dataclasses.replace(get_ppm_config(), blocks=2)
    params = init_ppm(cfg, seed=0, device="cuda")
    seq = ProteinSampler(seed=11).sample(0, length=FWD_LEN)
    aat, mask = pad_to_bucket([seq], FWD_BUCKET)
    aat, mask = torch.from_numpy(aat).cuda(), torch.from_numpy(mask).cuda()

    def fold(scheme, be):
        with torch.inference_mode(), dispatch.use_backend(be):
            out = ppm_forward(params, aat, cfg, make_scheme(scheme), mask=mask)
        c = out["coords"][0, :len(seq)].float().cpu()
        if not bool(torch.isfinite(c).all()):
            fail(f"forward {scheme} {be}: non-finite coords")
        return c

    fp, aaq = "baseline_fp16", "lightnobel_aaq"
    coords = {(s, be): fold(s, be) for s in (fp, aaq) for be in ("kernel", "ref")}
    with swapped(dispatch, "flash_mha_kernel", _flash_bias_dropped):
        bias_dropped = fold(fp, "kernel")
    with swapped(dispatch, "aaq_linear", _linear_outliers_dropped):
        outliers_dropped = fold(aaq, "kernel")

    def tm_vs(c, scheme):
        ref = coords[scheme, "ref"]
        tm = float(tm_score(c, ref))
        rms = float((c - ref).pow(2).sum(-1).mean().sqrt())
        return tm, f"vs {scheme} ref: TM={tm:.5f} coord rms diff={rms:.4e}"

    where = f"forward 2 blocks full width, len {len(seq)} in bucket {FWD_BUCKET}"
    faults = []
    for scheme in (fp, aaq):
        tm, text = tm_vs(coords[scheme, "kernel"], scheme)
        log(f"{where}, {scheme} kernels {text} gate >= {TM_GATE}")
        if not tm >= TM_GATE:
            faults.append(f"forward {scheme}: TM {tm:.5f} < {TM_GATE}")
    for name, c, scheme in (("flash bias dropped", bias_dropped, fp),
                            ("aaq_matmul outlier term dropped", outliers_dropped, aaq)):
        tm, text = tm_vs(c, scheme)
        log(f"{where}, control {name} {text} must be < {TM_GATE}")
        if not tm < TM_GATE:
            faults.append(f"forward control {name}: TM {tm:.5f} passes the gate")
    _, text = tm_vs(coords[fp, "kernel"], aaq)
    log(f"{where}, no quantization ({fp} kernels) {text} (not gated)")
    if faults:
        fail("; ".join(faults))


def _serve_run(torch, cfg, params, seqs, what):
    """One run of the sequential server at full width: counters zeroed just
    before, read just after; every main-path kernel launched, no plain
    version, finite coords."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_ppm_sequential
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counters()
    results = serve_ppm_sequential(cfg, params, seqs, SERVE_BUCKETS,
                                   scheme="lightnobel_aaq", fidelity=True,
                                   device="cuda", emit=log)
    launches, plain = dispatch.launch_counts(), dispatch.plain_counts()
    routed = dict(dispatch.counters)
    peak = torch.cuda.max_memory_allocated()
    log(f"{what}: served {len(results)} requests; lengths {[r.length for r in results]} "
        f"in buckets {[r.bucket for r in results]}; latency_ms "
        f"{[round(r.latency_ms, 1) for r in results if r.latency_ms is not None]}; TM vs "
        f"baseline_fp16 {[round(r.tm_vs_fp, 4) for r in results if r.tm_vs_fp is not None]}; "
        f"peak memory {peak / 2**30:.2f} GiB on {torch.cuda.get_device_name(0)}")
    log(f"{what}: launches {launches}; plain versions {plain}; routed {routed}")
    for r in results:
        if r.bucket is None or r.coords is None or not bool(torch.isfinite(r.coords).all()):
            fail(f"{what} request {r.request}: no finite coords")
    if any(launches[name] == 0 for name in dispatch.MAIN_PATH):
        fail(f"{what}: a main-path kernel was never launched: {launches}")
    if any(plain.values()) or any(routed[f"{op}.ref"] for op in ("attention", "qmatmul",
                                                                    "fakequant")):
        fail(f"{what}: a plain version ran on the main path: {plain} {routed}")
    if launches["aaq_fake_quant"] != routed["fakequant.kernel"]:
        fail(f"{what}: {routed['fakequant.kernel']} fake-quant calls routed to the kernel "
             f"but {launches['aaq_fake_quant']} launches")
    return results, launches


def serve_full_width(torch):
    from repro_torch.configs import get_ppm_config
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.models.ppm import init_ppm
    from repro_torch.models import common as cm
    cfg = get_ppm_config()
    t0 = time.perf_counter()
    params = init_ppm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"esmfold_ppm: {cfg.blocks} blocks, hm {cfg.hm}, hz {cfg.hz}, {cfg.dtype}, "
        f"{cm.count_params(params) / 1e6:.1f}M params ({cm.param_bytes(params) / 2**30:.2f} GiB) "
        f"made in {time.perf_counter() - t0:.1f}s")
    sampler = ProteinSampler(seed=11, min_len=64, max_len=256)
    seqs = [sampler.sample(i) for i in range(SERVE_N)]
    results, launches = _serve_run(torch, cfg, params, seqs, "short requests")
    folds = len(results)
    log(f"launches per fold: aaq_quantize {launches['aaq_quantize'] / folds:.0f}, "
        f"aaq_fake_quant {launches['aaq_fake_quant'] / folds:.0f}, "
        f"aaq_matmul {launches['aaq_matmul'] / folds:.0f} (lightnobel_aaq folds), "
        f"flash_mha {launches['flash_mha'] / (2 * folds):.0f} (every fold)")
    long_seq = ProteinSampler(seed=11).sample(SERVE_N, length=LONG_LEN)
    (res,), long_launches = _serve_run(torch, cfg, params, [long_seq], "long request")
    if res.bucket != 1024:
        fail(f"long request of {LONG_LEN} residues went to bucket {res.bucket}")
    log(f"long request: {LONG_LEN} residues in bucket {res.bucket}: latency "
        f"{res.latency_ms:.1f} ms, TM vs baseline_fp16 {res.tm_vs_fp:.4f}")
    total = {k: launches[k] + long_launches[k] for k in launches}
    return total, cfg, params


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


@contextlib.contextmanager
def shape_census():
    """Tally the shapes the main path hands each kernel, and the
    ``AAQScheme.act`` calls with an enabled policy (one unprofiled fold;
    wraps the ops' and the scheme's references, not the kernels' launch
    counts)."""
    from repro_torch.core.schemes import AAQScheme
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.aaq_matmul import ops
    from repro_torch.kernels.aaq_quant import ops as qops
    tally = Counter()
    mm, fl = ops.aaq_matmul_kernel, dispatch.flash_mha_kernel
    qk, fq, act = qops.aaq_quantize_kernel, qops.aaq_fake_quant_kernel, AAQScheme.act

    def mm_counted(q, s, ov, oi, w, **kw):
        tally[("aaq_matmul", tuple(w.shape))] += 1
        return mm(q, s, ov, oi, w, **kw)

    def qk_counted(x, *, bits, k_outliers):
        tally[("aaq_quantize", (x.shape[-1], bits, k_outliers))] += 1
        return qk(x, bits=bits, k_outliers=k_outliers)

    def fq_counted(x, bits, k_outliers):
        tally[("aaq_fake_quant", (x.shape[-1], bits, k_outliers))] += 1
        return fq(x, bits, k_outliers)

    def act_counted(self, x, site):
        if self.cfg.policy_for(site).enabled:
            tally[("act", "enabled")] += 1
        return act(self, x, site)

    def fl_counted(q, k, v, bias=None, kvl=None, **kw):
        kind = "tri" if q.shape[0] > 1 else "seq/structure"
        tally[("flash_mha", kind)] += 1
        return fl(q, k, v, bias, kvl, **kw)

    with swapped(ops, "aaq_matmul_kernel", mm_counted), \
            swapped(dispatch, "flash_mha_kernel", fl_counted), \
            swapped(qops, "aaq_quantize_kernel", qk_counted), \
            swapped(qops, "aaq_fake_quant_kernel", fq_counted), \
            swapped(AAQScheme, "act", act_counted):
        yield tally


def profile_folds(torch, cfg, params) -> None:
    """Where a full-width fold's time goes: one fold per scheme at bucket
    256 under torch.profiler; device-busy share of the wall time, the
    kernels that take the most device time, and each kernel's device time.
    The profiler's own overhead lengthens the wall time, so the busy share
    is a lower bound.  The census fold before it must launch aaq_fake_quant
    once for each enabled ``AAQScheme.act`` call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import make_scheme
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.kernels import dispatch
    from repro_torch.models.ppm import ppm_forward
    from repro_torch.serving import pad_to_bucket
    seq = ProteinSampler(seed=11).sample(99, length=250)
    aat, mask = pad_to_bucket([seq], 256)
    aat, mask = torch.from_numpy(aat).cuda(), torch.from_numpy(mask).cuda()
    for scheme in ("lightnobel_aaq", "baseline_fp16"):
        with torch.inference_mode():
            before = dispatch.launch_counts()["aaq_fake_quant"]
            with shape_census() as tally:                                    # warm
                ppm_forward(params, aat, cfg, make_scheme(scheme), mask=mask)
            torch.cuda.synchronize()
            fake = dispatch.launch_counts()["aaq_fake_quant"] - before
            log(f"launches per {scheme} fold by shape: "
                f"{ {f'{k[0]} {k[1]}': v for k, v in sorted(tally.items(), key=str)} }")
            acts = tally[("act", "enabled")]
            log(f"{scheme} fold: {acts} AAQScheme.act calls with an enabled policy "
                f"({acts / cfg.blocks:g} a block), {fake} aaq_fake_quant launches")
            if fake != acts or (scheme == "lightnobel_aaq" and not acts):
                fail(f"{scheme} fold: {fake} aaq_fake_quant launches for {acts} act calls")
            t0 = time.perf_counter()
            ppm_forward(params, aat, cfg, make_scheme(scheme), mask=mask)
            torch.cuda.synchronize()
            plain_wall = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ppm_forward(params, aat, cfg, make_scheme(scheme), mask=mask)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
                   if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(us for _, us, _ in kernels) / 1e3
        n_launch = sum(c for _, _, c in kernels)
        log(f"profile {scheme} N=250 in bucket 256: wall {plain_wall:.1f} ms unprofiled, "
            f"{wall:.1f} ms profiled; device busy {busy:.1f} ms "
            f"({100 * busy / wall:.1f}% of the profiled wall); {n_launch} device kernels")
        if not kernels:
            log("profile: the profiler recorded no device time (not measured)")
        for tag in ("aaq_quantize_lanes", "aaq_fake_quant_lanes", "aaq_matmul_tc", "flash_tc"):
            hits = [(us, n) for name, us, n in kernels if tag in name]
            log(f"  {tag}: {sum(us for us, _ in hits) / 1e3:.2f} ms device time per fold "
                f"over {sum(n for _, n in hits)} launches")
        for name, us, count in sorted(kernels, key=lambda k: -k[1])[:8]:
            log(f"  {us / 1e3:8.2f} ms  {count:5d}x  {name[:100]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on the card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    resolve_device("cuda")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; nvcc {nvcc}")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f}s "
        f"({'built' if build.build_seconds is not None else 'cached'}) from "
        f"{[str(s.relative_to(ROOT)) for s in build.sources()]}")

    # 3. kernels vs plain versions, timed at every main-path shape
    rows: dict[str, list[KernelRow]] = {}
    check_quantize(torch, rows)
    check_matmul(torch, rows)
    check_flash(torch, rows)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f}s")

    # 4. whole forward, kernels vs plain references
    check_forward(torch)
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f}s")

    # 5. the main path: sequential serving at full width, short and long
    launches, cfg, params = serve_full_width(torch)
    for name, n in launches.items():
        rows[name][0].launches = n
    profile_folds(torch, cfg, params)

    # 6. summary
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [r[0].record() for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
