#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card (nvidia-smi name and power limit), torch, CUDA
     and nvcc versions; no CUDA device -> exit 1;
  2. build: the three CUDA kernels from ``src/repro_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes, with its time, the plain version's, the least time the
     card could take (``bound_ms``) and one PyTorch library call's;
  4. whole forward, kernels vs the plain references, 2 blocks at full
     esmfold_ppm width, one padded request, with two controls that the
     lightnobel_aaq gate must reject;
  5. the sequential server at full esmfold_ppm width (48 blocks, bf16,
     seeded random weights): every kernel launched, no plain version ran;
     then one profiled fold per scheme (device-busy share, top kernels);
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

SERVE_BUCKETS = (96, 192, 256)
SERVE_N = 4
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


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@dataclasses.dataclass
class KernelRow:
    name: str
    source: str
    replaces: str
    shape: str
    max_abs_err: float = 0.0
    ms: float = 0.0
    plain_ms: float = 0.0
    bound_ms: float = 0.0
    bound_by: str = ""
    library_ms: float | None = None
    launches: int = 0

    def record(self) -> dict:
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "shape": self.shape,
                "launches": self.launches, "max_abs_err": self.max_abs_err,
                "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": self.bound_by,
                "library_ms": self.library_ms}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_quantize(torch, rows: dict) -> None:
    from repro_torch.kernels.aaq_quant.aaq_quant import aaq_quantize_kernel
    from repro_torch.kernels.aaq_quant.ref import aaq_quantize_ref
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
            got = aaq_quantize_kernel(x, bits=bits, k_outliers=k)
            want = aaq_quantize_ref(x, bits, k)
            torch.cuda.synchronize()
            for name, a, b in zip(("inliers", "scales", "ovals", "oidx"), got, want):
                if a.dtype == torch.bfloat16:
                    a, b = a.view(torch.int16), b.view(torch.int16)
                if a.shape != b.shape or not torch.equal(a, b):
                    fail(f"aaq_quantize {name} not bitwise equal at T={tt} H={h} "
                         f"bits={bits} k={k} {dt}")
    log(f"aaq_quantize: bitwise equal to the plain version on {2 * len(cases)} cases "
        "(T = 65536 and 65535, all-zero rows, ties)")
    # timing at the main-path shape: post_ln site, H = 128, bits 4, k 4, bf16
    x = torch.randn((t, 128), generator=g, device="cuda").to(torch.bfloat16)
    out = aaq_quantize_kernel(x, bits=4, k_outliers=4)
    row = rows["aaq_quantize"]
    row.shape = "x (65536, 128) bf16, bits 4, k 4"
    row.ms = time_ms(torch, lambda: aaq_quantize_kernel(x, bits=4, k_outliers=4))
    row.plain_ms = time_ms(torch, lambda: aaq_quantize_ref(x, 4, 4), iters=5)
    row.bound_ms, row.bound_by = bound_ms(nbytes(x, *out), 0)
    row.max_abs_err = 0.0
    log(f"aaq_quantize {row.shape}: kernel_ms={row.ms:.4f} plain_ms={row.plain_ms:.4f} "
        f"bound_ms={row.bound_ms:.4f} ({row.bound_by}) library_ms=none")


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
    worst = 0.0
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
    log(f"aaq_matmul: allclose (rtol one bf16 ulp 2^-7 / 1e-5 for f32, atol 1e-4*max|y|) "
        f"on all cases, worst max|err| {worst:.3e}")
    row = rows["aaq_matmul"]
    h, d = 128, 128
    row.shape = "q (65536, 64) int4 packed, W (128, 128) bf16, bits 4, k 4"
    x = torch.randn((t, h), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((h, d), generator=g, device="cuda") / math.sqrt(h)).to(torch.bfloat16)
    q, s, ov, oi = aaq_quantize_ref(x, 4, 4)
    y = aaq_matmul_kernel(q, s, ov, oi, w, bits=4, out_dtype=torch.bfloat16)
    want = aaq_matmul_ref(q, s, ov, oi, w, bits=4, out_dtype=torch.bfloat16)
    row.max_abs_err = float((y.float() - want.float()).abs().max())
    row.ms = time_ms(torch, lambda: aaq_matmul_kernel(q, s, ov, oi, w, bits=4,
                                                      out_dtype=torch.bfloat16))
    row.plain_ms = time_ms(torch, lambda: aaq_matmul_ref(q, s, ov, oi, w, bits=4,
                                                         out_dtype=torch.bfloat16), iters=5)
    row.library_ms = time_ms(torch, lambda: x @ w)
    row.bound_ms, row.bound_by = bound_ms(nbytes(q, s, ov, oi, w, y), 2 * t * h * d)
    log(f"aaq_matmul {row.shape}: kernel_ms={row.ms:.4f} plain_ms={row.plain_ms:.4f} "
        f"bound_ms={row.bound_ms:.4f} ({row.bound_by}) library_ms(x_bf16 @ W)={row.library_ms:.4f}")


def _attn_case(torch, g, name, b, n, hq, hkv, d, dt, *, bias=None, causal=False,
               window=None, rows_as_batch=False, pad=0):
    """Inputs of one attention case.  ``bias="f32"``: a (B, H, N, N) f32
    bias.  ``rows_as_batch``: triangular
    attention's (B*N, N, H, D) views of a (B, N, N, 3*H*D) projection and a
    transposed bf16 (B, H, N, N) bias; ``pad`` trailing keys are padding."""
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
            if pad:
                bias[..., n - pad:] += -1e9                     # key-padding fold
    return dict(name=name, q=q, k=k, v=v, bias=bias, kvlen=kvlen, causal=causal,
                window=window)


def check_flash(torch, rows: dict) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (flash_mha_kernel,
                                                                     flash_mha_plain)
    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    cases = []
    for n in (200, 256):
        cases += [
            _attn_case(torch, g, f"seq N={n}", 1, n, 16, 16, 64, bf, bias="f32", pad=n // 10),
            _attn_case(torch, g, f"tri N={n}", 1, n, 4, 4, 32, bf, rows_as_batch=True, pad=n // 10),
            _attn_case(torch, g, f"structure N={n}", 1, n, 16, 16, 64, bf, bias="f32"),
        ]
    cases += [
        _attn_case(torch, g, "causal", 2, 100, 4, 4, 64, torch.float32, causal=True),
        _attn_case(torch, g, "window", 2, 100, 4, 4, 32, torch.float32, causal=True, window=16),
        _attn_case(torch, g, "gqa", 2, 77, 8, 2, 16, torch.float32, bias="f32"),
        _attn_case(torch, g, "d8", 3, 70, 2, 2, 8, bf),
        _attn_case(torch, g, "d128", 1, 130, 2, 2, 128, bf, bias="f32"),
    ]
    # Same float32 online softmax as the plain version, summed in another
    # order: one ulp of the output type (2^-7 bf16, 1e-5 f32) relative, plus
    # 1e-4 of max|v| for reassociation and expf/torch.exp differences.
    worst = 0.0
    for c in cases:
        args = (c["q"], c["k"], c["v"], c["bias"], c["kvlen"])
        kw = dict(causal=c["causal"], window=c["window"])
        got = flash_mha_kernel(*args, **kw).float()
        want = flash_mha_plain(*args, **kw).float()
        torch.cuda.synchronize()
        rtol = 2.0 ** -7 if c["q"].dtype == bf else 1e-5
        err = (got - want).abs()
        tol = rtol * want.abs() + 1e-4 * c["v"].float().abs().max()
        if not bool((err <= tol).all()) or not bool(torch.isfinite(got).all()):
            fail(f"flash_mha {c['name']}: max err {float(err.max()):.3e} over tolerance")
        worst = max(worst, float(err.max()))
    log(f"flash_mha: allclose on {len(cases)} cases (seq/tri/structure at N=200,256, "
        f"causal, window, GQA, D=8/128), worst max|err| {worst:.3e}")
    # timing at the main path's largest shape: triangular attention at N = 256
    c = next(c for c in cases if c["name"] == "tri N=256")
    row = rows["flash_mha"]
    row.shape = "tri attention: q,k,v (256, 256, 4, 32) bf16 views, bias (1, 4, 256, 256) bf16"
    args = (c["q"], c["k"], c["v"], c["bias"], c["kvlen"])
    o = flash_mha_kernel(*args)
    row.max_abs_err = float((o.float() - flash_mha_plain(*args).float()).abs().max())
    row.ms = time_ms(torch, lambda: flash_mha_kernel(*args))
    row.plain_ms = time_ms(torch, lambda: flash_mha_plain(*args), iters=5)
    b, n, h, d = c["q"].shape
    # the library yardstick gets the bias expanded over the rows and the
    # key-length mask folded in (SDPA has no block broadcast)
    mask = c["bias"].float().expand(b, h, n, n).clone()
    mask[..., int(c["kvlen"][0]):] = -1e30
    mask = mask.to(bf)
    qt, kt, vt = (a.transpose(1, 2) for a in (c["q"], c["k"], c["v"]))
    row.library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    row.bound_ms, row.bound_by = bound_ms(nbytes(c["q"], c["k"], c["v"], c["bias"], c["kvlen"], o),
                                          4 * b * h * n * n * d)
    log(f"flash_mha {row.shape}: kernel_ms={row.ms:.4f} plain_ms={row.plain_ms:.4f} "
        f"bound_ms={row.bound_ms:.4f} ({row.bound_by}) library_ms(sdpa)={row.library_ms:.4f}")


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


def serve_full_width(torch):
    from repro_torch.configs import get_ppm_config
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_ppm_sequential
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
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counters()
    results = serve_ppm_sequential(cfg, params, seqs, SERVE_BUCKETS,
                                   scheme="lightnobel_aaq", fidelity=True,
                                   device="cuda", emit=log)
    launches, plain = dispatch.launch_counts(), dispatch.plain_counts()
    routed = dict(dispatch.counters)
    peak = torch.cuda.max_memory_allocated()
    log(f"served {len(results)} requests; latency_ms "
        f"{[round(r.latency_ms, 1) for r in results if r.latency_ms is not None]}; "
        f"peak memory {peak / 2**30:.2f} GiB on {torch.cuda.get_device_name(0)}")
    log(f"launches {launches}; plain versions {plain}; routed {routed}")
    for r in results:
        if r.bucket is None or r.coords is None or not bool(torch.isfinite(r.coords).all()):
            fail(f"request {r.request}: no finite coords")
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel was never launched on the main path: {launches}")
    if any(plain.values()) or routed["attention.ref"] or routed["qmatmul.ref"]:
        fail(f"a plain version ran on the main path: {plain} {routed}")
    folds = len(results)
    log(f"launches per fold: aaq_quantize {launches['aaq_quantize'] / folds:.0f}, "
        f"aaq_matmul {launches['aaq_matmul'] / folds:.0f} (lightnobel_aaq folds), "
        f"flash_mha {launches['flash_mha'] / (2 * folds):.0f} (every fold)")
    return launches, cfg, params


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def profile_folds(torch, cfg, params) -> None:
    """Where a full-width fold's time goes: one fold per scheme at bucket
    256 under torch.profiler; device-busy share of the wall time and the
    kernels that take the most device time.  The profiler's own overhead
    lengthens the wall time, so the busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import make_scheme
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.models.ppm import ppm_forward
    from repro_torch.serving import pad_to_bucket
    seq = ProteinSampler(seed=11).sample(99, length=250)
    aat, mask = pad_to_bucket([seq], 256)
    aat, mask = torch.from_numpy(aat).cuda(), torch.from_numpy(mask).cuda()
    for scheme in ("lightnobel_aaq", "baseline_fp16"):
        with torch.inference_mode():
            ppm_forward(params, aat, cfg, make_scheme(scheme), mask=mask)     # warm
            torch.cuda.synchronize()
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
    from repro_torch.kernels import build, dispatch
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

    # 3. kernels vs plain versions
    rows = {
        "aaq_quantize": KernelRow("aaq_quantize", "src/repro_torch/csrc/aaq_quant.cu",
                                  "src/repro/kernels/aaq_quant/aaq_quant.py:53", ""),
        "aaq_matmul": KernelRow("aaq_matmul", "src/repro_torch/csrc/aaq_matmul.cu",
                                "src/repro/kernels/aaq_matmul/aaq_matmul.py:47", ""),
        "flash_mha": KernelRow("flash_mha", "src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention/flash_attention.py:93", ""),
    }
    check_quantize(torch, rows)
    check_matmul(torch, rows)
    check_flash(torch, rows)

    # 4. whole forward, kernels vs plain references
    check_forward(torch)

    # 5. the main path: sequential serving at full width
    launches, cfg, params = serve_full_width(torch)
    for name, n in launches.items():
        rows[name].launches = n
    profile_folds(torch, cfg, params)

    # 6. summary
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [r.record() for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
