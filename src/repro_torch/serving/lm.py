"""LM decode on the serving substrate: the second ``Workload`` (port of
``repro/serving/lm.py``).

An autoregressive-decode tenant on the substrate that serves protein
folding: the same ``EngineCore`` executable cache and its (bucket, batch,
scheme, placement, chunk) key, the same ``FoldHandle`` lifecycle, the same
typed event bus (plus the ``TOKEN`` kind), tracer and HTTP transport.  What
differs is what ``Workload`` isolates:

  * **executable surface**: one fixed-shape decode step per (window,
    max_slots, scheme) that advances every slot by one token through the
    ring-buffer KV cache.  On the card it is ONE CUDA graph, captured at
    warm-up: the KV ring is a static buffer the graph writes in place (each
    slot's row at its own ring index, ``positions % window``, by
    ``index_put_``), tokens and positions come in through pinned staging
    and the logits go out of a static buffer.  Zero captures after warm-up:
    there is one shape.
  * **batch formation**: per-token continuous batching.  Sequences join the
    running batch when a slot frees and retire the step their budget is
    spent; inactive slots carry token 0 at position 0, and ``kv_valid_len``
    masks what they do not own.
  * **admission cost model**: KV-cache bytes at the scheme's bits per value
    for the ``lm.kv_cache`` site (``LMKVAdmission``), exactly the
    reference's: an AAQ scheme prices a slot at (4·hd + 32)/hd bits a value
    (INT4 inliers and one f32 scale per row, 4.5 at hd 64), fp16 at 16.
  * **the KV cache itself**: under an AAQ scheme new K/V rows pass through
    ``dispatch.quantize`` (the ``aaq_quantize`` CUDA kernel on the card:
    INT4 nibble-packed inliers + per-row scales) before entering the ring,
    and are dequantized on read.  Attention over the ring is
    ``dispatch.attention`` with a per-slot ``kv_valid_len`` (the flash
    kernel on the card).

Numerics contract (the analogue of folding's padding-is-masking): every
per-slot operation is row-local — (S, 1, .) projections, per-row ring
writes, attention with a per-row ``kv_valid_len``, no reduction across
slots — so a request decoded in a busy batch yields the exact token stream
it yields alone.  The step's host work (greedy argmax on the host copy,
teacher-forcing, emissions) stays outside the graph: ``np.argmax`` takes
the first maximum, as ``jnp.argmax`` does.

Per-request decode state lives in ``LMEngineCore``; the request lifecycle
in ``LMClient``, which mirrors ``FoldClient`` but pumps a step loop.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import IO, Callable, Iterable

import dataclasses

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantize import dequantize
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.serving import events as ev
from repro_torch.serving.admission import ADMIT, DEFER, REJECT, AdmissionDecision
from repro_torch.serving.client import (ADMITTED, CANCELLED, DONE, EXPIRED, QUEUED,
                                        REJECTED, RUNNING, TERMINAL_STATES,
                                        FoldHandle)
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.metrics import _latency_summary, percentiles
from repro_torch.serving.observability.registry import MetricsRegistry
from repro_torch.serving.observability.tracing import PROC_REQUESTS
from repro_torch.serving.scheduler import _urgency
from repro_torch.serving.types import (CANCELLED as R_CANCELLED, EXPIRED as
                                       R_EXPIRED, OK, REJECTED as R_REJECTED,
                                       FoldRequest, LMResult)
from repro_torch.serving.workload import Workload

#: against the scheme's site table (DEFAULT_SITE_TABLE routes it to
#: Group C: INT4, no outliers)
KV_SITE = "lm.kv_cache"


def _kv_policy(scheme):
    """The scheme's quantization policy for the KV-cache site, or None
    for a raw floating-point cache (fp16 baseline / non-AAQ schemes)."""
    aaq = getattr(scheme, "cfg", None)
    if aaq is None or not getattr(aaq, "enabled", False):
        return None
    pol = aaq.policy_for(KV_SITE)
    return pol if pol.enabled else None


LM_CSV_HEADER = ("request,prompt_len,new_tokens,status,priority,queue_ms,"
                 "compile_ms,run_ms,steps,slot,kv_bytes,kernel_backend,"
                 "scheme")


def lm_csv_row(r: LMResult) -> str:
    return (f"{r.request_id},{r.prompt_len},{r.new_tokens},{r.status},"
            f"{r.priority},{r.queue_wait_ms:.2f},{r.compile_ms:.2f},"
            f"{r.run_ms:.2f},{r.steps},{r.slot},{r.kv_bytes},"
            f"{r.kernel_backend},{r.scheme}")


# -- admission: KV bytes at the scheme's bits-per-value -----------------------
class LMKVAdmission:
    """Admission for decode slots, priced in KV-cache bytes.

    A slot's cost is its whole ring buffer — ``layers * 2 (K and V) *
    window * n_kv_heads * hd`` values at ``scheme.act_bits(KV_SITE, hd)``
    bits each.  For the AAQ scheme that is the packed Fig.-7 layout
    (INT4 inliers + one f32 scale per (token, head) row: 6.0 bits/value at
    hd=16); for fp16 it is 16 — so the same ``--mem-budget-mb`` admits
    ~2.7x more concurrent AAQ sequences, which is the quantized-KV
    serving claim the admission test pins down.

    Interface-compatible with ``AdmissionController`` where the substrate
    touches it: ``admit``/``estimate_bytes``/``max_batch_for``/``explain``,
    settable ``on_decision``/``chunk_for``, ``mem_budget_bytes``.
    """

    estimator = "kv_bytes"

    def __init__(self, cfg, scheme, window: int,
                 mem_budget_bytes: int | None = None):
        self.cfg = cfg
        self.scheme = scheme
        self.window = int(window)
        self.mem_budget_bytes = mem_budget_bytes
        bits = scheme.act_bits(KV_SITE, cfg.hd)
        values = cfg.layers * 2 * self.window * cfg.n_kv_heads * cfg.hd
        #: bytes ONE decode slot pins for its whole residency
        self.bytes_per_request = int(math.ceil(values * bits / 8))
        self.bits_per_value = float(bits)
        # wired by the host engine (ChunkPolicy is inert for decode; the
        # metrics hook fires on every verdict, probes included)
        self.chunk_for: Callable[[int], int | None] | None = None
        self.on_decision: Callable[[AdmissionDecision, int, int], None] | None = None

    def estimate_bytes(self, ns: int, batch: int = 1,
                       shards: int | None = None, chunk=None) -> int:
        return self.bytes_per_request * max(1, batch)

    def admit(self, ns: int, batch: int, shards: int | None = None,
              chunk=None) -> AdmissionDecision:
        est = self.estimate_bytes(ns, batch)
        if self.mem_budget_bytes is None or est <= self.mem_budget_bytes:
            d = AdmissionDecision(ADMIT, est, self.mem_budget_bytes,
                                  estimator=self.estimator)
        elif self.bytes_per_request > self.mem_budget_bytes:
            d = AdmissionDecision(
                REJECT, est, self.mem_budget_bytes,
                f"one KV slot needs ~{self.bytes_per_request / 1e6:.1f}MB "
                f"({self.bits_per_value:.1f} bits/value over window "
                f"{self.window}); budget "
                f"{self.mem_budget_bytes / 1e6:.1f}MB",
                estimator=self.estimator)
        else:
            d = AdmissionDecision(
                DEFER, est, self.mem_budget_bytes,
                f"{batch} KV slots need ~{est / 1e6:.1f}MB; budget "
                f"{self.mem_budget_bytes / 1e6:.1f}MB",
                estimator=self.estimator)
        if self.on_decision is not None:
            self.on_decision(d, ns, batch)
        return d

    def max_batch_for(self, ns: int, upper: int,
                      shards: int | None = None) -> int:
        """Largest slot count <= upper within budget (0 = none fit)."""
        if self.mem_budget_bytes is None:
            return upper
        fit = self.mem_budget_bytes // max(1, self.bytes_per_request)
        return int(min(upper, fit))

    def explain(self, ns: int, batch: int = 1, shards: int | None = None,
                chunk=None) -> dict:
        return {"bucket": ns, "batch": batch,
                "est_mb": self.estimate_bytes(ns, batch) / 1e6,
                "budget_mb": (None if self.mem_budget_bytes is None
                              else self.mem_budget_bytes / 1e6),
                "bytes_per_request": self.bytes_per_request,
                "bits_per_value": self.bits_per_value,
                "estimator": self.estimator}


# -- telemetry -----------------------------------------------------------------
class LMMetrics:
    """Decode-serving telemetry: per-request records + an ``lm_*`` metric
    registry const-labeled ``workload="lm"`` (the fold stack's ``fold_*``
    series stay byte-identical — see MetricsRegistry.const_labels).

    Implements every recording hook the host ``EngineCore`` calls
    (``record_compile``, ``record_admission`` via the on_decision wire,
    ``record``) plus the step-loop hooks the LM engine adds.
    """

    def __init__(self):
        self.results: list[LMResult] = []
        self.wall_s = 0.0
        self.registry = MetricsRegistry(const_labels={"workload": "lm"})
        r = self.registry
        self._requests = r.counter(
            "lm_requests_total", "terminal decode requests by status",
            ("status",))
        self._tokens = r.counter(
            "lm_tokens_total", "generated tokens delivered")
        self._steps = r.counter(
            "lm_steps_total", "decode steps executed")
        self._step_s = r.histogram(
            "lm_step_seconds", "wall seconds per decode step")
        self._queue_wait = r.histogram(
            "lm_queue_wait_seconds", "submit -> slot-join wait")
        self._compiles = r.counter(
            "lm_compiles_total", "decode-step executable compiles",
            ("bucket", "scheme", "placement"))
        self._compile_s = r.counter(
            "lm_compile_seconds_total", "seconds spent compiling",
            ("bucket", "scheme", "placement"))
        self._kv_in_use = r.gauge(
            "lm_kv_bytes_in_use", "KV bytes pinned by active slots "
            "(admission pricing)")
        self._kv_per_req = r.gauge(
            "lm_kv_bytes_per_request", "KV bytes one slot costs")
        self._active = r.gauge(
            "lm_active_slots", "slots decoding this step")
        self._admission = r.counter(
            "lm_admission_decisions_total", "admission verdicts",
            ("verdict", "estimator"))
        self._queue_depth = r.gauge(
            "lm_queue_depth", "requests waiting for a slot")
        self._wall = r.counter(
            "lm_wall_seconds_total", "serving wall time accrued")
        self._driver_errors = r.counter(
            "lm_driver_errors_total", "background driver pump errors")
        self._driver_dropped = r.counter(
            "lm_driver_errors_dropped_total",
            "driver errors evicted from the bounded ring")

    # -- hooks the host EngineCore calls -----------------------------------
    def record(self, r: LMResult) -> None:
        self.results.append(r)
        self._requests.inc(status=r.status)
        if r.ok:
            self._tokens.inc(r.new_tokens)
        self._queue_wait.observe(r.queue_wait_ms / 1e3)

    def record_compile(self, bucket: int, ms: float, *,
                       scheme: str = "", placement: str = "single") -> None:
        labels = dict(bucket=str(bucket), scheme=scheme, placement=placement)
        self._compiles.inc(**labels)
        self._compile_s.inc(ms / 1e3, **labels)

    def record_admission(self, verdict: str, bucket: int,
                         estimator: str = "kv_bytes") -> None:
        self._admission.inc(verdict=verdict, estimator=estimator)

    def record_queue_depth(self, n: int) -> None:
        self._queue_depth.set(n)

    def record_driver_error(self, dropped: bool = False) -> None:
        self._driver_errors.inc()
        if dropped:
            self._driver_dropped.inc()

    def add_wall_s(self, dt: float) -> None:
        self.wall_s += dt
        self._wall.inc(max(0.0, dt))

    # -- step-loop hooks -----------------------------------------------------
    def record_step(self, active: int, dt_s: float, new_tokens: int) -> None:
        self._steps.inc()
        self._step_s.observe(dt_s)
        self._active.set(active)
        if new_tokens:
            pass   # token totals land via record(); per-step count is in
                   # the TOKEN event stream

    def record_kv(self, in_use: int, per_request: int) -> None:
        self._kv_in_use.set(in_use)
        self._kv_per_req.set(per_request)

    # -- reports ---------------------------------------------------------------
    def summary(self) -> dict:
        served = [r for r in self.results if r.ok]
        by = {s: sum(1 for r in self.results if r.status == s)
              for s in ("ok", "rejected", "cancelled", "expired", "failed")}
        tokens = sum(r.new_tokens for r in served)
        steps = int(self._steps.total())
        return {
            "workload": "lm",
            "requests": len(self.results),
            "served": by["ok"], "rejected": by["rejected"],
            "cancelled": by["cancelled"], "expired": by["expired"],
            "failed": by["failed"],
            "tokens": tokens, "steps": steps,
            "wall_s": self.wall_s,
            "requests_per_s": (len(served) / self.wall_s
                               if self.wall_s else 0.0),
            "tokens_per_s": tokens / self.wall_s if self.wall_s else 0.0,
            "compiles": int(self._compiles.total()),
            "queue_wait_ms": _latency_summary(
                [r.queue_wait_ms for r in served]),
            "run_ms": _latency_summary([r.run_ms for r in served]),
        }

    def write_csv(self, fh: IO[str], *, summary_footer: bool = False) -> None:
        fh.write(LM_CSV_HEADER + "\n")
        for r in self.results:
            fh.write(lm_csv_row(r) + "\n")
        if summary_footer:
            s = self.summary()
            fh.write(f"# served={s['served']} tokens={s['tokens']} "
                     f"steps={s['steps']} wall_s={s['wall_s']:.3f}\n")
            p = percentiles([r.run_ms for r in self.results if r.ok])
            fh.write(f"# run_ms p50={p['p50']:.2f} p95={p['p95']:.2f} "
                     f"p99={p['p99']:.2f}\n")

    def write_json(self, fh: IO[str]) -> None:
        json.dump({"summary": self.summary(),
                   "requests": [self._req_dict(r) for r in self.results]},
                  fh, indent=2)

    @staticmethod
    def _req_dict(r: LMResult) -> dict:
        return {"request_id": r.request_id, "prompt_len": r.prompt_len,
                "new_tokens": r.new_tokens, "status": r.status,
                "reason": r.reason, "priority": r.priority,
                "queue_wait_ms": r.queue_wait_ms, "compile_ms": r.compile_ms,
                "run_ms": r.run_ms, "steps": r.steps, "slot": r.slot,
                "kv_bytes": r.kv_bytes, "kernel_backend": r.kernel_backend,
                "scheme": r.scheme,
                "tokens": None if r.tokens is None
                else [int(t) for t in r.tokens]}

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            if path.endswith(".json"):
                self.write_json(fh)
            else:
                self.write_csv(fh, summary_footer=True)




# -- the workload plugin -------------------------------------------------------
class LMDecodeWorkload(Workload):
    """Autoregressive decode as a substrate workload.

    ``forward`` is ONE decode step for the whole slot table: (S,) tokens +
    (S,) positions in, the ring-buffer KV cache (``core.cache``) written in
    place, (S, V) next-position logits out.  It runs the transformer's own
    ``block_apply`` with a per-slot ring (``_SlotRing``).  Slots advance
    independently (per-row positions, unlike the lockstep
    ``transformer.decode_step``), which lets sequences join and retire
    mid-flight at one shape.
    """

    name = "lm"
    result_type = LMResult
    extra_event_kinds = (ev.TOKEN,)

    # -- executable surface -------------------------------------------------
    def cache_layout(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """name -> (shape, dtype) of every KV-cache buffer.

        Raw (fp) cache: k/v rings of (L, S, W, Hkv, hd).  AAQ cache: the
        packed QTensor fields per ring: nibble-packed int4 inliers, f32
        per-row scales, bf16 outlier values + int32 indices (zero-size for
        the k=0 Group-C policy this site resolves to)."""
        core = self.core
        cfg = core.cfg
        L, S, W = cfg.layers, core.max_slots, core.window
        H, hd = cfg.n_kv_heads, cfg.hd
        pol = _kv_policy(core.scheme)
        if pol is None:
            shape = (L, S, W, H, hd)
            return {"k": (shape, cfg.torch_dtype), "v": (shape, cfg.torch_dtype)}
        if pol.bits == 4 and hd % 2:
            raise ValueError(f"INT4 KV cache needs an even head dim, got hd={hd}")
        ci = hd // 2 if pol.bits == 4 else hd
        k = pol.k_outliers
        layout = {}
        for name in ("k", "v"):
            layout[f"{name}_inliers"] = ((L, S, W, H, ci), torch.int8)
            layout[f"{name}_scales"] = ((L, S, W, H, 1), torch.float32)
            layout[f"{name}_ovals"] = ((L, S, W, H, k), torch.bfloat16)
            layout[f"{name}_oidx"] = ((L, S, W, H, k), torch.int32)
        return layout

    def init_cache(self) -> dict[str, torch.Tensor]:
        dev = self.core.device
        return {name: torch.zeros(shape, dtype=dtype, device=dev)
                for name, (shape, dtype) in self.cache_layout().items()}

    def input_specs(self, bucket: int, batch: int) -> tuple:
        return (((batch,), torch.int32), ((batch,), torch.int32))

    def output_keys(self) -> tuple[str, ...]:
        return ("logits",)

    # -- cache plumbing (all row-local: see the module's numerics contract) --
    @staticmethod
    def _write_rows(buf, rows, slots, widx) -> None:
        """Write each slot's new row at its own ring index, in place.
        buf (S, W, ...), rows (S, ...), slots (S,) = arange, widx (S,)."""
        if rows.numel():
            buf.index_put_((slots, widx), rows.to(buf.dtype))

    def _write_cache(self, li: int, row_k, row_v, slots, widx, pol) -> None:
        cache = self.core.cache
        if pol is None:
            self._write_rows(cache["k"][li], row_k, slots, widx)
            self._write_rows(cache["v"][li], row_v, slots, widx)
            return
        for name, rows in (("k", row_k), ("v", row_v)):
            # routed: the aaq_quantize kernel on the card, the reference
            # dataflow on the CPU or under kernels="ref"
            qt = dispatch.quantize(rows, bits=pol.bits, k_outliers=pol.k_outliers)
            for field, arr in (("inliers", qt.inliers), ("scales", qt.scales),
                               ("ovals", qt.outlier_values),
                               ("oidx", qt.outlier_idx)):
                self._write_rows(cache[f"{name}_{field}"][li], arr, slots, widx)

    def _read_cache(self, li: int, pol, dtype):
        """Ring buffers of layer ``li`` -> attention-ready (S, W, H, hd) K/V."""
        cache = self.core.cache
        if pol is None:
            return cache["k"][li].to(dtype), cache["v"][li].to(dtype)
        out = []
        for name in ("k", "v"):
            qt = QTensor(inliers=cache[f"{name}_inliers"][li],
                         scales=cache[f"{name}_scales"][li],
                         outlier_values=cache[f"{name}_ovals"][li],
                         outlier_idx=cache[f"{name}_oidx"][li],
                         bits=pol.bits, k_outliers=pol.k_outliers,
                         feature_dim=self.core.cfg.hd, orig_dtype=dtype)
            out.append(dequantize(qt))
        return out[0], out[1]

    # -- the captured decode step --------------------------------------------
    def forward(self, scheme, chunk, params, tokens, positions):
        core = self.core
        cfg = core.cfg
        pol = _kv_policy(scheme)
        s = tokens.shape[0]
        w = core.window
        x = cm.embed(params["embed"], tokens.long()[:, None])    # (S, 1, D)
        pos2d = positions[:, None]                               # (S, 1)
        slots = torch.arange(s, device=tokens.device)
        widx = (positions % w).long()
        kvlen = torch.clamp(positions + 1, max=w).to(torch.int32)
        for li, p in enumerate(params["blocks"]):
            ring = _SlotRing(self, li, pol, slots, widx, kvlen)
            x = tf.block_apply(p, x, cfg, positions=pos2d, cache=ring)
        x = tf.apply_norm(params["final_norm"], x, cfg)
        logits = tf.unembed(params, x, cfg)                      # (S, 1, V) f32
        return {"logits": logits[:, 0]}

    # -- substrate hooks -------------------------------------------------------
    def pad_inputs(self, requests: tuple, bucket: int,
                   launched_b: int) -> tuple:
        raise NotImplementedError(
            "LM decode forms batches per step via LMEngineCore.step(), "
            "not via the fold dispatch/retire ring")

    def make_admission(self, mem_budget_bytes: int | None) -> LMKVAdmission:
        return LMKVAdmission(self.core.cfg, self.core.scheme,
                             self.core.window, mem_budget_bytes)

    def make_metrics(self) -> LMMetrics:
        return LMMetrics()

    def describe(self) -> dict:
        core = self.core
        pol = _kv_policy(core.scheme)
        return {"workload": self.name, "window": core.window,
                "max_slots": core.max_slots, "scheme": core.scheme.name,
                "kv_cache": ("raw_fp" if pol is None else
                             f"aaq_int{pol.bits}_k{pol.k_outliers}"),
                "kv_bits_per_value": core.scheme.act_bits(KV_SITE, core.cfg.hd)}


class _SlotRing:
    """Layer ``li`` of the served KV ring as ``transformer.attn_apply``'s
    cache: each slot's new row written at its own ring index ``widx`` (the
    quantize kernel first under AAQ), the whole ring read back for
    attention with per-slot ``kv_valid_len``."""

    def __init__(self, workload: LMDecodeWorkload, li: int, pol, slots, widx, kvlen):
        self.workload, self.li, self.pol = workload, li, pol
        self.slots, self.widx, self.kvlen = slots, widx, kvlen

    def append(self, k, v):
        wl = self.workload
        wl._write_cache(self.li, k[:, 0], v[:, 0], self.slots, self.widx, self.pol)
        kd, vd = wl._read_cache(self.li, self.pol, k.dtype)
        return kd, vd, self.kvlen


# -- per-slot decode state -----------------------------------------------------
@dataclasses.dataclass
class _Slot:
    req: FoldRequest
    prompt: np.ndarray
    max_new_tokens: int
    t_join: float
    queue_wait_ms: float
    pos: int = 0                       # next position to feed
    next_token: int = 0                # token fed at ``pos``
    tokens: list = dataclasses.field(default_factory=list)
    logits_first: np.ndarray | None = None
    steps: int = 0
    run_s: float = 0.0
    compile_s: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done_generating(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens




class LMEngineCore(EngineCore):
    """Decode-step executor over a fixed slot table.

    Rides the parent ``EngineCore`` for everything substrate (the
    executable cache and its capture metrics, the workload binding,
    admission/metrics wiring, the kernel-backend scope) and replaces the
    dispatch/retire ring with a ``step()`` loop: one call of the one
    executable (a CUDA graph replay on the card) advances every occupied
    slot by one token.  The prompt is teacher-forced through the same
    executable (prefill = decode steps feeding prompt tokens), then greedy
    argmax extends it.

    ``cache`` is the KV ring (``LMDecodeWorkload.cache_layout``), allocated
    before the capture and written in place by every step.  The capture's
    eager warm-up writes ring row 0 of every slot; it runs at ``warmup()``
    or the first step, when every seated slot is at position 0 and rewrites
    that row itself.
    """

    def __init__(self, params, cfg, scheme=None, *, window: int = 256,
                 max_slots: int = 4, mem_budget_mb: float | None = None,
                 kernels: str = dispatch.AUTO,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None, device=None):
        if cfg.kind != "dense":
            raise ValueError(f"LM decode serving supports the dense "
                             f"transformer, got kind={cfg.kind!r}")
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        # set before super(): make_admission/cache_layout read these
        self.window = int(window)
        self.max_slots = int(max_slots)
        self.cache: dict[str, torch.Tensor] | None = None
        super().__init__(params, cfg, scheme, buckets=(self.window,),
                         max_tokens_per_batch=self.window * self.max_slots,
                         max_batch=self.max_slots,
                         mem_budget_mb=mem_budget_mb, fidelity=False,
                         kernels=kernels, keep_distogram=False,
                         inflight_depth=1, clock=clock, tracer=tracer,
                         workload=LMDecodeWorkload(), device=device)
        self.slots: list[_Slot | None] = [None] * self.max_slots

    # -- slot table ---------------------------------------------------------
    @property
    def active_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def kv_bytes_in_use(self) -> int:
        return self.active_count * self.admission.bytes_per_request

    def warmup(self, ladder=None) -> None:
        """Allocate the KV ring and capture THE decode step: one shape, the
        entire capture space, so steady-state decode captures nothing."""
        if self.cache is None:
            self.cache = self.workload.init_cache()
        self._executable(self.window, self.max_slots, self.scheme)

    def close(self) -> None:
        self.cache = None
        super().close()

    def join(self, req: FoldRequest, now: float) -> int:
        """Seat a request in the first free slot; the caller has already
        admitted it.  Position 0 overwrites whatever a previous occupant
        left in the ring (kv_valid_len masks the stale suffix exactly)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("join() with no free slot")
        i = free[0]
        prompt = np.asarray(req.aatype, np.int32)
        self.slots[i] = _Slot(
            req=req, prompt=prompt,
            max_new_tokens=int(req.max_new_tokens or 1),
            t_join=now,
            queue_wait_ms=(now - req.arrival_time) * 1e3,
            pos=0, next_token=int(prompt[0]))
        return i

    def step(self) -> tuple[list, list[LMResult]]:
        """Advance every occupied slot one position.  Returns
        ``(emissions, finished)``: emissions are ``(request_id, step_index,
        token_id, slot)`` for tokens GENERATED this step (prompt
        teacher-forcing emits nothing), finished are LMResults of slots
        that spent their budget (their slots are freed)."""
        if self.active_count == 0:
            return [], []
        tokens = np.zeros((self.max_slots,), np.int32)
        positions = np.zeros((self.max_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i] = s.next_token
                positions[i] = s.pos
        if self.cache is None:
            self.cache = self.workload.init_cache()
        compiled, compile_s = self._executable(self.window, self.max_slots,
                                               self.scheme)
        t0 = time.perf_counter()
        out = compiled.launch(*self._stage(0, (tokens, positions)))
        logits = out["logits"].cpu().numpy()   # waits: step wall ends here
        dt = time.perf_counter() - t0
        active = self.active_count
        emissions = []
        finished = []
        generated = 0
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.steps += 1
            s.run_s += dt / active
            s.compile_s += compile_s / active
            if s.pos >= s.prompt_len - 1:
                # the model just saw the last known token: logits[i] is the
                # next-token distribution; greedy-decode it on the host
                # (np.argmax takes the first maximum, as jnp.argmax does)
                if s.logits_first is None:
                    s.logits_first = np.array(logits[i], np.float32)
                tok = int(np.argmax(logits[i]))
                s.tokens.append(tok)
                s.next_token = tok
                emissions.append((s.req.request_id, len(s.tokens) - 1,
                                  tok, i))
                generated += 1
            else:
                s.next_token = int(s.prompt[s.pos + 1])   # teacher-force
            s.pos += 1
            if s.done_generating:
                finished.append(self._finish_slot(i))
        self.metrics.record_step(active, dt, generated)
        self.metrics.record_kv(self.kv_bytes_in_use(),
                               self.admission.bytes_per_request)
        return emissions, finished

    def _finish_slot(self, i: int) -> LMResult:
        s = self.slots[i]
        self.slots[i] = None
        result = LMResult(
            request_id=s.req.request_id, prompt_len=s.prompt_len,
            status=OK, tokens=np.asarray(s.tokens, np.int32),
            max_new_tokens=s.max_new_tokens, priority=s.req.priority,
            queue_wait_ms=s.queue_wait_ms, compile_ms=s.compile_s * 1e3,
            run_ms=s.run_s * 1e3, steps=s.steps, slot=i,
            kv_bytes=self.admission.bytes_per_request,
            kernel_backend=dispatch.describe(self.kernels, device=self.device),
            scheme=self.scheme.name, logits_first=s.logits_first)
        self.metrics.record(result)
        return result


class LMClient:
    """The LM request-lifecycle API: ``FoldClient``'s contracts over the
    decode step loop.

    Reuses ``FoldHandle`` unchanged (same states, same legality relation,
    same ``result()``/``cancel()``/``span_tree()`` surface) and emits the
    same lifecycle events, plus one ``TOKEN`` event per generated token.
    The pump differs: instead of forming dispatch/retire batches, each
    ``drive`` turn (a) joins as many queued requests into free slots as
    admission allows, then (b) executes one decode step.  Progress is
    *joined-or-stepped* — a step that only emits tokens (finishing no
    request) is still progress, which is why this client has its own
    driver loop rather than FoldClient's results-based one.
    """

    def __init__(self, params, cfg, scheme=None, *, window: int = 256,
                 max_slots: int = 4, mem_budget_mb: float | None = None,
                 kernels: str | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 default_max_new_tokens: int = 16,
                 core: LMEngineCore | None = None, tracer=None, device=None):
        if core is None:
            # device None = the card (raises without one); "cpu" on request
            core = LMEngineCore(
                params, cfg, scheme, window=window, max_slots=max_slots,
                mem_budget_mb=mem_budget_mb,
                kernels=dispatch.AUTO if kernels is None else kernels,
                clock=clock, tracer=tracer, device=device)
        self.core = core
        self.clock = core.clock
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.events = ev.EventBus(clock=self.clock)
        self.handles: dict[int, FoldHandle] = {}
        self._queue: list[FoldRequest] = []
        self._deferred_flagged: set[int] = set()
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._next_id = 0
        self._driver: threading.Thread | None = None
        self._stop = False
        self.driver_errors: deque[Exception] = deque(maxlen=32)
        self.driver_errors_dropped = 0
        self.tracer = self.core.tracer

    # -- passthroughs --------------------------------------------------------
    @property
    def metrics(self) -> LMMetrics:
        return self.core.metrics

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active(self) -> int:
        return self.core.active_count

    def metrics_text(self) -> str:
        return self.core.metrics.registry.prometheus_text()

    def metrics_json(self) -> dict:
        return self.core.metrics.registry.as_dict()

    def save_trace(self, path: str) -> None:
        self.tracer.save(path)

    def warmup(self) -> None:
        self.core.warmup()

    def subscribe(self, callback) -> Callable[[], None]:
        return self.events.subscribe(callback)

    def stream(self) -> ev.EventStream:
        return self.events.stream()

    def _record_driver_error(self, e: Exception) -> None:
        dropped = len(self.driver_errors) == self.driver_errors.maxlen
        if dropped:
            self.driver_errors_dropped += 1
        self.driver_errors.append(e)
        self.core.metrics.record_driver_error(dropped)

    # -- intake ----------------------------------------------------------------
    def submit(self, prompt: np.ndarray | FoldRequest, *, priority: int = 0,
               deadline_s: float | None = None,
               max_new_tokens: int | None = None) -> FoldHandle:
        """Queue a prompt for decoding; returns its handle immediately
        (QUEUED, or REJECTED when it can never be served: empty prompt,
        prompt + budget beyond the window, or one KV slot alone over the
        memory budget)."""
        if isinstance(prompt, FoldRequest) and (
                priority != 0 or deadline_s is not None
                or max_new_tokens is not None):
            raise ValueError("priority/deadline_s/max_new_tokens kwargs "
                             "conflict with an explicit FoldRequest — set "
                             "them on the request")
        with self._lock:
            if self.events.closed:
                raise RuntimeError(
                    "LMClient is stopped (EventBus closed); call start() "
                    "to re-arm it before submitting")
            if isinstance(prompt, FoldRequest):
                req = prompt
                if req.request_id in self.handles:
                    raise ValueError(f"request_id {req.request_id} is "
                                     f"already live on this client")
                if req.max_new_tokens is None:
                    req.max_new_tokens = self.default_max_new_tokens
            else:
                req = FoldRequest(
                    self._next_id, np.asarray(prompt, np.int32),
                    priority=priority, deadline_s=deadline_s,
                    max_new_tokens=(self.default_max_new_tokens
                                    if max_new_tokens is None
                                    else max_new_tokens))
            self._next_id = max(self._next_id, req.request_id) + 1
            now = self.clock()
            req.arrival_time = now
            if req.deadline_s is not None:
                req.deadline_at = now + req.deadline_s
            track = f"req-{req.request_id}"
            root = self.tracer.begin("request", process=PROC_REQUESTS,
                                     thread=track, t=now,
                                     request_id=req.request_id,
                                     length=req.length,
                                     priority=req.priority)
            adm = self.tracer.begin("admission", process=PROC_REQUESTS,
                                    thread=track, parent=root, t=now)
            reason = self._reject_reason(req)
            self.tracer.end(adm, verdict="reject" if reason else "accept")
            meta = {"length": req.length, "priority": req.priority,
                    "deadline_s": req.deadline_s,
                    "max_new_tokens": req.max_new_tokens}
            if reason:
                handle = FoldHandle(self, req, REJECTED, now)
                handle.spans = {"request": root, "admission": adm}
                self.tracer.end(root, status="rejected", reason=reason)
                handle._result = LMResult(
                    request_id=req.request_id, prompt_len=req.length,
                    status=R_REJECTED, reason=reason,
                    max_new_tokens=req.max_new_tokens or 0,
                    priority=req.priority, scheme=self.core.scheme.name)
                self.core.metrics.record(handle._result)
                self.events.emit(ev.SUBMITTED, req.request_id, **meta)
                self.events.emit(ev.REJECTED, req.request_id,
                                 reason=reason, **meta)
            else:
                handle = FoldHandle(self, req, QUEUED, now)
                handle.spans = {
                    "request": root, "admission": adm,
                    "queued": self.tracer.begin(
                        "queued", process=PROC_REQUESTS, thread=track,
                        parent=root)}
                self.handles[req.request_id] = handle
                self._queue.append(req)
                self.events.emit(ev.SUBMITTED, req.request_id, **meta)
            self.core.metrics.record_queue_depth(len(self._queue))
            self._cond.notify_all()
        self.events.dispatch()
        return handle

    def _reject_reason(self, req: FoldRequest) -> str:
        if req.length < 1:
            return "empty prompt"
        total = req.length + (req.max_new_tokens or 0)
        if total > self.core.window:
            return (f"prompt {req.length} + max_new_tokens "
                    f"{req.max_new_tokens} = {total} exceeds the KV window "
                    f"{self.core.window}")
        d = self.core.admission.admit(self.core.window, 1)
        if d.verdict == REJECT:
            return d.reason
        return ""

    # -- cancellation / expiry --------------------------------------------------
    def _cancel(self, handle: FoldHandle) -> bool:
        with self._lock:
            if handle._status != QUEUED:
                return False
            req = handle._request
            if req not in self._queue:    # already seated in a slot
                return False
            self._queue.remove(req)
            self._deferred_flagged.discard(req.request_id)
            now = self.clock()
            req.cancelled = True
            handle._advance(CANCELLED, now)
            self._end_request_spans(handle, "cancelled", now)
            handle._result = LMResult(
                request_id=req.request_id, prompt_len=req.length,
                status=R_CANCELLED, reason="cancelled by client",
                max_new_tokens=req.max_new_tokens or 0,
                priority=req.priority, scheme=self.core.scheme.name,
                queue_wait_ms=(now - req.arrival_time) * 1e3)
            self.core.metrics.record(handle._result)
            self.handles.pop(req.request_id, None)
            self.events.emit(ev.CANCELLED, req.request_id,
                             queued_ms=(now - req.arrival_time) * 1e3)
            self.core.metrics.record_queue_depth(len(self._queue))
            self._cond.notify_all()
        self.events.dispatch()
        return True

    def _expire_due(self, now: float) -> list[LMResult]:
        """Caller holds the lock and dispatches events after releasing."""
        due = [r for r in self._queue if r.expired(now)]
        out = []
        for req in due:
            self._queue.remove(req)
            self._deferred_flagged.discard(req.request_id)
            handle = self.handles.pop(req.request_id)
            handle._advance(EXPIRED, now)
            self._end_request_spans(handle, "expired", now)
            handle._result = LMResult(
                request_id=req.request_id, prompt_len=req.length,
                status=R_EXPIRED, priority=req.priority,
                reason=f"deadline {req.deadline_s:.3f}s passed in queue",
                max_new_tokens=req.max_new_tokens or 0,
                scheme=self.core.scheme.name,
                queue_wait_ms=(now - req.arrival_time) * 1e3)
            self.core.metrics.record(handle._result)
            self.events.emit(ev.EXPIRED, req.request_id,
                             deadline_s=req.deadline_s,
                             queued_ms=(now - req.arrival_time) * 1e3)
            out.append(handle._result)
        if out:
            self.core.metrics.record_queue_depth(len(self._queue))
            self._cond.notify_all()
        return out

    def _end_request_spans(self, handle: FoldHandle, status: str,
                           t: float) -> None:
        for name in ("queued", "running"):
            s = handle.spans.get(name)
            if s is not None:
                self.tracer.end(s, t=t)
        root = handle.spans.get("request")
        if root is not None:
            self.tracer.end(root, t=t, status=status)

    # -- the pump ------------------------------------------------------------
    def _join_turn(self) -> tuple[int, list[LMResult]]:
        """Expire dues, then seat queued requests into free slots in
        urgency order while admission allows.  Returns (joined, expired)."""
        try:
            with self._lock:
                now = self.clock()
                expired = self._expire_due(now)
                joined = 0
                self._queue.sort(key=_urgency)
                while self._queue and self.core.free_slots():
                    req = self._queue[0]
                    d = self.core.admission.admit(
                        self.core.window, self.core.active_count + 1)
                    if d.verdict != ADMIT:
                        # budget is global across slots: nobody behind this
                        # request fits either — emit DEFERRED once per stay
                        if req.request_id not in self._deferred_flagged:
                            self._deferred_flagged.add(req.request_id)
                            self.events.emit(ev.DEFERRED, req.request_id,
                                             bucket=self.core.window,
                                             **d.event_data())
                        break
                    self._queue.pop(0)
                    self._deferred_flagged.discard(req.request_id)
                    now = self.clock()
                    slot = self.core.join(req, now)
                    handle = self.handles[req.request_id]
                    handle._advance(ADMITTED, now)
                    q = handle.spans.get("queued")
                    if q is not None:
                        self.tracer.end(q, t=now)
                    self.events.emit(ev.SCHEDULED, req.request_id,
                                     bucket=self.core.window, slot=slot,
                                     kv_bytes=d.est_bytes,
                                     active=self.core.active_count,
                                     **d.event_data())
                    handle._advance(RUNNING, now)
                    handle.spans["running"] = self.tracer.begin(
                        "running", process=PROC_REQUESTS,
                        thread=f"req-{req.request_id}",
                        parent=handle.spans.get("request"), t=now,
                        slot=slot, window=self.core.window)
                    self.events.emit(ev.BATCH_START, req.request_id,
                                     bucket=self.core.window, slot=slot)
                    joined += 1
                if joined:
                    self.core.metrics.record_queue_depth(len(self._queue))
                    self.core.metrics.record_kv(
                        self.core.kv_bytes_in_use(),
                        self.core.admission.bytes_per_request)
                return joined, expired
        finally:
            self.events.dispatch()

    def _finish_step(self, emissions: list,
                     finished: list[LMResult]) -> None:
        with self._lock:
            now = self.clock()
            for rid, step_idx, tok, slot in emissions:
                self.events.emit(ev.TOKEN, rid, step=step_idx, token=tok,
                                 slot=slot)
            for res in finished:
                handle = self.handles.pop(res.request_id)
                self.events.emit(ev.BATCH_DONE, res.request_id,
                                 bucket=self.core.window, run_ms=res.run_ms,
                                 compile_ms=res.compile_ms, steps=res.steps)
                handle._result = res
                handle._advance(DONE, now)
                self._end_request_spans(handle, res.status, now)
                self.events.emit(ev.COMPLETED, res.request_id,
                                 status=res.status, tokens=res.new_tokens,
                                 queue_wait_ms=res.queue_wait_ms,
                                 run_ms=res.run_ms,
                                 kernel_backend=res.kernel_backend)
            if finished:
                self._cond.notify_all()
        self.events.dispatch()

    def drive(self, max_steps: int | None = None) -> list[LMResult]:
        """Inline pump: join + step until every slot AND the queue drain
        (or ``max_steps`` decode steps ran).  Returns every result that
        became terminal during the call, in completion order."""
        out: list[LMResult] = []
        n = 0
        while max_steps is None or n < max_steps:
            joined, expired = self._join_turn()
            out.extend(expired)
            if self.core.active_count == 0:
                break                     # idle (or budget-starved queue)
            emissions, finished = self.core.step()
            n += 1
            self._finish_step(emissions, finished)
            out.extend(finished)
        return out

    def run(self, prompts: Iterable[np.ndarray], *,
            max_new_tokens: int | None = None,
            reset_metrics: bool = True) -> list[LMResult]:
        """Submit a trace, drain it, return results in request order."""
        if reset_metrics:
            self.core.metrics = LMMetrics()
        t0 = time.perf_counter()
        for p in prompts:
            self.submit(p, max_new_tokens=max_new_tokens)
        self.drive()
        self.core.metrics.wall_s = time.perf_counter() - t0
        return sorted(self.core.metrics.results,
                      key=lambda r: r.request_id)

    # -- background driver -------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._driver is not None and self._driver.is_alive():
                return
            self.events.reopen()
            self._stop = False
            self._driver = threading.Thread(
                target=self._driver_loop, name="lm-client-driver",
                daemon=True)
            self._driver.start()

    def stop(self, *, drain: bool = True) -> None:
        with self._lock:
            self._stop = True
            self._cond.notify_all()
        d = self._driver
        if d is not None:
            d.join()
        self._driver = None
        if drain:
            t0 = time.perf_counter()
            self.drive()
            self.core.metrics.add_wall_s(time.perf_counter() - t0)
        self.events.dispatch()
        with self._lock:
            self.events.close()

    def close(self) -> None:
        """Stop (serving what was accepted) and release the engine's device
        memory: its graph, pool and KV ring."""
        self.stop(drain=True)
        self.core.close()

    @property
    def driving(self) -> bool:
        d = self._driver
        return d is not None and d.is_alive()

    def _driver_loop(self) -> None:
        # progress = joined-or-stepped: a decode step that emits tokens but
        # finishes nothing is still progress (FoldClient's results-based
        # signal would sleep 0.5s mid-generation and stall every stream)
        last = time.perf_counter()

        def accrue() -> None:
            nonlocal last
            now = time.perf_counter()
            self.core.metrics.add_wall_s(now - last)
            last = now

        while True:
            with self._lock:
                if self._stop:
                    accrue()
                    return
            try:
                joined, _ = self._join_turn()
                stepped = False
                if self.core.active_count:
                    emissions, finished = self.core.step()
                    self._finish_step(emissions, finished)
                    stepped = True
                made_progress = bool(joined) or stepped
            except Exception as e:
                self._record_driver_error(e)
                made_progress = False
            accrue()
            if made_progress:
                continue
            with self._lock:
                if self._stop:
                    accrue()
                    return
                self._cond.wait(0.5 if not self._queue else 0.01)
            accrue()

    # -- result waiting -------------------------------------------------------
    def _wait(self, handle: FoldHandle, timeout: float | None) -> LMResult:
        if self.driving:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            with self._lock:
                while handle._status not in TERMINAL_STATES:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"request {handle.request_id} still "
                            f"{handle._status} after {timeout}s")
                    if not self._cond.wait(remaining):
                        raise TimeoutError(
                            f"request {handle.request_id} still "
                            f"{handle._status} after {timeout}s")
                return handle._result
        t0 = time.monotonic()
        while handle.status not in TERMINAL_STATES:
            results = self.drive(max_steps=1)
            if handle.status in TERMINAL_STATES:
                break
            if not results and self.core.active_count == 0 \
                    and not self.pending:
                raise RuntimeError(
                    f"request {handle.request_id} is {handle.status} but "
                    f"the queue is empty and no driver is running")
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"request {handle.request_id} still {handle.status} "
                    f"after {timeout}s")
        return handle._result
