"""Serving telemetry (port of ``repro/serving/metrics.py``): per-request
records, per-bucket aggregates (means AND p50/p95/p99 tails for queue wait
+ run latency), and a graph-capture counter (so tests can assert
steady-state = zero new captures).

Report output is CSV (one row per request; ``save()`` appends ``#``-prefixed
summary-footer lines with the latency percentiles) or JSON (records + bucket
and engine summaries, percentiles included) — the shapes the benchmarks and
the serve CLI print.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import IO

from repro_torch.serving.observability.registry import (FRACTION_BUCKETS,
                                                  MetricsRegistry)
from repro_torch.serving.types import (CANCELLED, EXPIRED, FAILED, REJECTED,
                                 FoldResult)


def percentiles(values, qs=(50, 95, 99)) -> dict[str, float]:
    """Linear-interpolated percentiles as {"p50": ..., ...}; zeros when
    empty so report shapes are stable."""
    if not values:
        return {f"p{q}": 0.0 for q in qs}
    s = sorted(values)
    out = {}
    for q in qs:
        k = (len(s) - 1) * q / 100.0
        lo, hi = math.floor(k), math.ceil(k)
        out[f"p{q}"] = s[lo] if lo == hi else s[lo] + (s[hi] - s[lo]) * (k - lo)
    return out


def _latency_summary(values) -> dict[str, float]:
    mean = sum(values) / len(values) if values else 0.0
    return {"mean": mean, **percentiles(values)}

# -- graph-capture counter --------------------------------------------------
# Every executable-cache miss of an engine (a CUDA graph captured on the
# card, a key registered for eager execution on the CPU) calls
# ``note_capture()``.  The engine's own cache-miss counter is the
# authoritative per-executable count; this process-wide count is what a
# ``CompileWatcher`` reads between ``mark()`` and ``delta()``.  The count is
# EPOCHED: ``reset_compile_watch()`` starts a new epoch (every EngineCore
# does this at construction), and a watcher whose mark predates the current
# epoch measures from the epoch boundary instead, so a second engine's
# "zero steady-state captures" assertion can't be polluted by captures the
# first engine made before the reset.
_CAPTURES = 0
_WATCH_EPOCH = 0
_EPOCH_BASE = 0           # _CAPTURES snapshot at the last reset
_CAPTURE_LOCK = threading.Lock()


def note_capture() -> None:
    """Count one executable-cache miss (a graph capture on the card)."""
    global _CAPTURES
    with _CAPTURE_LOCK:
        _CAPTURES += 1


def reset_compile_watch() -> int:
    """Start a new capture-watch epoch: existing watchers measure from
    this boundary (not their older marks) until they re-``mark()``.
    Returns the new epoch id."""
    global _WATCH_EPOCH, _EPOCH_BASE
    with _CAPTURE_LOCK:
        _WATCH_EPOCH += 1
        _EPOCH_BASE = _CAPTURES
        return _WATCH_EPOCH


class CompileWatcher:
    """Counts executable-cache misses (graph captures) between ``mark()``
    and ``delta()``.

    Epoch-aware: when ``reset_compile_watch()`` ran after this watcher's
    mark (a new engine was stood up), ``delta()`` counts from the epoch
    boundary instead of the stale mark, so captures that belonged to the
    previous engine's lifetime can't leak into this window."""

    available = True

    def __init__(self):
        self.mark()

    def mark(self) -> None:
        self._epoch = _WATCH_EPOCH
        self._mark = _CAPTURES

    #: explicit alias: re-baseline this watcher at "now"
    reset = mark

    def delta(self) -> int:
        base = (_EPOCH_BASE if self._epoch != _WATCH_EPOCH else self._mark)
        return _CAPTURES - base


# -- aggregation ------------------------------------------------------------
@dataclasses.dataclass
class BucketStats:
    bucket: int
    requests: int = 0
    rejected: int = 0
    cancelled: int = 0
    expired: int = 0
    failed: int = 0
    tokens_real: int = 0
    tokens_padded: int = 0
    wait_samples: list = dataclasses.field(default_factory=list)
    run_samples: list = dataclasses.field(default_factory=list)
    compile_ms: float = 0.0
    compiles: int = 0

    @property
    def padding_waste(self) -> float:
        if not self.tokens_padded:
            return 0.0
        return 1.0 - self.tokens_real / self.tokens_padded

    def as_dict(self) -> dict:
        wait = _latency_summary(self.wait_samples)
        run = _latency_summary(self.run_samples)
        return {
            "bucket": self.bucket, "requests": self.requests,
            "rejected": self.rejected, "cancelled": self.cancelled,
            "expired": self.expired, "failed": self.failed,
            "mean_queue_wait_ms": wait["mean"],
            "mean_run_ms": run["mean"],
            "queue_wait_ms": wait, "run_ms": run,
            "compile_ms": self.compile_ms, "compiles": self.compiles,
            "padding_waste": self.padding_waste,
        }


CSV_HEADER = ("request,len,bucket,batch,status,priority,queue_ms,compile_ms,"
              "run_ms,tm_vs_fp,padding_frac,occupancy,est_act_mb,"
              "kernel_backend,placement,chunk_size")


def csv_row(r: FoldResult) -> str:
    tm = "" if r.tm_vs_fp is None else f"{r.tm_vs_fp:.4f}"
    return (f"{r.request_id},{r.length},{r.bucket},{r.batch_size},{r.status},"
            f"{r.priority},"
            f"{r.queue_wait_ms:.1f},{r.compile_ms:.1f},{r.run_ms:.1f},{tm},"
            f"{r.padding_frac:.3f},{r.occupancy:.3f},"
            f"{r.est_activation_bytes / 1e6:.1f},"
            f"{r.kernel_backend},{r.placement},{r.chunk_size}")


class EngineMetrics:
    """Aggregates are guarded by an internal lock: the background driver
    records batch results off the client lock while cancel/expire/reject
    paths record under it — without this, concurrent ``+=`` on bucket
    counters would lose updates in thread-driver mode."""

    def __init__(self):
        self.results: list[FoldResult] = []
        self._buckets: dict[int, BucketStats] = {}
        self.wall_s: float = 0.0
        # pipeline + occupancy telemetry (recorded per dispatched batch)
        self.inflight_depth: int = 0       # configured ring depth
        self.max_inflight: int = 0         # deepest observed ring
        self.batch_occupancies: list[float] = []
        self.linger_ms: float = 0.0        # configured fill-or-timeout
        self.linger_holds: int = 0         # scheduler hold decisions
        self._lock = threading.Lock()
        # labeled instrument registry: the Prometheus/JSON scrape surface.
        # Every record_* below feeds both the legacy aggregates (summary/
        # CSV/JSON report shapes stay byte-compatible) and these series.
        self.registry = MetricsRegistry()
        reg = self.registry
        self._m_requests = reg.counter(
            "fold_requests_total", "Requests by terminal status",
            ("status", "bucket"))
        self._m_tokens = reg.counter(
            "fold_tokens_total", "Real (unpadded) tokens served", ("bucket",))
        self._m_queue_wait = reg.histogram(
            "fold_queue_wait_seconds", "Submit-to-dispatch queue wait",
            ("bucket",))
        self._m_run = reg.histogram(
            "fold_run_seconds", "Dispatch-to-retire batch latency",
            ("bucket", "placement", "backend"))
        self._m_compiles = reg.counter(
            "fold_compiles_total", "Executable-cache misses (graph captures)",
            ("bucket", "scheme", "placement"))
        self._m_compile_s = reg.counter(
            "fold_compile_seconds_total", "Seconds spent capturing graphs",
            ("bucket", "scheme", "placement"))
        self._m_batches = reg.counter(
            "fold_batches_total", "Batches dispatched",
            ("bucket", "scheme", "placement"))
        self._m_occupancy = reg.histogram(
            "fold_batch_occupancy", "Token occupancy of dispatched batches",
            ("bucket",), buckets=FRACTION_BUCKETS)
        self._m_inflight = reg.gauge(
            "fold_inflight_batches", "Batches currently in the ring")
        self._m_inflight_depth = reg.gauge(
            "fold_inflight_depth", "Configured in-flight ring depth")
        self._m_linger = reg.counter(
            "fold_linger_holds_total", "Scheduler fill-or-timeout holds")
        self._m_admission = reg.counter(
            "fold_admission_decisions_total", "Admission verdicts",
            ("verdict", "bucket", "estimator"))
        self._m_queue_depth = reg.gauge(
            "fold_queue_depth", "Requests pending in scheduler queues")
        self._m_pinned = reg.gauge(
            "fold_pinned_distogram_bytes",
            "Device bytes pinned by unfetched lazy distograms")
        self._m_wall = reg.counter(
            "fold_wall_seconds_total", "Serving wall-clock seconds")
        self._m_driver_errors = reg.counter(
            "fold_driver_errors_total", "Background driver loop errors")
        self._m_driver_dropped = reg.counter(
            "fold_driver_errors_dropped_total",
            "Driver errors evicted from the bounded ring")
        # cost-model telemetry: table inventory, how well predictions track
        # reality, and what the priced linger/feasibility decisions did
        self._m_cost_entries = reg.gauge(
            "fold_cost_table_entries", "Cost-table entries by source",
            ("source",))
        self._m_cost_age = reg.gauge(
            "fold_cost_table_age_seconds",
            "Seconds since the cost table was calibrated (-1 = never)")
        self._m_pred_error = reg.histogram(
            "fold_cost_prediction_error_ratio",
            "Predicted-vs-actual batch run ms, as max(p/a, a/p)")
        self._m_linger_decisions = reg.counter(
            "fold_linger_decisions_total",
            "Linger hold/launch decisions by policy", ("decision",))
        self._m_infeasible = reg.counter(
            "fold_infeasible_total",
            "Requests terminated as deadline-infeasible", ("stage",))
        self.prediction_errors: list[float] = []   # max(p/a, a/p) factors
        self.cost_table_entries: int = 0
        self.cost_table_calibrated: int = 0
        self.cost_table_age_s: float | None = None
        self.linger_bad_holds: int = 0
        self.linger_decisions: dict[str, int] = {}
        self.infeasible: dict[str, int] = {}

    def record(self, r: FoldResult) -> None:
        self._m_requests.inc(status=r.status, bucket=r.bucket)
        if r.ok:
            self._m_tokens.inc(r.length, bucket=r.bucket)
            self._m_queue_wait.observe(r.queue_wait_ms / 1e3, bucket=r.bucket)
            self._m_run.observe(r.run_ms / 1e3, bucket=r.bucket,
                                placement=r.placement,
                                backend=r.kernel_backend)
        with self._lock:
            self.results.append(r)
            st = self._buckets.setdefault(r.bucket, BucketStats(r.bucket))
            st.requests += 1
            if not r.ok:
                if r.status == REJECTED:
                    st.rejected += 1
                elif r.status == CANCELLED:
                    st.cancelled += 1
                elif r.status == EXPIRED:
                    st.expired += 1
                elif r.status == FAILED:
                    st.failed += 1
                return
            st.tokens_real += r.length
            st.tokens_padded += r.bucket
            st.wait_samples.append(r.queue_wait_ms)
            st.run_samples.append(r.run_ms)
            # per-bucket compile_ms accrues once per compilation
            # (record_compile), NOT per request — every request in a batch
            # carries the same FoldResult.compile_ms, summing those would
            # multiply by batch size

    def add_wall_s(self, dt: float) -> None:
        """Accrue serving wall time (the background driver calls this
        continuously, so a server-mode ``summary()`` reports truthful
        requests_per_s/tokens_per_s without anyone assigning ``wall_s``)."""
        with self._lock:
            self.wall_s += dt
        self._m_wall.inc(max(dt, 0.0))

    def record_compile(self, bucket: int, ms: float, *,
                       scheme: str = "", placement: str = "single") -> None:
        with self._lock:
            st = self._buckets.setdefault(bucket, BucketStats(bucket))
            st.compiles += 1
            st.compile_ms += ms
        self._m_compiles.inc(bucket=bucket, scheme=scheme,
                             placement=placement)
        self._m_compile_s.inc(max(ms, 0.0) / 1e3, bucket=bucket,
                              scheme=scheme, placement=placement)

    def record_dispatch(self, inflight_now: int, depth: int,
                        occupancy: float, *, bucket: int = 0,
                        scheme: str = "", placement: str = "single") -> None:
        """Per-batch pipeline telemetry (the engine core calls this on
        every ``dispatch``): ring depth config + deepest observed ring +
        the batch's token occupancy."""
        with self._lock:
            self.inflight_depth = depth
            self.max_inflight = max(self.max_inflight, inflight_now)
            self.batch_occupancies.append(occupancy)
        self._m_batches.inc(bucket=bucket, scheme=scheme,
                            placement=placement)
        self._m_occupancy.observe(occupancy, bucket=bucket)
        self._m_inflight.set(inflight_now)
        self._m_inflight_depth.set(depth)

    def record_linger(self, holds: int, linger_ms: float) -> None:
        """Sync the scheduler's fill-or-timeout counters (idempotent; the
        client calls this each scheduling turn)."""
        with self._lock:
            delta = holds - self.linger_holds
            self.linger_holds = holds
            self.linger_ms = linger_ms
        if delta > 0:
            self._m_linger.inc(delta)

    def record_prediction(self, predicted_ms: float, actual_ms: float) -> None:
        """One batch's predicted-vs-actual run latency, recorded as the
        symmetric error factor max(p/a, a/p) — 1.0 is a perfect model."""
        if predicted_ms <= 0.0 or actual_ms <= 0.0:
            return
        factor = max(predicted_ms / actual_ms, actual_ms / predicted_ms)
        with self._lock:
            self.prediction_errors.append(factor)
        self._m_pred_error.observe(factor)

    def record_cost_table(self, entries: int, calibrated: int,
                          age_s: float | None) -> None:
        """Cost-table inventory gauges (the engine calls this per retire;
        the serve CLI once after load/calibrate)."""
        with self._lock:
            self.cost_table_entries = entries
            self.cost_table_calibrated = calibrated
            self.cost_table_age_s = age_s
        self._m_cost_entries.set(calibrated, source="calibrated")
        self._m_cost_entries.set(entries - calibrated, source="online")
        self._m_cost_age.set(-1.0 if age_s is None else age_s)

    def record_linger_decisions(self, decisions: dict, bad_holds: int) -> None:
        """Sync the scheduler's adaptive/fixed linger decision tallies
        (idempotent, same delta pattern as ``record_linger``)."""
        with self._lock:
            for k, v in decisions.items():
                delta = v - self.linger_decisions.get(k, 0)
                if delta > 0:
                    self._m_linger_decisions.inc(delta, decision=k)
                self.linger_decisions[k] = v
            self.linger_bad_holds = bad_holds

    def record_infeasible(self, stage: str) -> None:
        """One request terminated as deadline-infeasible; ``stage`` is
        "submit" (rejected at intake) or "queue" (purged mid-queue)."""
        with self._lock:
            self.infeasible[stage] = self.infeasible.get(stage, 0) + 1
        self._m_infeasible.inc(stage=stage)

    def record_admission(self, verdict: str, bucket: int,
                         estimator: str = "cubic") -> None:
        """One admission decision (ADMIT/REJECT/DEFER), including probes.
        ``estimator`` names the cost model that priced it (cubic | q_chunk
        | chunked:<C>), so chunked-vs-unchunked verdict mix is scrapeable."""
        self._m_admission.inc(verdict=verdict, bucket=bucket,
                              estimator=estimator)

    def record_queue_depth(self, n: int) -> None:
        self._m_queue_depth.set(n)

    def record_inflight(self, n: int) -> None:
        self._m_inflight.set(n)

    def record_pinned(self, delta_bytes: int) -> None:
        """Track device bytes pinned by unfetched lazy distograms
        (positive on retire, negative when a host fetch releases them)."""
        self._m_pinned.inc(delta_bytes)

    def record_driver_error(self, dropped: bool = False) -> None:
        self._m_driver_errors.inc()
        if dropped:
            self._m_driver_dropped.inc()

    def summary(self) -> dict:
        with self._lock:       # one consistent snapshot: a racing record()
            # could otherwise resize _buckets mid-iteration
            results = list(self.results)
            compiles = sum(b.compiles for b in self._buckets.values())
            bucket_dicts = [self._buckets[b].as_dict()
                            for b in sorted(self._buckets)]
            occs = list(self.batch_occupancies)
            pipeline = {
                "inflight_depth": self.inflight_depth,
                "max_inflight": self.max_inflight,
                "batches": len(occs),
                "mean_batch_occupancy": (sum(occs) / len(occs)
                                         if occs else 0.0),
                "linger_ms": self.linger_ms,
                "linger_holds": self.linger_holds,
            }
            errs = list(self.prediction_errors)
            cost_model = {
                "table_entries": self.cost_table_entries,
                "table_calibrated": self.cost_table_calibrated,
                "table_age_s": self.cost_table_age_s,
                "predictions": len(errs),
                "prediction_error": {
                    "mean": sum(errs) / len(errs) if errs else 0.0,
                    **percentiles(errs),
                },
                "linger_decisions": dict(self.linger_decisions),
                "linger_bad_holds": self.linger_bad_holds,
                "infeasible": dict(self.infeasible),
            }
        served = [r for r in results if r.ok]
        tokens = sum(r.length for r in served)
        by_status = {s: sum(1 for r in results if r.status == s)
                     for s in (REJECTED, CANCELLED, EXPIRED, FAILED)}
        out = {
            "requests": len(results),
            "served": len(served),
            "rejected": by_status[REJECTED],
            "cancelled": by_status[CANCELLED],
            "expired": by_status[EXPIRED],
            "failed": by_status[FAILED],
            "tokens": tokens,
            "wall_s": self.wall_s,
            "requests_per_s": len(served) / self.wall_s if self.wall_s else 0.0,
            "tokens_per_s": tokens / self.wall_s if self.wall_s else 0.0,
            "compiles": compiles,
            "queue_wait_ms": _latency_summary(
                [r.queue_wait_ms for r in served]),
            "run_ms": _latency_summary([r.run_ms for r in served]),
            "max_est_act_mb": max(
                (r.est_activation_bytes for r in served), default=0) / 1e6,
            "pipeline": pipeline,
            "cost_model": cost_model,
            "buckets": bucket_dicts,
        }
        return out

    # -- reports ----------------------------------------------------------
    def write_csv(self, fh: IO[str], *, summary_footer: bool = False) -> None:
        with self._lock:
            results = list(self.results)
        fh.write(CSV_HEADER + "\n")
        for r in results:
            fh.write(csv_row(r) + "\n")
        if summary_footer:
            s = self.summary()
            for key in ("queue_wait_ms", "run_ms"):
                row = " ".join(f"{k}={v:.1f}" for k, v in s[key].items())
                fh.write(f"# {key} {row}\n")

    def write_json(self, fh: IO[str]) -> None:
        with self._lock:
            results = list(self.results)
        json.dump({"summary": self.summary(),
                   "requests": [self._req_dict(r) for r in results]},
                  fh, indent=2)

    @staticmethod
    def _req_dict(r: FoldResult) -> dict:
        return {
            "request_id": r.request_id, "length": r.length,
            "bucket": r.bucket, "batch_size": r.batch_size,
            "status": r.status, "reason": r.reason, "priority": r.priority,
            "queue_wait_ms": r.queue_wait_ms, "compile_ms": r.compile_ms,
            "run_ms": r.run_ms, "tm_vs_fp": r.tm_vs_fp,
            "padding_frac": r.padding_frac,
            "launched_batch": r.launched_batch,
            "occupancy": r.occupancy,
            "est_activation_bytes": r.est_activation_bytes,
            "kernel_backend": r.kernel_backend,
            "placement": r.placement,
            "chunk_size": r.chunk_size,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            if path.endswith(".json"):
                self.write_json(fh)
            else:
                self.write_csv(fh, summary_footer=True)
