"""Measured cost model: calibrated executable latencies priced into
scheduling decisions (port of ``repro/serving/costmodel.py``).

One ``CostModel`` rides on each ``EngineCore``; its entries are keyed by the
SAME 5-tuple as the executable cache, ``(bucket, launch_batch, scheme,
placement, chunk)``, so every cached executable (a CUDA graph on the card)
has exactly one latency row.

Two sources feed an entry, deliberately kept separate:

  * ``calibrated_ms``: written only by ``calibrate()``, which replays the
    cached executable with synthetic full-occupancy inputs, warm,
    median-of-k, timed by CUDA events around the replay on the card (the
    engine clock on the CPU).  The decisions that change launched shapes or
    reject requests (``launch_size_for`` pricing, deadline feasibility)
    read ONLY this field, so a persisted table reloaded by a restart
    reproduces the same decisions.
  * ``run_ms``: the live EWMA; every ``retire()`` feeds the batch's
    launch-to-ready latency back in (``observe``), so soft, reversible
    decisions (adaptive linger, prediction-error telemetry) track the
    machine the engine runs on.

``save()``/``load()`` persist the table as provenance-stamped JSON (git
sha, torch and CUDA versions, the card's name); ``--cost-table PATH``
reloads it and ``EngineCore.warmup_from_table`` captures every key the
previous run needed, so serving makes zero captures from the first batch.

The reference also calibrates kernel-dispatch floors (the shapes below
which its plain versions beat its kernels).  The port sends every shape on
the card to the kernels, so it has no floors: ``floors`` stays empty and is
persisted as such.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import platform
import sys
import time

CALIBRATED = "calibrated"
ONLINE = "online"

#: the executable-cache key the table is indexed by
Key = tuple  # (bucket, launch_batch, scheme_name, placement_label, chunk)

TABLE_VERSION = 1


def _provenance() -> dict:
    """Environment facts stamped into every persisted table: a latency
    without the device and versions that produced it is not a latency."""
    import torch
    try:
        import subprocess
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10).stdout.strip() or None
    except Exception:
        sha = None
    cuda = torch.cuda.is_available()
    return {
        "git_sha": sha,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "timestamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def _key_str(key: Key) -> str:
    return "|".join(str(p) for p in key)


def _key_from_str(s: str) -> Key:
    bucket, batch, scheme, label, chunk = s.split("|")
    return (int(bucket), int(batch), scheme, label, int(chunk))


@dataclasses.dataclass
class CostEntry:
    """Measured latencies for one executable-cache key (all milliseconds).

    ``calibrated_ms`` is frozen at calibration (None = this key has only
    been seen live); ``run_ms`` is the live EWMA over observed batch
    latencies, seeded from the calibration when one exists.
    """
    run_ms: float
    calibrated_ms: float | None = None
    compile_ms: float = 0.0
    samples: int = 0
    source: str = ONLINE

    def as_dict(self) -> dict:
        return {"run_ms": self.run_ms, "calibrated_ms": self.calibrated_ms,
                "compile_ms": self.compile_ms, "samples": self.samples,
                "source": self.source}

    @classmethod
    def from_dict(cls, d: dict) -> "CostEntry":
        return cls(run_ms=float(d["run_ms"]),
                   calibrated_ms=(None if d.get("calibrated_ms") is None
                                  else float(d["calibrated_ms"])),
                   compile_ms=float(d.get("compile_ms", 0.0)),
                   samples=int(d.get("samples", 0)),
                   source=str(d.get("source", ONLINE)))


class CostModel:
    """Per-executable measured latencies + the predictors the scheduler,
    and engine price their decisions against.

    ``bind(core)`` attaches the host engine so bucket-level helpers
    (``solo_ms``, ``marginal_row_ms``, ...) can resolve the full cache key
    (scheme / placement label / chunk) the way the engine would; unbound
    models (scheduler-only tests, the linger-policy bench) use a fixed
    ``(default, single, 0)`` context.
    """

    def __init__(self, *, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.entries: dict[Key, CostEntry] = {}
        #: dispatch floors (the reference's table field; the port has none
        #: and keeps it empty):
        #: {"flash_seq": int, "qmm_tokens": int, "source": str}
        self.floors: dict = {}
        self.provenance: dict = {}
        self.calibrated_at: float | None = None   # wall epoch seconds
        self._core = None

    # -- context -----------------------------------------------------------
    def bind(self, core) -> "CostModel":
        self._core = core
        return self

    def key_for(self, bucket: int, batch: int) -> Key:
        """The executable-cache key the bound engine would use for this
        (bucket, batch) — scheme, placement label, and chunk resolved the
        same way ``EngineCore._executable`` resolves them."""
        core = self._core
        if core is None:
            return (bucket, batch, "default", "single", 0)
        return (bucket, batch, core.scheme.name,
                core.placement.placement_for(bucket).label,
                core.chunk.chunk_for(bucket) or 0)

    # -- recording ---------------------------------------------------------
    def observe(self, key: Key, run_ms: float) -> None:
        """Live EWMA refinement: one retired batch's measured
        launch-to-ready latency for its executable key."""
        e = self.entries.get(key)
        if e is None:
            self.entries[key] = CostEntry(run_ms=run_ms, samples=1)
            return
        e.run_ms += self.alpha * (run_ms - e.run_ms)
        e.samples += 1

    def record_calibration(self, key: Key, run_ms: float, *,
                           samples: int) -> None:
        """A calibration measurement: freezes ``calibrated_ms`` and
        re-seeds the live EWMA from it."""
        e = self.entries.get(key)
        if e is None:
            e = self.entries[key] = CostEntry(run_ms=run_ms)
        e.run_ms = run_ms
        e.calibrated_ms = run_ms
        e.samples = samples
        e.source = CALIBRATED

    def record_compile(self, key: Key, compile_ms: float) -> None:
        """The measured graph-capture cost of this key (the engine calls
        this on every executable-cache miss)."""
        e = self.entries.get(key)
        if e is None:
            e = self.entries[key] = CostEntry(run_ms=0.0, samples=0)
        e.compile_ms = compile_ms

    # -- predictors --------------------------------------------------------
    def _entry_ms(self, e: CostEntry, calibrated_only: bool) -> float | None:
        if calibrated_only:
            return e.calibrated_ms
        return e.run_ms if e.samples > 0 or e.calibrated_ms is not None \
            else None

    def _bucket_points(self, bucket: int, *, calibrated_only: bool
                       ) -> list[tuple[int, float]]:
        """(batch, ms) samples for this bucket under the bound context,
        batch-ascending."""
        _, _, scheme, label, chunk = self.key_for(bucket, 1)
        pts = []
        for (bk, b, sn, pl, ck), e in self.entries.items():
            if (bk, sn, pl, ck) != (bucket, scheme, label, chunk):
                continue
            ms = self._entry_ms(e, calibrated_only)
            if ms is not None and ms > 0.0:
                pts.append((b, ms))
        return sorted(pts)

    def predict_run_ms(self, bucket: int, batch: int, *,
                       calibrated_only: bool = False) -> float | None:
        """Predicted launch-to-ready latency for a (bucket, batch) launch:
        the exact entry when one exists, linear interpolation between the
        two nearest measured batch sizes otherwise, per-row extrapolation
        past the largest.  None = no usable data for this bucket."""
        pts = self._bucket_points(bucket, calibrated_only=calibrated_only)
        if not pts:
            return None
        for b, ms in pts:
            if b == batch:
                return ms
        lo = [(b, ms) for b, ms in pts if b < batch]
        hi = [(b, ms) for b, ms in pts if b > batch]
        if lo and hi:
            (b0, m0), (b1, m1) = lo[-1], hi[0]
            return m0 + (m1 - m0) * (batch - b0) / (b1 - b0)
        if hi:       # below the smallest measured size: it can't cost more
            return hi[0][1]
        # above the largest: extrapolate at the measured per-row slope
        (b1, m1) = lo[-1]
        slope = self._slope(pts)
        return m1 + slope * (batch - b1)

    def _slope(self, pts: list[tuple[int, float]]) -> float:
        if len(pts) >= 2:
            (b0, m0), (b1, m1) = pts[0], pts[-1]
            if b1 > b0:
                return max((m1 - m0) / (b1 - b0), 0.0)
        b, ms = pts[-1]
        return ms / max(b, 1)

    def marginal_row_ms(self, bucket: int, *,
                        calibrated_only: bool = False) -> float | None:
        """Measured per-extra-row cost for this bucket — what one dummy
        row burns, what one filled row saves."""
        pts = self._bucket_points(bucket, calibrated_only=calibrated_only)
        if not pts:
            return None
        return self._slope(pts)

    def solo_ms(self, bucket: int, *,
                calibrated_only: bool = False) -> float | None:
        """Predicted batch-1 latency (the floor any request pays)."""
        return self.predict_run_ms(bucket, 1,
                                   calibrated_only=calibrated_only)

    def compile_ms_for(self, bucket: int) -> float | None:
        """Measured compile cost for this bucket's executables (the max
        over observed keys — a fresh size costs about what its neighbors
        cost).  None = no compile ever measured here."""
        _, _, scheme, label, chunk = self.key_for(bucket, 1)
        costs = [e.compile_ms for (bk, b, sn, pl, ck), e
                 in self.entries.items()
                 if (bk, sn, pl, ck) == (bucket, scheme, label, chunk)
                 and e.compile_ms > 0.0]
        return max(costs) if costs else None

    def queue_eta_ms(self, bucket: int, queued_ahead: int, cap: int
                     ) -> float | None:
        """Predicted wall ms until a request arriving NOW behind
        ``queued_ahead`` same-bucket requests completes, at the back of the
        bucket's queue: the full batches ahead of it, then its own batch.
        Calibrated entries only — this prices irreversible admission
        verdicts.  None = bucket uncalibrated."""
        solo = self.solo_ms(bucket, calibrated_only=True)
        if solo is None or cap < 1:
            return None
        full = self.predict_run_ms(bucket, cap, calibrated_only=True) or solo
        batches_ahead = queued_ahead // cap
        mine = min(queued_ahead % cap + 1, cap)
        my_run = self.predict_run_ms(bucket, mine,
                                     calibrated_only=True) or solo
        return batches_ahead * full + my_run

    # -- inventory ---------------------------------------------------------
    @property
    def entry_count(self) -> int:
        return len(self.entries)

    @property
    def calibrated_count(self) -> int:
        return sum(1 for e in self.entries.values()
                   if e.calibrated_ms is not None)

    def has_calibration(self) -> bool:
        return self.calibrated_count > 0

    def age_s(self) -> float | None:
        """Seconds since the table was calibrated (None = never)."""
        if self.calibrated_at is None:
            return None
        return max(time.time() - self.calibrated_at, 0.0)

    # -- persistence -------------------------------------------------------
    def as_dict(self) -> dict:
        return {
            "version": TABLE_VERSION,
            "provenance": self.provenance or _provenance(),
            "calibrated_at": self.calibrated_at,
            "alpha": self.alpha,
            "floors": dict(self.floors),
            "entries": {_key_str(k): e.as_dict()
                        for k, e in sorted(self.entries.items(),
                                           key=lambda kv: _key_str(kv[0]))},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh, indent=2)
            fh.write("\n")

    def load(self, path: str) -> "CostModel":
        """Merge a persisted table into this model (persisted entries win:
        a restart starts from the saved machine profile)."""
        with open(path) as fh:
            d = json.load(fh)
        if int(d.get("version", 0)) != TABLE_VERSION:
            raise ValueError(f"cost table {path} has version "
                             f"{d.get('version')!r}; expected "
                             f"{TABLE_VERSION}")
        for ks, ed in d.get("entries", {}).items():
            self.entries[_key_from_str(ks)] = CostEntry.from_dict(ed)
        self.floors = dict(d.get("floors", {}))
        self.provenance = dict(d.get("provenance", {}))
        if d.get("calibrated_at") is not None:
            self.calibrated_at = float(d["calibrated_at"])
        return self

    @classmethod
    def from_file(cls, path: str) -> "CostModel":
        return cls().load(path)


# --------------------------------------------------------------------------
# calibration
# --------------------------------------------------------------------------
def calibrate(core, *, passes: int = 3, ladder=None) -> "CostModel":
    """Replay every cached executable key with synthetic full-occupancy
    inputs (every mask position true) and record its latency: the median
    of ``passes`` warm runs, timed by CUDA events around the replay on the
    card and by the engine clock on the CPU.

    Runs ``core.warmup(ladder)`` first so the {1, cap//2, cap} ladder per
    bucket is cached, then times EVERY key in the executable cache.
    Returns the core's (now-calibrated) cost model.
    """
    core.warmup(ladder)
    model = core.cost_model
    tr = core.tracer
    for key in sorted(core._executables, key=_key_str):
        bucket, batch, scheme_name, label, chunk = key
        exe = core._executables[key]
        if core.placement.placement_for(bucket).label != label:
            continue        # stale placement config; don't mis-measure
        inputs = exe.synthetic_inputs()
        span = tr.begin("calibrate", process="engine", thread="calibrate",
                        bucket=bucket, launch_batch=batch,
                        scheme=scheme_name, placement=label, chunk=chunk)
        try:
            # one discarded warm run: the first call pays one-time setup
            # that steady-state batches never see
            core.workload.block_on(exe.launch(*inputs))
            samples = [exe.timed_ms(*inputs, clock=core.clock)
                       for _ in range(max(passes, 1))]
            med = sorted(samples)[len(samples) // 2]
        finally:
            tr.end(span, passes=passes)
        model.record_calibration(key, med, samples=len(samples))
    model.floors = {}
    model.calibrated_at = time.time()
    model.provenance = _provenance()
    return model


def load_cost_table(path: str) -> CostModel:
    """Load a persisted table; raises FileNotFoundError/ValueError on a
    missing or incompatible file (callers surface the error — a serve
    pointed at a bad table should fail loudly, not silently run naive)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"cost table {path} does not exist "
                                f"(run --calibrate to create one)")
    return CostModel.from_file(path)


def prediction_error_factor(predicted_ms: float, actual_ms: float) -> float:
    """Symmetric error factor: max(p/a, a/p); 1.0 is perfect, 2.0 means
    off by 2x in either direction (inf when either is not positive)."""
    if predicted_ms <= 0.0 or actual_ms <= 0.0:
        return math.inf
    return max(predicted_ms / actual_ms, actual_ms / predicted_ms)
