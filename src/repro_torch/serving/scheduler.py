"""Priority-aware token-budget continuous batching over length buckets
(port of ``repro/serving/scheduler.py``).

Requests queue per length bucket.  ``next_batch`` drains the bucket holding
the most urgent waiting request — urgency is ``(-priority, arrival_time,
request_id)``, so priority tiers strictly dominate and ties fall back to
FCFS (with every request at the default priority 0 this is exactly the old
oldest-request-first behavior) — and grows the batch, most urgent first,
while every constraint holds:

  * padded tokens ``(n+1) * bucket <= max_tokens_per_batch``
  * ``n + 1 <= max_batch``
  * the admission controller prices the grown batch under the memory
    budget; a growth that would bust the budget stops the batch (the rest
    of the queue is *deferred* to the next batch — the deferred request ids
    ride on ``ScheduledBatch.deferred`` so the client can surface DEFERRED
    events), and a request whose bucket busts the budget even at batch 1 is
    *rejected*.

Priority inversion is structurally impossible past one batch: a queued
high-priority request makes its bucket win ``next_batch`` regardless of how
many low-priority requests sit in other buckets, and within a bucket it is
picked into the batch before any lower tier.

Request lifecycle hooks (used by the FoldClient pump):

  * ``cancel(request_id)`` removes a still-queued request (False once it
    left the queue — it is in a batch or already terminal).  O(1): queued
    requests are indexed by id (``_live``); cancellation pops the index
    and the dead deque entry is compacted lazily the next time its bucket
    forms a batch or expiry sweeps — no per-cancel linear scan over every
    bucket queue;
  * ``purge_expired(now)`` removes and returns every queued request whose
    deadline has passed.  ``now`` must come from the same monotonic clock
    that stamped ``arrival_time``/``deadline_at`` at submit.

Continuous batching: ``submit`` may be called at any time, including
between ``next_batch`` calls — newly arrived requests join the next batch
of their bucket rather than waiting for a "wave" to finish.

Occupancy (fill-or-timeout): with ``linger_ms`` set, a batch that would
launch underfull only because its queue drained is held — up to
``linger_ms`` past its most urgent request's arrival — so same-bucket
arrivals can fill the rows that would otherwise burn FLOPs as fully-masked
padding.  Held buckets yield their turn to launchable ones; the pump polls
again after ``hold_until``.  ``linger_ms=0`` (default) launches
immediately, the historical behavior.

Cost-model pricing (``cost_model`` set): two decisions stop running on
guesses.  *Deadline feasibility* — a submit whose deadline is shorter than
the measured time to clear the bucket's queue (calibrated entries only;
online noise must never flip an irreversible verdict) is rejected
immediately with ``verdict="infeasible"`` instead of queueing to die, and
``purge_infeasible`` sweeps queued requests that can no longer make their
deadline even launched solo right now.  *Adaptive linger* — inside the
fixed ``linger_ms`` cap, a hold is kept only while the measured fill
benefit (solo cost an arrival would otherwise pay, minus its marginal
in-batch row cost) exceeds the predicted wait (median inter-arrival gap),
and dropped the moment the predicted next arrival is overdue — so bursts
fill batches and post-burst silence launches immediately instead of
burning the whole budget.  ``linger_bad_holds`` counts holds that never
attracted a fill (the bench compares it across policies).
"""
from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.serving.admission import ADMIT, REJECT, AdmissionController
from repro_torch.serving.types import FoldRequest


def pow2_buckets(min_len: int, max_len: int, floor: int = 16) -> tuple[int, ...]:
    """Power-of-two bucket edges covering [min_len, max_len]."""
    edges = []
    b = floor
    while b < max(min_len, floor):
        b *= 2
    while True:
        edges.append(b)
        if b >= max_len:
            break
        b *= 2
    return tuple(edges)


def parse_buckets(spec: str, min_len: int, max_len: int) -> tuple[int, ...]:
    """--buckets CLI spec: 'pow2' or comma-separated edges ('32,64,96')."""
    if spec == "pow2":
        return pow2_buckets(min_len, max_len)
    edges = tuple(sorted(int(tok) for tok in spec.split(",") if tok.strip()))
    if not edges:
        raise ValueError(f"empty bucket spec {spec!r}")
    return edges


def bucket_for(buckets: tuple[int, ...], length: int) -> int | None:
    """Smallest bucket edge holding ``length`` (None = too long).  The ONE
    shape-policy rule — the scheduler and the engine core both call this,
    so queued-under and reported buckets can never diverge."""
    for edge in buckets:
        if length <= edge:
            return edge
    return None


def _urgency(r: FoldRequest) -> tuple[float, float, int]:
    """Batch-formation order: priority tier, then FCFS, then id."""
    return (-r.priority, r.arrival_time, r.request_id)


def static_batch_for(bucket: int, max_tokens_per_batch: int, max_batch: int,
                     admission: AdmissionController | None = None) -> int:
    """The MAXIMUM batch size a bucket may launch at: token budget,
    max-batch cap, and the admission controller's memory cap.  The ONE
    shape-cap rule — the scheduler's linger policy and the engine core's
    launch sizing both call this, so "underfull" and "full" can never
    diverge between them."""
    n = min(max_batch, max(1, max_tokens_per_batch // bucket))
    if admission is not None and admission.mem_budget_bytes is not None:
        n = max(1, admission.max_batch_for(bucket, n))
    return n


@dataclasses.dataclass(frozen=True)
class ScheduledBatch:
    bucket: int
    requests: tuple[FoldRequest, ...]
    est_bytes: int                     # per-device under a sharded placement
    deferred: tuple[int, ...] = ()     # request ids left queued because
                                       # admission stopped this batch's growth
    placement: str = "single"          # PlacementPolicy label this bucket's
                                       # executable runs under
    chunk_size: int = 0                # long-fold ChunkPolicy plan for this
                                       # bucket (0 = unchunked trunk)

    @property
    def batch_size(self) -> int:
        return len(self.requests)


@dataclasses.dataclass(frozen=True)
class Rejection:
    request: FoldRequest
    reason: str
    verdict: str = "reject"     # "reject" (admission/shape) or
                                # "infeasible" (deadline priced vs measured
                                # latency at submit)


class TokenBudgetScheduler:
    def __init__(self, buckets: tuple[int, ...], *,
                 max_tokens_per_batch: int = 1024, max_batch: int = 8,
                 admission: AdmissionController | None = None,
                 placement=None, chunk=None, linger_ms: float = 0.0,
                 tracer=None, cost_model=None, adaptive_linger: bool = True):
        if not buckets:
            raise ValueError("need at least one bucket edge")
        if linger_ms < 0:
            raise ValueError(f"linger_ms must be >= 0, got {linger_ms}")
        self.buckets = tuple(sorted(buckets))
        self.max_tokens_per_batch = max_tokens_per_batch
        self.max_batch = max_batch
        self.admission = admission
        self.placement = placement     # PlacementPolicy (or None = single)
        self.chunk = chunk             # ChunkPolicy (or None = unchunked)
        # fill-or-timeout: an underfull-because-queue-drained batch is held
        # up to linger_ms past its most urgent request's arrival, hoping
        # same-bucket arrivals fill its would-be dummy rows (0 = launch
        # immediately, the historical behavior)
        self.linger_ms = linger_ms
        self.tracer = tracer           # optional span Tracer: hold markers
        # measured-latency pricing (None = every decision stays heuristic)
        self.cost_model = cost_model
        self.adaptive_linger = adaptive_linger
        self.linger_holds = 0          # next_batch turns that held a bucket
        self.linger_bad_holds = 0      # holds that never attracted a fill
        self.infeasible_rejects = 0    # submits rejected as deadline-infeasible
        # adaptive-vs-fixed decision tallies (observability series)
        self.linger_decisions: dict[str, int] = {
            "hold_adaptive": 0, "launch_adaptive": 0,
            "hold_fixed": 0, "launch_fixed": 0}
        self.hold_until: float | None = None   # earliest launch time among
                                               # buckets held this turn
        self._queues: dict[int, deque[FoldRequest]] = {
            b: deque() for b in self.buckets}
        # recent same-bucket arrival times (client clock): the adaptive
        # linger's arrival-rate estimate
        self._arrivals: dict[int, deque[float]] = {
            b: deque(maxlen=16) for b in self.buckets}
        # per-bucket (size_at_last_hold, holds_pending): holds whose batch
        # never grew before launching are counted bad at launch time
        self._hold_state: dict[int, tuple[int, int]] = {}
        # queued requests by id: O(1) cancellation and the authoritative
        # ``pending`` count (deques may carry cancelled tombstones until
        # their bucket is next compacted)
        self._live: dict[int, FoldRequest] = {}

    # -- intake -----------------------------------------------------------
    def bucket_for(self, length: int) -> int | None:
        return bucket_for(self.buckets, length)

    def submit(self, req: FoldRequest, now: float) -> Rejection | None:
        """Queue a request; returns a Rejection if it can never be served.

        ``now`` stamps ``arrival_time`` and anchors the absolute deadline —
        it must be the client's monotonic clock, never wall time.
        """
        req.arrival_time = now
        if req.deadline_s is not None:
            req.deadline_at = now + req.deadline_s
        bucket = self.bucket_for(req.length)
        if bucket is None:
            return Rejection(req, f"length {req.length} exceeds max bucket "
                                  f"{self.buckets[-1]}")
        if self.admission is not None:
            d = self.admission.admit(bucket, 1)
            if d.verdict == REJECT:
                return Rejection(req, d.reason)
        eta = self._admission_eta_ms(bucket)
        if (eta is not None and req.deadline_s is not None
                and req.deadline_s * 1e3 < eta):
            # priced against MEASURED latency: queueing this request would
            # only let it die in purge_expired; surface the verdict now
            self.infeasible_rejects += 1
            return Rejection(
                req,
                f"deadline infeasible: predicted completion {eta:.1f}ms at "
                f"the back of bucket {bucket}'s queue exceeds deadline "
                f"{req.deadline_s * 1e3:.1f}ms",
                verdict="infeasible")
        self._queues[bucket].append(req)
        self._live[req.request_id] = req
        self._arrivals[bucket].append(now)
        return None

    def _admission_eta_ms(self, bucket: int) -> float | None:
        """Predicted ms for a request arriving NOW to complete at the back
        of its bucket's queue, in measured (calibrated-only) latencies.
        None = no calibration for this bucket — feasibility is then not
        checked, the historical behavior."""
        if self.cost_model is None:
            return None
        ahead = sum(1 for r in self._queues[bucket]
                    if r.request_id in self._live)
        return self.cost_model.queue_eta_ms(bucket, ahead,
                                            self.static_batch_for(bucket))

    @property
    def pending(self) -> int:
        return len(self._live)

    # -- lifecycle purging ------------------------------------------------
    def cancel(self, request_id: int) -> bool:
        """Remove a still-queued request; False once it left the queue.
        O(1): pops the id index — the deque entry is a tombstone compacted
        on the bucket's next batch formation / expiry sweep."""
        return self._live.pop(request_id, None) is not None

    def purge_expired(self, now: float) -> list[FoldRequest]:
        """Drop and return queued requests whose deadline passed at ``now``
        (also compacts cancellation tombstones out of every bucket queue)."""
        expired: list[FoldRequest] = []
        for bucket, q in self._queues.items():
            alive: deque[FoldRequest] = deque()
            for r in q:
                if r.request_id not in self._live:
                    continue                      # cancelled tombstone
                if r.expired(now):
                    expired.append(r)
                    del self._live[r.request_id]
                else:
                    alive.append(r)
            self._queues[bucket] = alive
        return expired

    def purge_infeasible(self, now: float) -> list[FoldRequest]:
        """Drop and return queued requests that can no longer make their
        deadline even launched solo right now — remaining budget smaller
        than the bucket's *calibrated* solo latency.  A no-op without a
        calibrated cost model: online EWMA noise must never expire work."""
        if self.cost_model is None or not self.cost_model.has_calibration():
            return []
        doomed: list[FoldRequest] = []
        for bucket, q in self._queues.items():
            solo = self.cost_model.solo_ms(bucket, calibrated_only=True)
            if solo is None:
                continue
            alive: deque[FoldRequest] = deque()
            for r in q:
                if r.request_id not in self._live:
                    continue                      # cancelled tombstone
                if (r.deadline_at is not None
                        and (r.deadline_at - now) * 1e3 < solo):
                    doomed.append(r)
                    del self._live[r.request_id]
                else:
                    alive.append(r)
            self._queues[bucket] = alive
        return doomed

    # -- batch formation --------------------------------------------------
    def static_batch_for(self, bucket: int) -> int:
        """Max launch size for this bucket (shared shape-cap rule)."""
        return static_batch_for(bucket, self.max_tokens_per_batch,
                                self.max_batch, self.admission)

    def _buckets_by_urgency(self) -> list[int]:
        """Non-empty buckets, most urgent waiting request first."""
        keyed = []
        for bucket, q in self._queues.items():
            keys = [_urgency(r) for r in q if r.request_id in self._live]
            if keys:
                keyed.append((min(keys), bucket))
        return [b for _, b in sorted(keyed)]

    def _grow_stop(self, bucket: int, n: int) -> str | None:
        """Why the batch cannot grow from n to n+1 (None = may grow)."""
        if n >= self.max_batch:
            return "max_batch"
        if (n + 1) * bucket > self.max_tokens_per_batch and n >= 1:
            return "token_budget"  # always admit at least one (ESMFold rule)
        if self.admission is not None and n >= 1:
            # a solo request over budget was vetted at submit; growth over
            # budget defers the remainder of the queue to a later batch
            if self.admission.admit(bucket, n + 1).verdict != ADMIT:
                return "admission"
        return None

    def _gap_ms(self, bucket: int) -> float | None:
        """Median inter-arrival gap for this bucket's recent submits —
        median, not mean, so one long inter-burst silence doesn't inflate
        the estimate past every in-burst gap.  None = fewer than two
        arrivals observed."""
        arr = self._arrivals[bucket]
        if len(arr) < 2:
            return None
        diffs = sorted((b - a) * 1e3 for a, b in zip(arr, list(arr)[1:]))
        return diffs[len(diffs) // 2]

    def _adaptive_hold(self, bucket: int, now: float) -> bool | None:
        """Price an underfull hold in measured ms: hold only while the
        predicted fill benefit (solo cost the next arrival would otherwise
        pay minus its marginal in-batch row cost) covers the predicted wait
        (median inter-arrival gap), and the predicted next arrival isn't
        already overdue.  None = not enough data — caller falls back to the
        fixed budget.  Reads live EWMA entries: a hold is reversible, so it
        may track drift."""
        if self.cost_model is None:
            return None
        gap = self._gap_ms(bucket)
        solo = self.cost_model.solo_ms(bucket)
        marginal = self.cost_model.marginal_row_ms(bucket)
        if gap is None or solo is None or marginal is None:
            return None
        last = self._arrivals[bucket][-1]
        if now > last + gap / 1e3:
            return False     # predicted next arrival already missed: launch
        return gap <= max(solo - marginal, 0.0)

    def next_batch(self, now: float | None = None, *,
                   allow_linger: bool = True) -> ScheduledBatch | None:
        """Form the most urgent launchable batch (None = nothing to run).

        Fill-or-timeout: with ``linger_ms`` set (and ``now`` given on the
        client clock), a batch that is underfull only because its bucket's
        queue drained — not because admission/token-budget/max-batch
        stopped its growth — is *held* while its most urgent request is
        younger than the linger budget, so same-bucket arrivals can fill
        its would-be dummy rows.  A held bucket yields to less urgent
        launchable buckets (serving other work during the linger beats
        idling); ``hold_until`` exposes the earliest release time of
        anything held this turn.  ``allow_linger=False`` bypasses holds —
        what a draining pump uses, since no future arrivals can fill a
        batch it is the last one to serve.
        """
        self.hold_until = None
        for bucket in self._buckets_by_urgency():
            q = sorted((r for r in self._queues[bucket]
                        if r.request_id in self._live), key=_urgency)
            picked: list[FoldRequest] = []
            stop = None
            while q:
                stop = self._grow_stop(bucket, len(picked))
                if stop is not None:
                    break
                picked.append(q.pop(0))
            if (allow_linger and self.linger_ms > 0 and now is not None
                    and stop is None
                    and len(picked) < self.static_batch_for(bucket)):
                # window anchored to the EARLIEST arrival in the batch:
                # a late high-priority arrival re-sorts picked[0] but must
                # never extend an older request's wait past its budget
                release = (min(r.arrival_time for r in picked)
                           + self.linger_ms / 1e3)
                hold = now < release
                decision = "fixed"
                if hold and self.adaptive_linger:
                    # inside the cap, price the hold in measured ms; None =
                    # no arrival/latency data yet, keep the fixed budget
                    verdict = self._adaptive_hold(bucket, now)
                    if verdict is not None:
                        hold, decision = verdict, "adaptive"
                if hold:
                    # hold: leave the queue untouched, try the next bucket
                    self.linger_holds += 1
                    self.linger_decisions[f"hold_{decision}"] += 1
                    held_size, pending = self._hold_state.get(
                        bucket, (len(picked), 0))
                    if len(picked) > held_size:
                        # grew since the prior holds: those holds paid off
                        held_size, pending = len(picked), 0
                    self._hold_state[bucket] = (held_size, pending + 1)
                    self.hold_until = (release if self.hold_until is None
                                       else min(self.hold_until, release))
                    if self.tracer is not None:
                        self.tracer.instant(
                            "linger_hold", process="engine",
                            thread="scheduler", bucket=bucket,
                            picked=len(picked), release=release,
                            decision=decision)
                    continue
                self.linger_decisions[f"launch_{decision}"] += 1
            # launching: holds that never attracted a fill were wasted wait
            held_size, pending = self._hold_state.pop(bucket, (0, 0))
            if pending and len(picked) <= held_size:
                self.linger_bad_holds += pending
            self._queues[bucket] = deque(q)
            for r in picked:
                # pop, not del: direct scheduler users may queue duplicate
                # ids (only FoldClient rejects them eagerly) and both deque
                # entries are picked here — serve both rather than
                # KeyError mid-batch
                self._live.pop(r.request_id, None)  # left queue: cancel False
            est = (self.admission.estimate_bytes(bucket, len(picked))
                   if self.admission is not None else 0)
            deferred = (tuple(r.request_id for r in q)
                        if stop == "admission" else ())
            label = (self.placement.label_for(bucket)
                     if self.placement is not None else "single")
            chunk = (self.chunk.chunk_for(bucket) or 0
                     if self.chunk is not None else 0)
            return ScheduledBatch(bucket, tuple(picked), est, deferred,
                                  placement=label, chunk_size=chunk)
        return None
