"""FoldClient: the request-lifecycle serving API over the EngineCore
(port of ``repro/serving/client.py``).

``submit()`` returns a ``FoldHandle`` immediately; the engine core only
runs when the pump loop turns — either inline (``drive()`` — deterministic,
threadless, what tests and the legacy ``FoldEngine`` wrapper use) or on the
background driver thread (``start()``/``stop()`` — what a server uses so
``submit``/``result`` are fully async).

The pump is PIPELINED: each ``drive`` turn first fills the core's bounded
in-flight ring (``inflight_depth``) with freshly formed batches —
``core.dispatch`` pads, device-puts, and launches without blocking — and
then retires the oldest in-flight batch (``core.retire``).  While batch *k*
computes on device, batch *k+1* is padded/launched and batch *k-1*'s
results are stripped and delivered.  Event order stays legal per request
(``check_request_order``): a later batch's BATCH_START may interleave
between an earlier batch's BATCH_START and BATCH_DONE, which the per-
request contract permits.  Results are bitwise-identical to a depth-1
synchronous pump — the ring changes overlap, never inputs or executables.

Fill-or-timeout: with ``linger_ms`` set, the scheduler may *hold* an
underfull batch briefly so same-bucket arrivals fill its would-be dummy
rows.  A draining pump (``drive()`` with no ``max_batches`` bound — the
legacy ``run()``/``drain()``/``stop()`` paths) bypasses holds: it is the
last pumper, so no arrivals can come.  The background driver honors holds
and re-polls, so lingering only ever happens where filling is possible.

Handle lifecycle (the only legal transitions)::

    QUEUED ──► ADMITTED ──► RUNNING ──► DONE
      │ ╲
      │  ╲──► CANCELLED          (handle.cancel() before admission)
      ├─────► EXPIRED            (deadline passed while queued)
    [REJECTED]                   (terminal at submit: too long, or the
                                  bucket busts the memory budget alone)

Admission verdicts surface as lifecycle state, not strings: REJECT becomes
a ``REJECTED`` handle (+ terminal FoldResult), DEFER keeps the handle
``QUEUED`` and emits a ``DEFERRED`` event carrying the pricing telemetry.

Every transition emits a typed ``FoldEvent`` on the client's ``EventBus``
(see repro_torch.serving.events) — consume via ``subscribe(callback)`` or the
buffering ``stream()`` iterator.

Clock: one monotonic clock (injectable ``clock=``, default
``time.monotonic``) stamps arrivals, deadlines, batch starts, and event
timestamps.  Tests inject a manual clock to script deadline expiry.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Iterable

import numpy as np

from repro_torch.serving import events as ev
from repro_torch.serving.engine import BatchExecutionError, EngineCore
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.observability.tracing import PROC_REQUESTS
from repro_torch.serving.scheduler import ScheduledBatch, TokenBudgetScheduler
from repro_torch.serving.types import (CANCELLED as R_CANCELLED, EXPIRED as
                                 R_EXPIRED, FAILED as R_FAILED,
                                 REJECTED as R_REJECTED, FoldRequest,
                                 FoldResult)

# -- handle states ----------------------------------------------------------
QUEUED = "QUEUED"        # accepted into the scheduler queue
ADMITTED = "ADMITTED"    # picked into a ScheduledBatch under the budget
RUNNING = "RUNNING"      # its batch is executing on the core
DONE = "DONE"            # result available
REJECTED = "REJECTED"    # never servable (terminal at submit)
CANCELLED = "CANCELLED"  # cancel() won while still queued
EXPIRED = "EXPIRED"      # deadline passed while still queued

HANDLE_STATES = (QUEUED, ADMITTED, RUNNING, DONE, REJECTED, CANCELLED,
                 EXPIRED)
TERMINAL_STATES = frozenset({DONE, REJECTED, CANCELLED, EXPIRED})

#: the full legal-transition relation — FoldHandle enforces it, tests
#: assert recorded trajectories against it
LEGAL_TRANSITIONS: dict[str, frozenset[str]] = {
    QUEUED: frozenset({ADMITTED, CANCELLED, EXPIRED}),
    ADMITTED: frozenset({RUNNING}),
    RUNNING: frozenset({DONE}),
    DONE: frozenset(),
    REJECTED: frozenset(),
    CANCELLED: frozenset(),
    EXPIRED: frozenset(),
}


class FoldHandle:
    """Future-like view of one submitted request.

    Thread-safe; created by ``FoldClient.submit`` only.  ``transitions``
    records every (state, t) the handle passed through, in order — the
    auditable trajectory the lifecycle tests check against
    ``LEGAL_TRANSITIONS``.
    """

    def __init__(self, client: "FoldClient", request: FoldRequest,
                 initial: str, t: float):
        self._client = client
        self._request = request
        self._status = initial
        self._result: FoldResult | None = None
        self.transitions: list[tuple[str, float]] = [(initial, t)]
        #: this request's trace spans by name ("request" root + lifecycle
        #: children) — populated by the client as the handle advances
        self.spans: dict[str, object] = {}

    def span_tree(self) -> list[dict]:
        """This request's spans nested as ``{span, children}`` trees."""
        from repro_torch.serving.observability.tracing import span_tree
        return span_tree([s for s in self.spans.values() if s is not None])

    # -- identity / scheduling attrs --
    @property
    def request_id(self) -> int:
        return self._request.request_id

    @property
    def length(self) -> int:
        return self._request.length

    @property
    def priority(self) -> int:
        return self._request.priority

    @property
    def deadline_s(self) -> float | None:
        return self._request.deadline_s

    # -- state --
    @property
    def status(self) -> str:
        with self._client._lock:
            return self._status

    @property
    def done(self) -> bool:
        return self.status in TERMINAL_STATES

    def _advance(self, new: str, t: float) -> None:
        """Transition under the client lock; raises on an illegal edge."""
        if new not in LEGAL_TRANSITIONS[self._status]:
            raise RuntimeError(
                f"illegal handle transition {self._status} -> {new} "
                f"(request {self.request_id})")
        self._status = new
        self.transitions.append((new, t))

    # -- consumption --
    def cancel(self) -> bool:
        """Cancel if still queued.  True iff this call removed the request
        — a cancelled request never occupies a batch slot.  False once the
        request was admitted into a batch or reached any terminal state."""
        return self._client._cancel(self)

    def result(self, timeout: float | None = None) -> FoldResult:
        """Block until terminal; returns the FoldResult (whose ``status``
        distinguishes ok/rejected/cancelled/expired).  With no background
        driver running, pumps the client inline on the calling thread.
        Raises TimeoutError if ``timeout`` elapses first."""
        return self._client._wait(self, timeout)

    def __repr__(self) -> str:
        return (f"FoldHandle(id={self.request_id}, len={self.length}, "
                f"prio={self.priority}, status={self.status})")


class FoldClient:
    def __init__(self, params, cfg, scheme=None, *,
                 buckets: tuple[int, ...] | None = None,
                 max_tokens_per_batch: int = 1024, max_batch: int = 8,
                 mem_budget_mb: float | None = None, fidelity: bool = False,
                 kernels: str | None = None, keep_distogram: bool = True,
                 mesh=None, shard_threshold: int | None = None,
                 chunk_size: int | str | None = None,
                 inflight_depth: int = 2, linger_ms: float = 0.0,
                 adaptive_linger: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 core: EngineCore | None = None,
                 cost_model=None, device=None):
        if core is None:
            from repro_torch.kernels import dispatch
            # device None = the card (raises without one); "cpu" on request
            core = EngineCore(
                params, cfg, scheme, buckets=buckets,
                max_tokens_per_batch=max_tokens_per_batch,
                max_batch=max_batch, mem_budget_mb=mem_budget_mb,
                fidelity=fidelity,
                kernels=dispatch.AUTO if kernels is None else kernels,
                keep_distogram=keep_distogram, mesh=mesh,
                shard_threshold=shard_threshold, chunk_size=chunk_size,
                inflight_depth=inflight_depth, clock=clock,
                cost_model=cost_model, device=device)
        self.core = core
        self.clock = core.clock
        # the scheduler prices feasibility/linger against the CORE's cost
        # model — the same table the engine's launch sizing reads and every
        # retire() refines
        self.scheduler = TokenBudgetScheduler(
            core.buckets, max_tokens_per_batch=core.max_tokens_per_batch,
            max_batch=core.max_batch, admission=core.admission,
            placement=core.placement, chunk=core.chunk, linger_ms=linger_ms,
            cost_model=core.cost_model, adaptive_linger=adaptive_linger)
        # the pump's own FIFO mirror of dispatched-not-retired batches: the
        # client terminates handles from THIS deque, so a retire failure
        # (or a monkeypatched core) can never desync results from handles
        self._inflight_batches: deque[ScheduledBatch] = deque()
        self.events = ev.EventBus(clock=self.clock)
        # live (non-terminal) requests only: handles unindex on reaching a
        # terminal state so a long-running server's memory is bounded by
        # queue depth, not total requests served (callers keep their own
        # handle references; results ride on the handle, not this dict)
        self.handles: dict[int, FoldHandle] = {}
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._next_id = 0
        self._driver: threading.Thread | None = None
        self._stop = False
        # bounded: a wedged driver hitting the same bug every turn must not
        # grow this without limit; evictions are themselves counted (both
        # here and as a metrics series)
        self.driver_errors: deque[Exception] = deque(maxlen=32)
        self.driver_errors_dropped = 0
        # one tracer for the whole stack: the core created it (or was given
        # one); request-lifecycle spans land in the same trace as the
        # engine's batch spans, on the same clock
        self.tracer = self.core.tracer
        self.scheduler.tracer = self.tracer

    # -- metrics passthrough ----------------------------------------------
    @property
    def metrics(self) -> EngineMetrics:
        return self.core.metrics

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def metrics_text(self) -> str:
        """The live metrics registry in Prometheus text exposition format
        (what ``MetricsServer`` serves at ``/metrics``)."""
        return self.core.metrics.registry.prometheus_text()

    def metrics_json(self) -> dict:
        """The live metrics registry as JSON-ready structures."""
        return self.core.metrics.registry.as_dict()

    def save_trace(self, path: str) -> None:
        """Export the span trace as Chrome-trace/Perfetto JSON."""
        self.tracer.save(path)

    def _record_driver_error(self, e: Exception) -> None:
        dropped = len(self.driver_errors) == self.driver_errors.maxlen
        if dropped:
            self.driver_errors_dropped += 1
        self.driver_errors.append(e)
        self.core.metrics.record_driver_error(dropped)

    def warmup(self) -> None:
        self.core.warmup()

    def subscribe(self, callback) -> Callable[[], None]:
        return self.events.subscribe(callback)

    def stream(self) -> ev.EventStream:
        return self.events.stream()

    # -- intake -----------------------------------------------------------
    def submit(self, seq: np.ndarray | FoldRequest, *, priority: int = 0,
               deadline_s: float | None = None) -> FoldHandle:
        """Queue a sequence; returns its handle immediately (status QUEUED,
        or REJECTED if it can never be served).  Pass scheduling attributes
        either on a FoldRequest or via the kwargs, not both."""
        if isinstance(seq, FoldRequest) and (priority != 0
                                             or deadline_s is not None):
            raise ValueError("priority/deadline_s kwargs conflict with an "
                             "explicit FoldRequest — set them on the request")
        with self._lock:
            if self.events.closed:
                # stop() closed the bus; silently dropping this request's
                # events would make the stream lie — fail loudly instead
                raise RuntimeError(
                    "FoldClient is stopped (EventBus closed); call start() "
                    "to re-arm it before submitting")
            if isinstance(seq, FoldRequest):
                req = seq
                if req.request_id in self.handles:
                    raise ValueError(f"request_id {req.request_id} is "
                                     f"already live on this client")
            else:
                req = FoldRequest(self._next_id, np.asarray(seq, np.int32),
                                  priority=priority, deadline_s=deadline_s)
            self._next_id = max(self._next_id, req.request_id) + 1
            now = self.clock()
            track = f"req-{req.request_id}"
            root = self.tracer.begin("request", process=PROC_REQUESTS,
                                     thread=track, t=now,
                                     request_id=req.request_id,
                                     length=req.length,
                                     priority=req.priority)
            adm = self.tracer.begin("admission", process=PROC_REQUESTS,
                                    thread=track, parent=root, t=now)
            rej = self.scheduler.submit(req, now)
            self.tracer.end(adm, verdict=rej.verdict if rej is not None
                            else "accept")
            meta = {"length": req.length, "priority": req.priority,
                    "deadline_s": req.deadline_s}
            # events are sequenced + stream-delivered HERE, under the lock
            # (so a racing driver thread cannot sequence SCHEDULED ahead of
            # SUBMITTED); subscriber callbacks run in dispatch(), off-lock
            if rej is not None:
                handle = FoldHandle(self, req, REJECTED, now)
                handle.spans = {"request": root, "admission": adm}
                self.tracer.end(root, status="rejected", reason=rej.reason)
                handle._result = FoldResult(
                    request_id=req.request_id, length=req.length,
                    status=R_REJECTED, reason=rej.reason,
                    priority=req.priority,
                    bucket=self.core.bucket_for(req.length) or 0)
                self.core.metrics.record(handle._result)
                if rej.verdict == "infeasible":
                    self.core.metrics.record_infeasible("submit")
                self.events.emit(ev.SUBMITTED, req.request_id, **meta)
                self.events.emit(ev.REJECTED, req.request_id,
                                 reason=rej.reason, verdict=rej.verdict,
                                 **meta)
            else:
                handle = FoldHandle(self, req, QUEUED, now)
                handle.spans = {
                    "request": root, "admission": adm,
                    "queued": self.tracer.begin(
                        "queued", process=PROC_REQUESTS, thread=track,
                        parent=root)}
                self.handles[req.request_id] = handle   # live-handle index
                self.events.emit(ev.SUBMITTED, req.request_id, **meta)
            self.core.metrics.record_queue_depth(self.scheduler.pending)
            self._cond.notify_all()          # wake the background driver
        self.events.dispatch()               # callbacks run OFF the lock
        return handle

    # -- lifecycle: cancellation / expiry ---------------------------------
    def _cancel(self, handle: FoldHandle) -> bool:
        with self._lock:
            if handle._status != QUEUED:
                return False
            removed = self.scheduler.cancel(handle.request_id)
            if not removed:       # already popped into a forming batch
                return False
            now = self.clock()
            handle._request.cancelled = True
            handle._advance(CANCELLED, now)
            self._end_request_spans(handle, "cancelled", now)
            handle._result = FoldResult(
                request_id=handle.request_id, length=handle.length,
                status=R_CANCELLED, reason="cancelled by client",
                priority=handle.priority,
                bucket=self.core.bucket_for(handle.length) or 0,
                queue_wait_ms=(now - handle._request.arrival_time) * 1e3)
            self.core.metrics.record(handle._result)
            self.handles.pop(handle.request_id, None)   # terminal: unindex
            self.events.emit(ev.CANCELLED, handle.request_id,
                             queued_ms=(now - handle._request.arrival_time)
                             * 1e3)
            self.core.metrics.record_queue_depth(self.scheduler.pending)
            self._cond.notify_all()
        self.events.dispatch()
        return True

    def _expire_due(self, now: float) -> list[FoldResult]:
        """Purge deadline-passed queued requests (caller holds the lock and
        dispatches the emitted events once it releases it)."""
        out = []
        for req in self.scheduler.purge_expired(now):
            handle = self.handles.pop(req.request_id)
            handle._advance(EXPIRED, now)
            self._end_request_spans(handle, "expired", now)
            handle._result = FoldResult(
                request_id=req.request_id, length=req.length,
                status=R_EXPIRED, priority=req.priority,
                reason=f"deadline {req.deadline_s:.3f}s passed in queue",
                bucket=self.core.bucket_for(req.length) or 0,
                queue_wait_ms=(now - req.arrival_time) * 1e3)
            self.core.metrics.record(handle._result)
            self.events.emit(ev.EXPIRED, req.request_id,
                             deadline_s=req.deadline_s,
                             queued_ms=(now - req.arrival_time) * 1e3)
            out.append(handle._result)
        # infeasible sweep: the deadline hasn't passed yet, but the
        # bucket's CALIBRATED solo latency no longer fits inside it —
        # terminate now (verdict "infeasible") instead of queueing to die
        for req in self.scheduler.purge_infeasible(now):
            handle = self.handles.pop(req.request_id)
            handle._advance(EXPIRED, now)
            self._end_request_spans(handle, "infeasible", now)
            remaining_ms = (req.deadline_at - now) * 1e3
            handle._result = FoldResult(
                request_id=req.request_id, length=req.length,
                status=R_EXPIRED, priority=req.priority,
                reason=(f"deadline infeasible: {remaining_ms:.1f}ms remain "
                        f"but the bucket's measured solo latency exceeds "
                        f"it"),
                bucket=self.core.bucket_for(req.length) or 0,
                queue_wait_ms=(now - req.arrival_time) * 1e3)
            self.core.metrics.record(handle._result)
            self.core.metrics.record_infeasible("queue")
            self.events.emit(ev.EXPIRED, req.request_id,
                             deadline_s=req.deadline_s,
                             verdict="infeasible",
                             queued_ms=(now - req.arrival_time) * 1e3)
            out.append(handle._result)
        if out:
            self.core.metrics.record_queue_depth(self.scheduler.pending)
            self._cond.notify_all()
        return out

    def _end_request_spans(self, handle: FoldHandle, status: str,
                           t: float) -> None:
        """Close a handle's open lifecycle spans (terminal paths must never
        leave a span dangling — an exported trace would show a cancelled
        request still 'queued' at the horizon)."""
        for name in ("queued", "running"):
            s = handle.spans.get(name)
            if s is not None:
                self.tracer.end(s, t=t)
        root = handle.spans.get("request")
        if root is not None:
            self.tracer.end(root, t=t, status=status)

    # -- the pump ---------------------------------------------------------
    def _expire_now(self) -> list[FoldResult]:
        """Deadline sweep without batch formation — keeps expiry timely
        while the in-flight ring is full."""
        try:
            with self._lock:
                return self._expire_due(self.clock())
        finally:
            self.events.dispatch()

    def _form_batch(self, *, allow_linger: bool = True,
                    ) -> tuple[ScheduledBatch | None, list[FoldResult]]:
        """One scheduling turn: expire, pick, mark RUNNING.  Events are
        sequenced under the lock (order = lifecycle order), callbacks
        dispatched after it releases."""
        try:
            with self._lock:
                now = self.clock()
                expired = self._expire_due(now)
                batch = self.scheduler.next_batch(now,
                                                  allow_linger=allow_linger)
                self.core.metrics.record_linger(self.scheduler.linger_holds,
                                                self.scheduler.linger_ms)
                self.core.metrics.record_linger_decisions(
                    dict(self.scheduler.linger_decisions),
                    self.scheduler.linger_bad_holds)
                if batch is None or not batch.requests:
                    return None, expired
                if batch.deferred:
                    d = self.core.admission.admit(batch.bucket,
                                                  batch.batch_size + 1)
                    for rid in batch.deferred:
                        self.events.emit(ev.DEFERRED, rid,
                                         bucket=batch.bucket,
                                         **d.event_data())
                ids = tuple(r.request_id for r in batch.requests)
                for req in batch.requests:
                    h = self.handles[req.request_id]
                    h._advance(ADMITTED, now)
                    q = h.spans.get("queued")
                    if q is not None:          # queue wait ends at admission
                        self.tracer.end(q, t=now)
                    self.events.emit(ev.SCHEDULED, req.request_id,
                                     bucket=batch.bucket,
                                     batch_size=batch.batch_size,
                                     est_mb=batch.est_bytes / 1e6,
                                     placement=batch.placement,
                                     chunk_size=batch.chunk_size)
                t_start = self.clock()
                for req in batch.requests:
                    h = self.handles[req.request_id]
                    h._advance(RUNNING, t_start)
                    h.spans["running"] = self.tracer.begin(
                        "running", process=PROC_REQUESTS,
                        thread=f"req-{req.request_id}",
                        parent=h.spans.get("request"), t=t_start,
                        bucket=batch.bucket, batch_size=batch.batch_size,
                        placement=batch.placement,
                        chunk_size=batch.chunk_size)
                    self.events.emit(ev.BATCH_START, req.request_id,
                                     bucket=batch.bucket, batch=ids)
                self.core.metrics.record_queue_depth(self.scheduler.pending)
                return batch, expired
        finally:
            self.events.dispatch()

    def _finish_batch(self, batch: ScheduledBatch,
                      results: list[FoldResult]) -> None:
        with self._lock:
            now = self.clock()
            for res in results:
                handle = self.handles.pop(res.request_id)  # terminal: unindex
                self.events.emit(ev.BATCH_DONE, res.request_id,
                                 bucket=batch.bucket, run_ms=res.run_ms,
                                 compile_ms=res.compile_ms,
                                 error=res.reason or None)
                handle._result = res
                handle._advance(DONE, now)
                self._end_request_spans(handle, res.status, now)
                self.events.emit(ev.COMPLETED, res.request_id,
                                 queue_wait_ms=res.queue_wait_ms,
                                 run_ms=res.run_ms, tm_vs_fp=res.tm_vs_fp,
                                 status=res.status,
                                 kernel_backend=res.kernel_backend)
            self._cond.notify_all()
        self.events.dispatch()

    def _failed_results(self, batch: ScheduledBatch,
                        e: BaseException) -> list[FoldResult]:
        """A failed batch must still terminate its handles — RUNNING
        forever would hang every result() waiter."""
        results = [FoldResult(
            request_id=r.request_id, length=r.length,
            status=R_FAILED, priority=r.priority,
            reason=f"batch execution failed: {e!r}",
            bucket=batch.bucket, batch_size=len(batch.requests),
            placement=batch.placement, chunk_size=batch.chunk_size)
            for r in batch.requests]
        for res in results:
            self.core.metrics.record(res)
        return results

    def _dispatch_batch(self, batch: ScheduledBatch) -> list[FoldResult]:
        """Launch a batch onto the in-flight ring.  Returns [] on success;
        on a dispatch failure (capture/launch error) the batch's handles
        terminate FAILED and their results are returned."""
        try:
            flight = self.core.dispatch(batch)
        except Exception as e:
            results = self._failed_results(batch, e)
            self._finish_batch(batch, results)
            return results
        # stamp the engine-side batch identity onto each request's running
        # span so a trace viewer can jump request -> batch track (guarded:
        # tests monkeypatch core.dispatch with stubs returning None)
        seq = getattr(flight, "seq", None)
        if seq is not None:
            with self._lock:
                for req in batch.requests:
                    h = self.handles.get(req.request_id)
                    r = None if h is None else h.spans.get("running")
                    if r is not None:
                        r.attrs["batch_seq"] = seq
                        r.attrs["launch_batch"] = flight.launched_b
        self._inflight_batches.append(batch)
        return []

    def _retire_oldest(self) -> list[FoldResult]:
        """Block on the oldest in-flight batch and deliver its results
        (FAILED ones included — an execution error terminates the batch's
        handles, never strands them)."""
        if not self._inflight_batches:
            return []
        batch = self._inflight_batches.popleft()
        try:
            results = self.core.retire()
        except BatchExecutionError as e:
            results = self._failed_results(e.batch, e.cause)
            batch = e.batch
        except Exception as e:      # a core that died before popping its
            results = self._failed_results(batch, e)   # ring entry: fail
        self._finish_batch(batch, results)             # OUR oldest batch
        return results

    def drive(self, max_batches: int | None = None) -> list[FoldResult]:
        """Inline pump: serve batches until the queue AND the in-flight
        ring are empty (or until ``max_batches`` batches have retired).
        Each turn fills the ring — dispatching up to ``inflight_depth``
        batches without blocking — then retires the oldest.  Returns every
        result that became terminal during the call (served + failed +
        expired), in completion order.

        An UNBOUNDED drive is a drain (the legacy ``run``/``drain``/
        ``stop`` surfaces): it bypasses scheduler linger holds, because no
        future arrivals can fill an underfull batch it is the last one to
        serve.  A bounded drive (the background driver's ``max_batches=1``
        turns) honors holds and simply returns; the driver re-polls after
        the hold releases."""
        draining = max_batches is None
        out: list[FoldResult] = []
        n = 0
        while max_batches is None or n < max_batches:
            while not self.core.inflight_full:
                batch, expired = self._form_batch(allow_linger=not draining)
                out.extend(expired)
                if batch is None:
                    break
                out.extend(self._dispatch_batch(batch))
            else:
                # ring full: still sweep deadlines so expiry can't slip by
                # a whole batch worth of compute
                out.extend(self._expire_now())
            if not self._inflight_batches:
                break           # idle, or everything is lingering
            out.extend(self._retire_oldest())
            n += 1
        return out

    def run(self, seqs: Iterable[np.ndarray], *,
            reset_metrics: bool = True) -> list[FoldResult]:
        """Submit a trace, drain it, return results in request order
        (the legacy ``FoldEngine.run`` contract)."""
        if reset_metrics:
            self.core.metrics = EngineMetrics()
        t0 = time.perf_counter()
        for s in seqs:
            self.submit(s)
        self.drive()
        self.core.metrics.wall_s = time.perf_counter() - t0
        return sorted(self.core.metrics.results, key=lambda r: r.request_id)

    # -- background driver -------------------------------------------------
    def start(self) -> None:
        """Start the background driver thread (idempotent).  Re-arms the
        EventBus if a prior ``stop()`` closed it — streams attached before
        the close stay terminated; attach new ones after ``start()``."""
        with self._lock:
            if self._driver is not None and self._driver.is_alive():
                return
            self.events.reopen()
            self._stop = False
            self._driver = threading.Thread(
                target=self._driver_loop, name="fold-client-driver",
                daemon=True)
            self._driver.start()

    def stop(self, *, drain: bool = True) -> None:
        """Stop the driver; with ``drain`` (default) pump the queue dry
        inline first so no accepted request is abandoned.  Blocks until the
        driver thread exits — it may be mid-capture, so this can take a
        while; a timed join would risk two threads pumping the core.
        Closes the EventBus: further ``submit()``s raise until ``start()``
        re-arms it.  Wall time spent draining accrues to the metrics, so a
        server-mode summary's requests_per_s/tokens_per_s stay truthful."""
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
        self.events.dispatch()       # pending callbacks run off the lock
        with self._lock:
            # under the client lock: submit() checks closed and emits under
            # the same lock, so it either completes fully before the close
            # or sees the closed bus and raises cleanly — never half-queues
            self.events.close()

    def close(self) -> None:
        """Stop (serving what was accepted) and release the engine's device
        memory (``EngineCore.close``); the client serves nothing after."""
        self.stop(drain=True)
        self.core.close()

    @property
    def driving(self) -> bool:
        d = self._driver
        return d is not None and d.is_alive()

    def _driver_loop(self) -> None:
        # Serving wall time accrues HERE, continuously — a server that is
        # never stopped through run() (which assigns wall_s itself) must
        # still report nonzero requests_per_s/tokens_per_s.  Idle waits
        # count too: a mostly-idle server honestly reports low throughput.
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
                made_progress = bool(self.drive(max_batches=1))
            except Exception as e:    # keep the driver alive: a scheduling
                # bug must not strand the queue (execution failures are
                # already converted to FAILED results inside drive)
                self._record_driver_error(e)
                made_progress = False
            accrue()
            if made_progress:
                continue
            with self._lock:
                if self._stop:
                    accrue()
                    return
                # Idle.  An empty queue can only change via submit/cancel/
                # stop — all of which notify — so a long bounded wait is
                # enough (the bound is a missed-notify backstop).  A
                # non-empty queue means the next pump turn will make
                # progress (a batch forms or expiry purges), so only a
                # short nap to yield the lock.
                self._cond.wait(0.5 if self.scheduler.pending == 0
                                else 0.01)
            accrue()

    # -- result waiting ----------------------------------------------------
    def _wait(self, handle: FoldHandle, timeout: float | None) -> FoldResult:
        if self.driving:
            deadline = None if timeout is None else time.monotonic() + timeout
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
        # threadless mode: pump inline on the caller's thread
        t0 = time.monotonic()
        while handle.status not in TERMINAL_STATES:
            progressed = bool(self.drive(max_batches=1))
            if handle.status in TERMINAL_STATES:
                break
            if not progressed and not self.scheduler.pending:
                raise RuntimeError(
                    f"request {handle.request_id} is {handle.status} but the "
                    f"queue is empty and no driver is running")
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"request {handle.request_id} still {handle.status} "
                    f"after {timeout}s")
        return handle._result
