"""Typed progress-event stream for the request-lifecycle serving API (port
of ``repro/serving/events.py``).

Every request served through ``FoldClient`` emits an ordered sequence of
``FoldEvent``s on the client's ``EventBus``:

    SUBMITTED -> [DEFERRED ...] -> SCHEDULED -> BATCH_START -> BATCH_DONE
              -> COMPLETED
    SUBMITTED -> REJECTED | CANCELLED | EXPIRED          (terminal, no batch)

Events carry a bus-global monotonic sequence number (``seq``), the client
clock's timestamp (``t``, same ``time.monotonic`` clock as arrival times and
deadline checks), and per-event telemetry in ``data`` (bucket, batch size,
run/queue latency, admission pricing, rejection reason, ...).

Consumption is either push (``subscribe(callback)`` — invoked synchronously
at publish time, off the bus lock) or pull (``stream()`` — an iterator with
its own buffer; ``events()`` drains what is buffered without blocking,
iteration/``next_event`` block until the bus closes).  Both see every event
published after they attach.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Iterator

# -- event kinds ------------------------------------------------------------
SUBMITTED = "submitted"      # accepted into the queue (or straight to REJECTED)
DEFERRED = "deferred"        # admission stopped its batch; still queued
SCHEDULED = "scheduled"      # picked into a ScheduledBatch (handle: ADMITTED)
BATCH_START = "batch_start"  # its batch began executing (handle: RUNNING)
TOKEN = "token"              # LM decode emitted one token (repeats; carries
                             # step index + token id in ``data``)
BATCH_DONE = "batch_done"    # its batch finished (telemetry: run/compile ms)
COMPLETED = "completed"      # result available (handle: DONE)
REJECTED = "rejected"        # never servable (too long / over budget alone)
CANCELLED = "cancelled"      # handle.cancel() won before admission
EXPIRED = "expired"          # deadline passed while queued

EVENT_KINDS = (SUBMITTED, DEFERRED, SCHEDULED, BATCH_START, TOKEN,
               BATCH_DONE, COMPLETED, REJECTED, CANCELLED, EXPIRED)

# the per-request order contract tests assert: every event kind maps to a
# rank, and a request's event ranks must be non-decreasing (DEFERRED and
# TOKEN may repeat; terminal kinds share the top rank and appear at most
# once).  TOKEN shares BATCH_START's rank: tokens stream strictly between a
# decode request joining the running batch and its retirement.
EVENT_ORDER = {SUBMITTED: 0, DEFERRED: 1, SCHEDULED: 2, BATCH_START: 3,
               TOKEN: 3,
               BATCH_DONE: 4, COMPLETED: 5, REJECTED: 5, CANCELLED: 5,
               EXPIRED: 5}
TERMINAL_EVENTS = (COMPLETED, REJECTED, CANCELLED, EXPIRED)


@dataclasses.dataclass(frozen=True)
class FoldEvent:
    seq: int                   # bus-global, strictly increasing
    kind: str                  # one of EVENT_KINDS
    request_id: int
    t: float                   # client clock (time.monotonic by default)
    data: dict = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:        # compact: events show up in asserts
        extra = f" {self.data}" if self.data else ""
        return f"<{self.seq}:{self.kind} req={self.request_id}{extra}>"


class EventStream:
    """Pull-side view of an EventBus: buffers events published after attach.

    ``events()`` drains the buffer without blocking; ``next_event(timeout)``
    blocks for one event; iterating blocks until the bus is closed.
    """

    def __init__(self):
        self._buf: deque[FoldEvent] = deque()
        self._cond = threading.Condition()
        self._closed = False

    # -- bus side --
    def _push(self, ev: FoldEvent) -> None:
        with self._cond:
            if self._closed:
                # a closed stream silently eating events would make its
                # consumer's history lie; the bus detaches closed streams,
                # so reaching this is a plumbing bug — fail loudly
                raise RuntimeError("push into a closed EventStream")
            self._buf.append(ev)
            self._cond.notify_all()

    def _close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- consumer side --
    def events(self) -> list[FoldEvent]:
        """Drain everything currently buffered (non-blocking)."""
        with self._cond:
            out = list(self._buf)
            self._buf.clear()
        return out

    def next_event(self, timeout: float | None = None) -> FoldEvent | None:
        """Block for the next event; None on timeout or closed-and-empty."""
        with self._cond:
            while not self._buf and not self._closed:
                if not self._cond.wait(timeout):
                    return None
            return self._buf.popleft() if self._buf else None

    def __iter__(self) -> Iterator[FoldEvent]:
        while True:
            ev = self.next_event()
            if ev is None:
                return
            yield ev


class EventBus:
    """Fan-out publisher.  ``emit`` assigns the sequence number and delivers
    to streams atomically (call it while holding whatever lock defines your
    event order — seq order is then exactly that order); callbacks are
    queued and run later via ``dispatch()``, outside any caller lock, in
    seq order (a dispatch lock serializes drains across threads).

    Close semantics: ``close()`` terminates and detaches every attached
    stream (their buffered events stay drainable) and marks the bus closed
    — a subsequent ``emit`` raises instead of silently dropping the event.
    ``reopen()`` re-arms a closed bus (what ``FoldClient.start()`` does
    after a ``stop()``): the sequence counter continues, previously closed
    streams stay closed, new subscribers/streams see everything emitted
    after they attach."""

    def __init__(self, clock: Callable[[], float] | None = None):
        import time
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._dispatch_lock = threading.Lock()
        self._seq = 0
        self._closed = False
        self._callbacks: list[Callable[[FoldEvent], None]] = []
        self._streams: list[EventStream] = []
        self._cb_queue: deque[FoldEvent] = deque()
        self.callback_errors: list[Exception] = []

    @property
    def closed(self) -> bool:
        return self._closed

    def subscribe(self, callback: Callable[[FoldEvent], None]) -> Callable[[], None]:
        with self._lock:
            self._callbacks.append(callback)

        def unsubscribe() -> None:
            with self._lock:
                if callback in self._callbacks:
                    self._callbacks.remove(callback)
        return unsubscribe

    def stream(self) -> EventStream:
        s = EventStream()
        with self._lock:
            self._streams.append(s)
        return s

    def emit(self, kind: str, request_id: int, **data) -> FoldEvent:
        """Sequence + deliver to streams now; queue callbacks for
        ``dispatch()``.  Safe to call under an external ordering lock."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    f"emit({kind!r}, request {request_id}) on a closed "
                    f"EventBus — the publisher was stopped; reopen() "
                    f"(FoldClient.start()) re-arms it")
            self._seq += 1
            ev = FoldEvent(self._seq, kind, request_id, self._clock(), data)
            sinks = list(self._streams)
            self._cb_queue.append(ev)
        for s in sinks:
            s._push(ev)
        return ev

    def dispatch(self) -> None:
        """Drain queued callback invocations, in seq order.  Call OFF any
        external lock — subscriber callbacks may call back into the
        publisher's owner."""
        with self._dispatch_lock:     # one drainer at a time keeps order
            while True:
                with self._lock:
                    if not self._cb_queue:
                        return
                    ev = self._cb_queue.popleft()
                    cbs = list(self._callbacks)
                for cb in cbs:   # a broken subscriber must not kill the pump
                    try:
                        cb(ev)
                    except Exception as e:    # pragma: no cover - defensive
                        self.callback_errors.append(e)

    def publish(self, kind: str, request_id: int, **data) -> FoldEvent:
        """emit + immediate dispatch (for callers holding no locks)."""
        ev = self.emit(kind, request_id, **data)
        self.dispatch()
        return ev

    def close(self) -> None:
        """Idempotent: drain callbacks, terminate + detach every stream,
        mark the bus closed (emit-after-close raises)."""
        self.dispatch()
        with self._lock:
            self._closed = True
            sinks = list(self._streams)
            self._streams.clear()    # a reopened bus must never push into
        for s in sinks:              # these terminated streams
            s._close()

    def reopen(self) -> None:
        """Re-arm a closed bus (no-op when open).  Streams closed by the
        prior ``close()`` stay closed; attach new ones after reopening."""
        with self._lock:
            self._closed = False


def check_request_order(events: list[FoldEvent]) -> None:
    """Assert one request's event list obeys the lifecycle order contract.

    Raises AssertionError naming the offending pair; used by tests and
    available to callers auditing a stream.
    """
    ranks = [EVENT_ORDER[e.kind] for e in events]
    for a, b, ra, rb in zip(events, events[1:], ranks, ranks[1:]):
        assert ra <= rb, f"out-of-order events: {a} before {b}"
    seqs = [e.seq for e in events]
    assert seqs == sorted(seqs), f"non-monotonic seq numbers: {events}"
    terminal = [e for e in events if e.kind in TERMINAL_EVENTS]
    assert len(terminal) <= 1, f"multiple terminal events: {terminal}"
    if terminal:
        assert events[-1] is terminal[0], \
            f"terminal event not last: {events}"
