"""Zero-dependency span tracing for the serving stack.

A ``Tracer`` records ``Span``s — named intervals on (process, thread)
tracks, timestamped by ONE injectable monotonic clock (the same clock the
client stamps arrivals/deadlines with, so spans and lifecycle telemetry
can never disagree about when something happened).  Spans form trees via
``parent`` links; the client hangs a per-request tree off every
``FoldHandle`` (submit → admission → queued → running → terminal) and the
engine core records per-batch trees (dispatch[resolve/pad/device_put/
launch] → in_flight → retire[block/transfer]) on one track per batch —
which is what makes the pipelined in-flight ring's overlap *visible*:
batch k+1's dispatch span starting before batch k's retire span ends IS
the pipelining story, as a queryable artifact.

``chrome_trace()`` exports the span set as Chrome-trace/Perfetto JSON
(B/E duration events plus M metadata naming the tracks) — load the file
at https://ui.perfetto.dev or chrome://tracing.  ``validate_chrome_trace``
checks the invariants consumers rely on (monotone timestamps, per-track
matched B/E pairs); ``pipeline_overlaps`` counts dispatch/retire overlap
between consecutive batches — the programmatic form of "the ring really
pipelines" that the bench and CI gate on.

The tracer is bounded (``max_spans``): a long-running server drops new
spans past the cap instead of growing without bound, and reports how many
it dropped (``dropped``).
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, IO, Iterator

#: canonical track (process) names used across the serving stack
PROC_REQUESTS = "requests"
PROC_ENGINE = "engine"


@dataclasses.dataclass
class Span:
    """One named interval on a (process, thread) track.

    ``attrs`` is mutable until export: callers may annotate a span after
    beginning it (e.g. the client stamps the batch seq onto a request's
    ``running`` span once the core assigns it).
    """
    span_id: int
    parent_id: int | None
    name: str
    process: str
    thread: str
    t_start: float
    t_end: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.t_end is None

    @property
    def duration(self) -> float | None:
        return None if self.t_end is None else self.t_end - self.t_start

    def __repr__(self) -> str:
        state = "open" if self.open else f"{self.duration * 1e3:.2f}ms"
        return (f"<span {self.span_id} {self.process}/{self.thread} "
                f"{self.name} [{state}]>")


class _SpanScope:
    """Context manager yielded by ``Tracer.span`` — ends on exit, stamping
    an ``error`` attr when the body raised."""

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        attrs = {} if exc is None else {"error": repr(exc)}
        self._tracer.end(self.span, **attrs)


class Tracer:
    """Thread-safe bounded span recorder with an injectable clock."""

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 max_spans: int = 250_000):
        self.clock = clock
        self.max_spans = max_spans
        self.spans: list[Span] = []
        self.dropped = 0           # spans not recorded because of the cap
        self.metadata: dict[str, Any] = {}   # exported at the trace root
        self._lock = threading.Lock()
        self._next_id = 1

    # -- recording --------------------------------------------------------
    def begin(self, name: str, *, process: str, thread: str,
              parent: Span | None = None, t: float | None = None,
              **attrs) -> Span:
        """Open a span now (or at ``t`` on the tracer clock).  Past the
        ``max_spans`` cap the span is still returned (so callers need no
        None-guards) but not retained."""
        t = self.clock() if t is None else t
        with self._lock:
            span = Span(self._next_id,
                        None if parent is None else parent.span_id,
                        name, process, thread, t, attrs=dict(attrs))
            self._next_id += 1
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
            else:
                self.spans.append(span)
        return span

    def end(self, span: Span, *, t: float | None = None, **attrs) -> None:
        """Close a span (idempotent: the first close wins — terminal paths
        may race a failure path to the close; attrs still merge)."""
        t = self.clock() if t is None else t
        with self._lock:
            if span.t_end is None:
                span.t_end = max(t, span.t_start)
            span.attrs.update(attrs)

    def span(self, name: str, *, process: str, thread: str,
             parent: Span | None = None, **attrs) -> _SpanScope:
        """``with tracer.span(...)`` — begins now, ends on exit."""
        return _SpanScope(self, self.begin(name, process=process,
                                           thread=thread, parent=parent,
                                           **attrs))

    def instant(self, name: str, *, process: str, thread: str,
                **attrs) -> Span:
        """A zero-duration marker (linger holds, epoch resets, ...)."""
        s = self.begin(name, process=process, thread=thread, **attrs)
        self.end(s, t=s.t_start)
        return s

    def set_metadata(self, **kw) -> None:
        """Attach run-level metadata exported at the trace JSON root."""
        with self._lock:
            self.metadata.update(kw)

    def reset(self) -> None:
        with self._lock:
            self.spans = []
            self.dropped = 0

    # -- queries ----------------------------------------------------------
    def find(self, name: str | None = None, *, process: str | None = None,
             thread: str | None = None) -> list[Span]:
        with self._lock:
            spans = list(self.spans)
        return [s for s in spans
                if (name is None or s.name == name)
                and (process is None or s.process == process)
                and (thread is None or s.thread == thread)]

    # -- export -----------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON: M metadata events naming every
        track, then matched B/E pairs per span, globally sorted by ts.

        Spans still open at export time are closed at the latest observed
        timestamp and stamped ``truncated`` — every B gets its E.  Child
        intervals are clamped into their parent (and siblings serialized)
        so the per-track event stream always nests, whatever the recorded
        floats did at µs granularity.
        """
        with self._lock:
            spans = list(self.spans)
            metadata = dict(self.metadata)
        if not spans:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "metadata": metadata}
        epoch = min(s.t_start for s in spans)
        horizon = max(max(s.t_start for s in spans),
                      max(s.t_end for s in spans if s.t_end is not None)
                      if any(s.t_end is not None for s in spans) else 0.0)

        pids: dict[str, int] = {}
        tids: dict[tuple[str, str], int] = {}
        events: list[dict] = []
        for s in spans:
            if s.process not in pids:
                pids[s.process] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pids[s.process], "tid": 0,
                               "args": {"name": s.process}})
            track = (s.process, s.thread)
            if track not in tids:
                tids[track] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pids[s.process], "tid": tids[track],
                               "args": {"name": s.thread}})

        def us(t: float) -> float:
            return (t - epoch) * 1e6

        # per-track DFS emission: children clamped into parents, siblings
        # serialized — the emitted B/E sequence per track always balances
        by_track: dict[tuple[str, str], list[Span]] = {}
        for s in spans:
            by_track.setdefault((s.process, s.thread), []).append(s)
        ids_by_track = {track: {s.span_id for s in ss}
                        for track, ss in by_track.items()}
        for track, ss in sorted(by_track.items()):
            pid, tid = pids[track[0]], tids[track]
            kids: dict[int | None, list[Span]] = {}
            for s in ss:
                # a parent on another track (or dropped) makes this a root
                parent = (s.parent_id
                          if s.parent_id in ids_by_track[track] else None)
                kids.setdefault(parent, []).append(s)

            def emit(s: Span, lo: float, hi: float) -> float:
                t0 = min(max(s.t_start, lo), hi)
                t1 = hi if s.t_end is None else min(max(s.t_end, t0), hi)
                args = dict(s.attrs)
                if s.t_end is None:
                    args["truncated"] = True
                events.append({"ph": "B", "name": s.name, "pid": pid,
                               "tid": tid, "ts": us(t0), "args": args})
                cursor = t0
                for child in sorted(kids.get(s.span_id, ()),
                                    key=lambda c: (c.t_start, c.span_id)):
                    cursor = emit(child, cursor, t1)
                events.append({"ph": "E", "name": s.name, "pid": pid,
                               "tid": tid, "ts": us(t1)})
                return t1

            cursor = epoch
            for root in sorted(kids.get(None, ()),
                               key=lambda s: (s.t_start, s.span_id)):
                cursor = emit(root, cursor, horizon)
        # one global timeline: stable sort keeps each track's DFS order
        events.sort(key=lambda e: e.get("ts", -1.0))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {**metadata, "dropped_spans": self.dropped}}

    def save(self, path_or_fh: str | IO[str]) -> None:
        trace = self.chrome_trace()
        if isinstance(path_or_fh, str):
            with open(path_or_fh, "w") as fh:
                json.dump(trace, fh)
        else:
            json.dump(trace, path_or_fh)


# -- trace-side analysis / validation ---------------------------------------
def validate_chrome_trace(trace: dict) -> None:
    """Assert the invariants trace consumers rely on: every event carries
    the required fields, timestamps are globally monotone (non-decreasing),
    and every track's B/E events pair up name-matched and stack-balanced.
    Raises AssertionError naming the first violation."""
    events = trace["traceEvents"]
    last_ts = None
    stacks: dict[tuple[int, int], list[dict]] = {}
    for e in events:
        ph = e["ph"]
        assert ph in ("M", "B", "E", "i", "X"), f"unknown phase {e}"
        if ph == "M":
            continue
        ts = e["ts"]
        assert last_ts is None or ts >= last_ts, \
            f"non-monotone ts: {ts} after {last_ts} ({e})"
        last_ts = ts
        key = (e["pid"], e["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(e)
        elif ph == "E":
            stack = stacks.get(key)
            assert stack, f"E without a matching B on track {key}: {e}"
            b = stack.pop()
            assert b["name"] == e["name"], \
                f"mismatched B/E pair on track {key}: {b} vs {e}"
    open_spans = {k: v for k, v in stacks.items() if v}
    assert not open_spans, f"unclosed B events: {open_spans}"


def batch_seq(span: Span) -> int | None:
    """The batch sequence number a batch-track span belongs to."""
    seq = span.attrs.get("batch_seq")
    return None if seq is None else int(seq)


def _batch_intervals_from_trace(trace: dict):
    """(name, batch_seq, ts_begin, ts_end) for every dispatch/retire B/E
    pair in an exported chrome trace (per-track stack matching)."""
    stacks: dict[tuple, list[dict]] = {}
    for e in trace["traceEvents"]:
        if e["ph"] not in ("B", "E"):
            continue
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e)
            continue
        stack = stacks.get(key)
        if not stack:
            continue
        b = stack.pop()
        seq = (b.get("args") or {}).get("batch_seq")
        if b["name"] in ("dispatch", "retire") and seq is not None:
            yield b["name"], int(seq), b["ts"], e["ts"]


def pipeline_overlaps(trace_or_spans_or_tracer) -> int:
    """Count consecutive-batch dispatch/retire overlaps: the number of
    batches k whose ``dispatch`` span starts before batch k-1's ``retire``
    span ends.  > 0 is the programmatic proof that the in-flight ring
    actually pipelines (at depth 1 this is structurally 0: batch k-1 fully
    retires before batch k dispatches).  Accepts a live ``Tracer``, a span
    list, or an exported chrome-trace dict (what CI loads from disk)."""
    dispatch: dict[int, tuple[float, float]] = {}
    retire: dict[int, tuple[float, float]] = {}
    src = trace_or_spans_or_tracer
    if isinstance(src, dict):
        for name, seq, t0, t1 in _batch_intervals_from_trace(src):
            (dispatch if name == "dispatch" else retire)[seq] = (t0, t1)
    else:
        spans = src.spans if isinstance(src, Tracer) else src
        for s in spans:
            if s.process != PROC_ENGINE:
                continue
            seq = batch_seq(s)
            if seq is None or s.t_end is None:
                continue
            if s.name == "dispatch":
                dispatch[seq] = (s.t_start, s.t_end)
            elif s.name == "retire":
                retire[seq] = (s.t_start, s.t_end)
    count = 0
    for seq, (d_start, _) in dispatch.items():
        prev = retire.get(seq - 1)
        if prev is not None and d_start < prev[1]:
            count += 1
    return count


def span_tree(spans: list[Span]) -> list[dict]:
    """Nest a flat span list into ``{span, children: [...]}`` trees (spans
    whose parent is absent from the list become roots), children ordered
    by start time."""
    by_id = {s.span_id: s for s in spans}
    kids: dict[int | None, list[Span]] = {}
    for s in spans:
        parent = s.parent_id if s.parent_id in by_id else None
        kids.setdefault(parent, []).append(s)

    def build(s: Span) -> dict:
        children = sorted(kids.get(s.span_id, ()),
                          key=lambda c: (c.t_start, c.span_id))
        return {"span": s, "children": [build(c) for c in children]}

    roots = sorted(kids.get(None, ()), key=lambda s: (s.t_start, s.span_id))
    return [build(r) for r in roots]


def iter_tree(tree: list[dict]) -> Iterator[Span]:
    for node in tree:
        yield node["span"]
        yield from iter_tree(node["children"])
