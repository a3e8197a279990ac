"""Multi-replica fleet routing over per-replica ``FoldClient`` engines (port
of ``repro/serving/transport/fleet.py``).

``FleetRouter`` runs N engine replicas — each its own ``FoldClient`` (own
``EngineCore``, own mesh/placement config, own background driver thread)
— and routes every admitted request to the replica with the lightest live
load.  The load signal is *telemetry, not bookkeeping*: the router reads
each replica's own metrics registry (the ``fold_queue_depth`` and
``fold_inflight_batches`` gauges the engine exposes for this purpose),
so anything that can scrape ``/metrics`` sees the same numbers the router
balances on, and tests can steer routing by injecting gauge values.

Request identity: the router allocates GLOBAL request ids and submits an
explicit ``FoldRequest`` carrying that id to the chosen replica, so one id
space spans the fleet — a replica-local event subscription can attribute
every event to its fleet record with no translation, including events
emitted while ``submit()`` is still on the stack.

Failure isolation: ``check_health()`` (run on every submit and status
read) notices a replica whose driver thread died, marks it unhealthy,
and drains its still-QUEUED requests back to the router — each is
cancelled on the dead replica and resubmitted (same global id) on a
healthy one; the record's event history stays one legal per-request
stream (the duplicate SUBMITTED from the resubmission is suppressed).
ADMITTED/RUNNING requests on the dead replica are already in its core's
hands; their handles terminate through the normal FAILED path when the
pump reports the batch error.

Replicas on one card: every replica's engine captures its own CUDA graphs
from its own driver thread, serialized by the engines' process-wide
capture lock while the others replay, and they share the one copy of the
weights the factory hands them.  A restarted replica's old client is
stopped (its admitted and in-flight batches served) and its engine's
graphs and pool released on a background thread (``released``), where
the reference leaves it to the garbage collector: on the card each dead
client would otherwise keep its graph pool.  The replacement is built
(its warm-up captures a graph per key) without the router lock, which the
reference holds throughout: the other replicas keep serving meanwhile.

Record retention: terminal records (and their result arrays) are kept so
late status polls can fetch results, bounded by ``max_records`` — the
oldest terminal records evict first, exactly like a real gateway's
result-TTL cache.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Callable

import numpy as np

from repro_torch.serving import events as ev
from repro_torch.serving.client import QUEUED, FoldClient, FoldHandle
from repro_torch.serving.observability.registry import MetricsRegistry
from repro_torch.serving.types import FoldRequest


class FleetRecord:
    """One request's fleet-side state: global id, the live handle on its
    current replica, and the buffered event history (what the SSE stream
    serves).  ``events`` only ever appends, under the router lock; readers
    snapshot by index so an SSE writer never blocks the router.

    The recorded events carry the fleet's own sequence numbers, one per
    event it records and increasing across the fleet, where the reference
    keeps each replica bus's: a requeued request's events come from two
    buses (a restarted replica's starts again at 0), whose numbers need
    not increase from one to the other, and its stream would then fail
    ``check_request_order``."""

    def __init__(self, request_id: int, replica_index: int, cond):
        self.request_id = request_id
        self.replica_index = replica_index
        self.handle: FoldHandle | None = None
        self.events: list[ev.FoldEvent] = []
        self.requeues = 0
        # requeue-event suppression: the drain emits CANCELLED on the dead
        # replica and SUBMITTED on the healthy one — neither belongs in the
        # record's history (the request never terminated, and it already
        # has its SUBMITTED), and a leaked CANCELLED would close SSE
        # streams mid-flight
        self._skip_submitted = False
        self._skip_cancelled = False
        self._cond = cond                # the router's condition variable

    @property
    def done(self) -> bool:
        h = self.handle
        return h is not None and h.done

    def events_since(self, n: int) -> list[ev.FoldEvent]:
        """Snapshot events[n:] (append-only list: safe without the lock)."""
        return self.events[n:]

    def wait_event(self, n: int, timeout: float | None = None) -> bool:
        """Block until there are more than ``n`` events (or timeout)."""
        with self._cond:
            if len(self.events) > n:
                return True
            self._cond.wait(timeout)
            return len(self.events) > n


class Replica:
    """One engine replica: a FoldClient (any client speaking the same
    handle/event/metrics surface) plus fleet-side health state."""

    def __init__(self, index: int, client: FoldClient):
        self.index = index
        self.client = client
        self.healthy = True
        self.started = False
        self.restarts = 0
        self.rebuilding = False          # a restart's factory is running

    @property
    def registry(self) -> MetricsRegistry:
        return self.client.core.metrics.registry

    def load(self) -> tuple[float, float]:
        """(queue_depth, busy) read from the replica's OWN metrics
        registry — the same numbers a /metrics scrape shows.  Fold engines
        expose ``fold_queue_depth``/``fold_inflight_batches``; LM engines
        ``lm_queue_depth``/``lm_active_slots`` — same balancing semantics
        (waiting work, then work on the device)."""
        depth = (self.registry.get("fold_queue_depth")
                 or self.registry.get("lm_queue_depth"))
        busy = (self.registry.get("fold_inflight_batches")
                or self.registry.get("lm_active_slots"))
        return (depth.total() if depth is not None else 0.0,
                busy.total() if busy is not None else 0.0)

    @property
    def driver_alive(self) -> bool:
        return self.client.driving

    def mark_failed(self) -> None:
        """Simulate/force a driver death (tests + ops escape hatch)."""
        self.healthy = False


class FleetRouter:
    """Route fold requests across N engine replicas by live telemetry.

    ``factory(i)`` builds replica ``i``'s ``FoldClient`` (each call may
    pick a different mesh/placement — replicas need not be uniform).
    ``autostart`` starts every replica's background driver immediately;
    tests pass ``False`` to script deterministic queue states.
    """

    def __init__(self, factory: Callable[[int], FoldClient],
                 n_replicas: int = 1, *, autostart: bool = True,
                 max_records: int = 4096, max_restarts: int = 0):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, "
                             f"got {max_restarts}")
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._next_id = 0
        self._event_seq = 0              # the fleet's event sequence
        self._records: OrderedDict[int, FleetRecord] = OrderedDict()
        self.max_records = max_records
        #: per-replica restart budget: a dead replica is rebuilt via the
        #: factory at most this many times before it stays unhealthy (0 =
        #: the pre-restart behavior: mark dead, drain, never revive)
        self.max_restarts = max_restarts
        self._factory = factory
        #: release threads of replaced clients (joined by ``stop``)
        self._releasing: list[threading.Thread] = []
        #: clients replaced by a restart, once released
        self.released: list[FoldClient] = []
        self.replicas = [Replica(i, factory(i)) for i in range(n_replicas)]
        # fleet-level registry: what the front-end's /metrics serves
        self.registry = MetricsRegistry()
        self._m_routed = self.registry.counter(
            "fleet_routed_total", "Requests routed, by replica",
            ("replica",))
        self._m_requeued = self.registry.counter(
            "fleet_requeued_total",
            "Requests drained off an unhealthy replica and resubmitted")
        self._m_healthy = self.registry.gauge(
            "fleet_replica_healthy", "1 if the replica is routable",
            ("replica",))
        self._m_depth = self.registry.gauge(
            "fleet_replica_queue_depth",
            "Replica scheduler queue depth (scraped from its registry)",
            ("replica",))
        self._m_inflight = self.registry.gauge(
            "fleet_replica_inflight_batches",
            "Replica in-flight ring occupancy (scraped from its registry)",
            ("replica",))
        self._m_records = self.registry.gauge(
            "fleet_live_records", "Fleet records currently retained")
        self._m_restarts = self.registry.counter(
            "fleet_replica_restarts_total",
            "Dead replicas rebuilt via the factory, by replica",
            ("replica",))
        # a wrapped client may already have served direct traffic: start
        # the global id space past every replica's local one so fleet ids
        # never collide with pre-existing request ids
        self._next_id = max(r.client._next_id for r in self.replicas)
        for r in self.replicas:
            self._m_healthy.set(1, replica=r.index)
            self._subscribe(r)
        if autostart:
            self.start()

    @classmethod
    def wrap(cls, client: FoldClient, *, autostart: bool = False,
             **kw) -> "FleetRouter":
        """A single-replica router over an existing client (the plain
        HTTP-front-end-without-a-fleet configuration)."""
        return cls(lambda i: client, 1, autostart=autostart, **kw)

    # -- event fan-in -------------------------------------------------------
    def _subscribe(self, replica: Replica) -> None:
        def on_event(e: ev.FoldEvent) -> None:
            with self._lock:
                rec = self._records.get(e.request_id)
                if rec is None:          # not a fleet request (direct use)
                    return
                if e.kind == ev.SUBMITTED and rec._skip_submitted:
                    rec._skip_submitted = False
                    return
                if e.kind == ev.CANCELLED and rec._skip_cancelled:
                    rec._skip_cancelled = False
                    return
                rec.events.append(dataclasses.replace(e, seq=self._event_seq))
                self._event_seq += 1
                self._cond.notify_all()

        replica.client.subscribe(on_event)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FleetRouter":
        for r in self.replicas:
            if r.healthy:
                r.client.start()
                r.started = True
        return self

    def stop(self, *, drain: bool = True) -> None:
        for r in self.replicas:
            if r.started:
                r.client.stop(drain=drain and r.healthy)
                r.started = False
        self.join_released()

    def join_released(self, timeout: float | None = None) -> None:
        """Wait for the release of every client a restart replaced."""
        for t in list(self._releasing):
            t.join(timeout)

    # -- routing ------------------------------------------------------------
    def _healthy_replicas(self) -> list[Replica]:
        return [r for r in self.replicas if r.healthy]

    def pick_replica(self) -> Replica:
        """Least-loaded healthy replica by (queue_depth, inflight, index)
        — the telemetry-driven balancing decision, deterministic on ties."""
        candidates = self._healthy_replicas()
        if not candidates:
            raise RuntimeError("no healthy replicas in the fleet")
        return min(candidates, key=lambda r: (*r.load(), r.index))

    def submit(self, seq: np.ndarray, *, priority: int = 0,
               deadline_s: float | None = None,
               max_new_tokens: int | None = None) -> FleetRecord:
        """Route + submit; returns the fleet record (its ``handle`` may
        already be terminal — REJECTED — exactly like ``FoldClient``).
        ``max_new_tokens`` is the LM-workload generation budget (None for
        fold requests / the LM replica's default)."""
        self.check_health()
        with self._lock:
            replica = self.pick_replica()
            gid = self._next_id
            self._next_id += 1
            rec = FleetRecord(gid, replica.index, self._cond)
            # register BEFORE submit: events emitted while submit() is on
            # the stack (SUBMITTED, even REJECTED) land on the record
            self._records[gid] = rec
            self._evict_terminal_locked()
            self._m_records.set(len(self._records))
        req = FoldRequest(gid, np.asarray(seq, np.int32),
                          priority=priority, deadline_s=deadline_s,
                          max_new_tokens=max_new_tokens)
        rec.handle = replica.client.submit(req)
        self._m_routed.inc(replica=replica.index)
        return rec

    def get(self, request_id: int) -> FleetRecord | None:
        self.check_health()
        with self._lock:
            return self._records.get(request_id)

    def cancel(self, request_id: int) -> bool:
        with self._lock:
            rec = self._records.get(request_id)
        if rec is None or rec.handle is None:
            return False
        return rec.handle.cancel()

    def _evict_terminal_locked(self) -> None:
        """Drop oldest TERMINAL records beyond max_records (live ones are
        never evicted — a handle mid-flight must stay addressable)."""
        if len(self._records) <= self.max_records:
            return
        excess = len(self._records) - self.max_records
        for gid in [g for g, r in self._records.items() if r.done][:excess]:
            del self._records[gid]

    # -- failure isolation --------------------------------------------------
    def check_health(self) -> list[int]:
        """Detect dead replicas and drain their queues back to the router.

        A replica whose background driver thread is no longer alive (while
        the router believes it started it) — or one force-failed via
        ``mark_failed()`` — stops receiving traffic; its still-QUEUED
        requests are cancelled there and resubmitted, same global id, on a
        healthy replica.  When ``max_restarts > 0`` the dead replica is
        then rebuilt via the factory (fresh client + driver) and rejoins
        the candidate set — its drained requests may land right back on
        it.  The rebuild runs outside the router lock (``_restart_dead``):
        a caller that comes meanwhile drains the queue onto the healthy
        replicas, or, with none, leaves it for the rebuilding caller.
        Returns the global ids requeued."""
        with self._lock:
            for r in self.replicas:
                if r.healthy and r.started and not r.driver_alive:
                    r.healthy = False            # driver thread died
            unhealthy = {r.index for r in self.replicas if not r.healthy}
            for r in self.replicas:
                self._m_healthy.set(1 if r.healthy else 0, replica=r.index)
            if not unhealthy:
                return []
            # snapshot the victims off the dead client BEFORE the restart
            # swaps it out — their handles still point at the old engine
            victims = [(rec, rec.handle) for rec in self._records.values()
                       if rec.replica_index in unhealthy
                       and rec.handle is not None
                       and rec.handle.status == QUEUED]
            # claim the rebuilds: a caller that comes while one runs routes
            # around the replica and drains its queue, and builds nothing
            rebuild = [r for r in self.replicas
                       if not r.healthy and not r.rebuilding
                       and r.restarts < self.max_restarts]
            for r in rebuild:
                r.rebuilding = True
        replaced = self._restart_dead(rebuild)
        requeued: list[int] = []
        for rec, handle in victims:
            with self._lock:
                if rec.handle is not handle or not self._healthy_replicas():
                    # another caller requeued it meanwhile, or no replica
                    # can take it yet: it stays queued where it is, and the
                    # caller rebuilding a replica drains it once that is in
                    continue
                rec._skip_cancelled = True
            # cancel on the dead replica (scheduler state is still sound —
            # only its pump thread died); if the race is lost the request
            # was admitted and will terminate through the normal path
            if not handle.cancel():
                with self._lock:         # no event was emitted: disarm
                    rec._skip_cancelled = False
                continue
            with self._lock:
                target = self.pick_replica()
                rec.replica_index = target.index
                rec.requeues += 1
                # the resubmission re-emits SUBMITTED; the record already
                # has one, and a second would break check_request_order
                rec._skip_submitted = True
            req = handle._request
            rec.handle = target.client.submit(FoldRequest(
                rec.request_id, req.aatype, priority=req.priority,
                deadline_s=req.deadline_s,
                max_new_tokens=req.max_new_tokens))
            self._m_requeued.inc()
            self._m_routed.inc(replica=target.index)
            requeued.append(rec.request_id)
        for old in replaced:
            self._release(old)
        return requeued

    def _release(self, client: FoldClient) -> None:
        """Stop a replaced client on a background thread (serving what it
        had admitted or launched; its queued work was requeued) and release
        its engine's device memory."""
        def release() -> None:
            client.close()
            with self._lock:
                self.released.append(client)

        t = threading.Thread(target=release, name="fleet-release", daemon=True)
        self._releasing.append(t)
        t.start()

    def _restart_dead(self, dead: list[Replica]) -> list[FoldClient]:
        """Rebuild the claimed dead replicas: a fresh client from the
        factory, re-subscribed to the fleet event fan-in, driver started if
        the router had started the old one.  The factory runs without the
        router lock (on the card its warm-up captures a graph per key, up
        to a minute), so the other replicas' events, submits and status
        reads go on meanwhile; the new client is swapped in under the lock.
        Returns the replaced clients, which the caller releases once their
        queued work (snapshotted before this) has been resubmitted through
        routing."""
        replaced = []
        try:
            for r in dead:
                client = self._factory(r.index)
                if client is r.client:
                    # a wrap()-style factory hands back the same dead
                    # client: nothing was rebuilt, the replica stays dead
                    continue
                with self._lock:
                    replaced.append(r.client)
                    r.client = client
                    self._subscribe(r)
                    r.restarts += 1
                    r.healthy = True
                    self._m_restarts.inc(replica=r.index)
                    self._m_healthy.set(1, replica=r.index)
                    if r.started:
                        r.client.start()
        finally:
            with self._lock:
                for r in dead:
                    r.rebuilding = False
        return replaced

    # -- observability ------------------------------------------------------
    def _sync_replica_gauges(self) -> None:
        for r in self.replicas:
            depth, inflight = r.load()
            self._m_depth.set(depth, replica=r.index)
            self._m_inflight.set(inflight, replica=r.index)
            self._m_healthy.set(1 if r.healthy else 0, replica=r.index)

    def metrics_text(self) -> str:
        """Fleet registry in Prometheus text format (replica queue-depth/
        inflight gauges re-scraped at render time)."""
        self._sync_replica_gauges()
        return self.registry.prometheus_text()

    def metrics_json(self) -> dict:
        self._sync_replica_gauges()
        return self.registry.as_dict()

    def replica_metrics_text(self, index: int) -> str:
        """One replica's OWN registry (every fold_* series) — what
        ``GET /metrics/replica/<i>`` serves for per-engine drill-down."""
        return self.replicas[index].client.metrics_text()

    def healthz(self) -> dict:
        self.check_health()
        with self._lock:
            live = sum(1 for rec in self._records.values() if not rec.done)
        return {
            "ok": any(r.healthy for r in self.replicas),
            "replicas": [
                {"index": r.index, "healthy": r.healthy,
                 "driving": r.driver_alive, "restarts": r.restarts,
                 "queue_depth": r.load()[0], "inflight": r.load()[1]}
                for r in self.replicas
            ],
            "live_requests": live,
            "records": len(self._records),
        }

    def describe(self) -> dict:
        """Fleet topology (the /v1/fleet endpoint + CLI banner)."""
        return {
            "replicas": len(self.replicas),
            "healthy": sum(1 for r in self.replicas if r.healthy),
            "workloads": [r.client.core.workload.name
                          for r in self.replicas],
            "placement": [r.client.core.placement.describe()
                          for r in self.replicas],
        }

    def save_traces(self, stem: str) -> list[str]:
        """Export every replica's span trace as ``<stem>.replica<i>.json``;
        returns the written paths."""
        paths = []
        for r in self.replicas:
            path = f"{stem}.replica{r.index}.json"
            r.client.save_trace(path)
            paths.append(path)
        return paths

    def drain_wait(self, timeout: float = 600.0,
                   poll_s: float = 0.01) -> None:
        """Block until every live record is terminal (tests + shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if all(rec.done for rec in self._records.values()
                       if rec.handle is not None):
                    return
            self.check_health()
            time.sleep(poll_s)
        raise TimeoutError(f"fleet did not drain within {timeout}s")
