"""EngineCore: pipelined bucketed batch executor for PPM serving, with one
CUDA graph per executable key (port of ``repro/serving/engine.py``).

The core owns (params, config, scheme) plus the executable cache and
executes ``ScheduledBatch``es; it has no queue and no policy.  Request
intake, ordering, priorities, deadlines and cancellation live one layer up
in ``repro_torch.serving.client.FoldClient``, whose pump drives this core.
``FoldEngine`` (bottom of this module) is the legacy ``submit/step/run``
surface over a client.  Everything model-specific lives in a
``Workload`` (default ``FoldWorkload``).

The executable cache is keyed by ``(bucket, launch_batch, scheme,
placement, chunk)``, as the reference's ``jax.jit(...).lower().compile()``
cache is.  On the card each key is ONE CUDA graph (``_Executable``):

  * **capture**: the forward first runs once eagerly on a side stream
    (kernel build, cuBLAS handles and workspaces, lazy module loads happen
    there, never inside a capture), then is captured under
    ``torch.inference_mode()`` against static ``aatype``/``mask`` buffers
    of the key's shape and instantiated.  The whole of it is the key's
    ``compile_ms`` (``metrics.record_compile``, ``cost_model.record_compile``).
  * **memory**: every graph of an engine captures into ONE memory pool
    (``torch.cuda.graph_pool_handle()``), so the pool holds about the
    largest graph's working set, not the sum of every key's.  Graphs of a
    pool may reuse each other's freed blocks, which is safe here because
    replays run one at a time on one stream and each replay's outputs are
    copied out before anything else runs.
  * **outputs**: right after each replay, in stream order, the graph's
    static outputs (coords, and the distogram when ``keep_distogram``) are
    copied into fresh tensors: with a ring of depth 2 the same key can be
    dispatched twice in a row, and its second replay overwrites the static
    buffers that the first batch's ``retire()`` and ``LazyDistogram`` read.
  * **inputs**: host inputs are staged in a pinned buffer per in-flight
    slot and copied into the static inputs with ``non_blocking=True``;
    ``retire()`` waits on a CUDA event recorded after the output copies.

On the CPU a key is an eager closure, still registered and counted, so
``launch_size_for`` (which reuses already-cached sizes) makes the
reference's decisions there too.  ``compile_count`` counts captures on the
card and keys on the CPU; steady-state serving adds none.

Execution is a two-stage ``dispatch()``/``retire()`` pipeline over a
bounded in-flight ring (``inflight_depth``, default 2): ``dispatch`` pads,
stages and launches (replays) without waiting; ``retire`` waits for the
OLDEST in-flight batch, makes one host copy of its coords, and hands each
request a lazy distogram handle.

Several engines in one process (a fleet's replicas, each pumped by its own
driver thread) share the card: one process-wide lock (``CAPTURE_LOCK``)
serializes every key's eager warm-up, the release of its cached blocks
and its capture, so no ``empty_cache`` or device-wide sync of one engine
runs during another's capture, and the wrappers' launch counters move
only for the capturing engine while it holds the lock (replays pass no
wrapper).  Replays take no lock and wait only on their own events and
streams.  ``close()`` releases an engine's graphs, buffers and pool (a
fleet restarting a dead replica calls it; the reference leaves the old
client to the garbage collector, which on the card would keep its pool).

One controller over many processes (``mesh=``/``shard_threshold=``,
``serving.placement``).  JAX drives a mesh from one process; torch runs one
process a rank.  Rank 0 runs the client, scheduler, admission, metrics and
this core; ranks > 0 run ``serve_worker``, a loop over the commands rank 0
broadcasts: ``bind`` (a worker core like this one, the parameters
broadcast once), ``build`` (a sharded key's warm-up and capture, on every
rank in the same order, each under its own ``CAPTURE_LOCK``), ``run`` (a
launch: the key and the staged inputs), ``close`` and ``exit``.  Every rank
runs its shard of the key's forward (``PairShard``); rank 0 keeps the
result.  A sharded key's cache key is ``(bucket, batch, scheme,
"mesh:DxM", chunk)``.  Over NCCL it is one CUDA graph a rank with the
collectives inside it; over the host-staged gloo route (several ranks on
one card, asked for with ``backend="gloo"``, no memory budget) and on the
CPU it runs eagerly, still counted as a key.  Ranks
of a ``data`` axis above 1 compute replicated results, as under GSPMD.
Buckets the policy keeps ``SINGLE`` run on rank 0 alone.  Several cores
may share one mesh (a fleet's replicas), each under its own engine id: a
sharded key's command and rank 0's part of it (the capture, or the
enqueue of its replay or eager forward) run under the mesh's ``lock``, so
that every rank sees the cores' commands and collectives in one order.

Telemetry: ``batch_start`` (the end of queue wait) is stamped AFTER the
executable is resolved, so a cold key's capture lands in ``queue_wait_ms``
and its own ``compile_ms``, never in ``run_ms`` (launch to ready, host
clock; with depth > 1 it includes time queued behind the previous batch).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.schemes import FP16Baseline, QuantScheme, make_scheme
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.parallel import collectives as coll
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.longfold import ChunkPolicy
from repro_torch.serving.metrics import note_capture, reset_compile_watch
from repro_torch.serving.observability.profiler import annotate
from repro_torch.serving.observability.tracing import PROC_ENGINE, Tracer
from repro_torch.serving.placement import PlacementPolicy
from repro_torch.serving.scheduler import ScheduledBatch, static_batch_for
from repro_torch.serving.types import FoldResult
from repro_torch.serving.workload import FoldWorkload, Workload


#: process-wide: one engine at a time warms up, releases and captures a key
CAPTURE_LOCK = threading.Lock()


class BatchExecutionError(RuntimeError):
    """Raised by ``retire()``/``execute()`` when a launched batch fails;
    carries the ``ScheduledBatch`` so the pump can terminate its handles
    (FAILED results) instead of stranding them RUNNING forever."""

    def __init__(self, batch: ScheduledBatch, cause: BaseException):
        super().__init__(f"batch execution failed: {cause!r}")
        self.batch = batch
        self.cause = cause


@dataclasses.dataclass
class InFlightBatch:
    """One dispatched-but-not-retired batch riding the in-flight ring."""
    batch: ScheduledBatch
    bucket: int
    launched_b: int                    # rows the executable runs
    placement: Any
    chunk_size: int                    # 0 = unchunked trunk
    out: dict                          # fresh output tensors + "ready" event
    fp_out: dict | None                # the fidelity re-run's (or None)
    compile_s: float
    batch_start: float                 # core clock, post-executable-resolve
    t_launch: float                    # perf_counter at launch (run_ms t0)
    est: int                           # admission price at launched_b
    backend: str                       # dispatch label
    occupancy: float                   # real tokens / (launched_b * bucket)
    seq: int = 0                       # monotone batch sequence number
    thread: str = ""                   # trace track, "batch-NNNN"
    flight_span: Any = None            # open "in_flight" span (ends at retire)


def _graph_node_count(graph) -> int:
    """Nodes of a captured graph kept with ``keep_graph=True`` (driver
    ``cuGraphGetNodes``)."""
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return int(n.value)


class _Executable:
    """One executable-cache key: a CUDA graph on the card, an eager closure
    on the CPU.  ``launch(*inputs)`` (the workload's ``input_specs`` order)
    returns fresh copies of the workload's ``output_keys`` and, on the
    card, the CUDA event ``ready`` recorded after their copies."""

    def __init__(self, core: "EngineCore", key: tuple, scheme: QuantScheme,
                 chunk: int, sharded: bool = False):
        self.core = core
        self.key = key
        self.bucket, self.batch = key[0], key[1]
        self.scheme = scheme
        self.chunk = chunk
        #: this rank's place in the model group (a sharded key), else None
        self.shard = core.mesh.pair_shard() if sharded else None
        self.graph = None
        self.static_in: tuple = ()
        self.static_out: dict = {}
        #: kernel launches per variant captured into the graph: every
        #: replay runs them again without passing through the wrappers
        self.kernel_launches: dict[str, int] = {}
        #: collectives (calls and bytes by name) captured into the graph
        self.collectives: dict[str, dict[str, int]] = {}
        self.capture_ms = 0.0          # warm-up + capture, host clock
        self.instantiate_ms = 0.0
        self.nodes: int | None = None
        self.replays = 0

    @property
    def on_card(self) -> bool:
        return self.core.device.type == "cuda"

    @property
    def graphed(self) -> bool:
        """A CUDA graph: on the card, unless the key's collectives take the
        host-staged route."""
        return self.on_card and (self.shard is None or self.core.mesh.graphs)

    def _forward(self, *inputs):
        core = self.core
        kw = {} if self.shard is None else {"shard": self.shard}
        with torch.inference_mode(), dispatch.use_backend(core.kernels):
            return core.workload.forward(self.scheme, self.chunk, core.params,
                                         *inputs, **kw)

    def synthetic_inputs(self) -> tuple:
        """Full-occupancy inputs of the key's shape on the engine's device:
        every mask position true, every token 0."""
        dev = self.core.device
        out = []
        for shape, dtype in self.core.workload.input_specs(self.bucket, self.batch):
            out.append(torch.ones(shape, dtype=dtype, device=dev) if dtype == torch.bool
                       else torch.zeros(shape, dtype=dtype, device=dev))
        return tuple(out)

    def _commanding(self):
        """The mesh's lock where the controller commands this key (a
        sharded key off a worker): the command and its launch go together."""
        if self.shard is not None and not self.core.worker:
            return self.core.mesh.lock
        return contextlib.nullcontext()

    def build(self) -> float:
        """Capture (a graph) or register (eager); returns seconds spent.
        The controller has every worker build a sharded key with it."""
        t0 = time.perf_counter()
        with self._commanding():
            if self.shard is not None and not self.core.worker:
                self.core.mesh.send(("build", self.core.mesh_eid, self.key))
            if self.graphed:
                self._capture()
        note_capture()
        return time.perf_counter() - t0

    def _capture(self) -> None:
        with CAPTURE_LOCK:
            self._capture_locked()

    def _capture_locked(self) -> None:
        core = self.core
        self.static_in = self.synthetic_inputs()
        side = core.capture_stream()
        side.wait_stream(torch.cuda.current_stream(core.device))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self._forward(*self.static_in)       # eager warm-up, off the capture
        side.synchronize()
        # the warm-up's activations went to the normal caching pool; hand
        # them back so that only the shared graph pool holds a fold's peak
        torch.cuda.empty_cache()
        # keep the cudaGraph_t: instantiate apart from the capture, count nodes
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before, coll_before = dispatch.launch_counts(), coll.counts()
        with torch.cuda.graph(graph, pool=core.graph_pool, stream=side,
                              capture_error_mode="thread_local"):
            out = self._forward(*self.static_in)
        after, coll_after = dispatch.launch_counts(), coll.counts()
        self.collectives = {k: {f: coll_after[k][f] - coll_before[k][f] for f in v}
                            for k, v in coll_after.items()}
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        graph.instantiate()
        side.synchronize()
        self.instantiate_ms = (time.perf_counter() - t1) * 1e3
        self.nodes = _graph_node_count(graph)
        self.kernel_launches = {k: after[k] - before[k] for k in after}
        # only the outputs read after a replay stay referenced (on a worker
        # none: rank 0 keeps the result); the rest of the graph's memory
        # returns to the shared pool
        self.static_out = ({} if core.worker else
                           {k: out[k] for k in core.workload.output_keys()})
        self.graph = graph

    def launch(self, *inputs) -> dict:
        """Stage the inputs, run the key, copy the outputs out (graph: all
        in stream order, nothing waited for; eager on the CPU or, with
        host-staged collectives, on the card).  The controller first sends
        a sharded launch's key and inputs to every worker, holding the
        mesh's lock until its own part is enqueued."""
        with self._commanding():
            return self._launch(*inputs)

    def _launch(self, *inputs) -> dict:
        core = self.core
        if self.shard is not None and not core.worker:
            core.mesh.send(("run", core.mesh_eid, self.key,
                            tuple(t.numpy() for t in inputs)))
        if not self.graphed:
            if self.on_card:
                inputs = tuple(t.to(core.device, non_blocking=True) for t in inputs)
            out = self._forward(*inputs)
            res = {} if core.worker else {k: out[k] for k in core.workload.output_keys()}
            if self.on_card:
                res["ready"] = torch.cuda.Event()
                res["ready"].record()
            else:
                res["ready"] = None
            return res
        for static, host in zip(self.static_in, inputs):
            static.copy_(host, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        self.core.note_replay(self.kernel_launches)
        out = {k: v.clone() for k, v in self.static_out.items()}
        out["ready"] = torch.cuda.Event()
        out["ready"].record()
        return out

    def timed_ms(self, *inputs, clock) -> float:
        """One launch's latency: CUDA events around the replay on the card,
        the engine clock on the CPU."""
        if not self.on_card:
            t0 = clock()
            self.launch(*inputs)
            return (clock() - t0) * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.launch(*inputs)
        end.record()
        out["ready"].synchronize()
        end.synchronize()
        return start.elapsed_time(end)

    def describe(self) -> dict:
        return {"key": "|".join(map(str, self.key)), "capture_ms": self.capture_ms,
                "instantiate_ms": self.instantiate_ms, "nodes": self.nodes,
                "replays": self.replays, "kernel_launches": dict(self.kernel_launches),
                "collectives": dict(self.collectives)}


class EngineCore:
    def __init__(self, params, cfg, scheme: QuantScheme | str | None = None, *,
                 buckets: tuple[int, ...] | None = None,
                 max_tokens_per_batch: int = 1024, max_batch: int = 8,
                 mem_budget_mb: float | None = None,
                 fidelity: bool = False, kernels: str = dispatch.AUTO,
                 keep_distogram: bool = True,
                 mesh=None, shard_threshold: int | None = None,
                 chunk_size: int | str | None = None,
                 inflight_depth: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 tracer: Tracer | None = None,
                 workload: Workload | None = None,
                 cost_model: CostModel | None = None,
                 device=None, worker: bool = False):
        from repro_torch.serving.scheduler import pow2_buckets
        if inflight_depth < 1:
            raise ValueError(f"inflight_depth must be >= 1, "
                             f"got {inflight_depth}")
        # the card unless the caller asks for the CPU; raises without a card
        self.device = resolve_device(device)
        leaf = _first_leaf(params)
        if leaf is not None and leaf.device.type != self.device.type:
            raise ValueError(f"params live on {leaf.device}, the engine runs on "
                             f"{self.device}; make them there (init_ppm(device=...))")
        self.params = params
        self.cfg = cfg
        if scheme is None:
            scheme = FP16Baseline()
        elif isinstance(scheme, str):
            scheme = make_scheme(scheme)
        self.scheme = scheme
        self.buckets = tuple(sorted(buckets or pow2_buckets(16, 512)))
        self.max_tokens_per_batch = max_tokens_per_batch
        self.max_batch = max_batch
        self.fidelity = fidelity
        self.keep_distogram = keep_distogram
        self.clock = clock
        if kernels not in dispatch.BACKENDS:
            raise ValueError(f"kernels must be one of {dispatch.BACKENDS}, "
                             f"got {kernels!r}")
        self.kernels = kernels
        self.placement = PlacementPolicy(mesh=mesh,
                                         shard_threshold=shard_threshold)
        #: a worker rank's core (``serve_worker``): it runs the keys rank 0
        #: sends and keeps no result
        self.worker = worker
        self.mesh = None
        self.mesh_eid = None
        if self.placement.mesh is not None:
            if mem_budget_mb is not None and self.placement.mesh.colocated_on(self.device):
                raise ValueError(
                    f"{self.placement.mesh.label} on the host-staged route puts every "
                    f"rank on one card, where admission prices one rank a device: "
                    f"it takes no memory budget (serve on a card a rank, over NCCL)")
            self.mesh = self.placement.mesh.bind(self.device)
            if self.mesh.device is not None and self.device.type == "cuda":
                self.device = self.mesh.device
        budget = None if mem_budget_mb is None else int(mem_budget_mb * 1e6)
        self.workload = (FoldWorkload() if workload is None
                         else workload).bind(self)
        self.admission = self.workload.make_admission(budget)
        # the long-fold planner: per bucket, unchunked or row-chunked and at
        # what size, priced against this admission controller, which then
        # prices chunked buckets with the chunked-path model
        self.chunk = ChunkPolicy(chunk_size, admission=self.admission)
        self.admission.chunk_for = self.chunk.chunk_for
        self.inflight_depth = inflight_depth
        self._inflight: deque[InFlightBatch] = deque()
        self.metrics = self.workload.make_metrics()
        self.tracer = tracer if tracer is not None else Tracer(clock=clock)
        self._batch_seq = 0
        self.admission.on_decision = (
            lambda d, ns, b: self.metrics.record_admission(
                d.verdict, ns, estimator=d.estimator))
        reset_compile_watch()
        self._fp_scheme = FP16Baseline()
        # key: (bucket, launch_batch, scheme.name, placement.label, chunk)
        self._executables: dict[tuple[int, int, str, str, int], _Executable] = {}
        self._compile_count = 0
        self.cost_model = (CostModel() if cost_model is None
                           else cost_model).bind(self)
        self.admission.cost_model = self.cost_model
        # card only: the graphs' one memory pool, the warm-up/capture side
        # stream, pinned staging buffers per (slot, batch, bucket), and the
        # kernel launches replayed by graphs (the wrappers count none)
        self.graph_pool = (torch.cuda.graph_pool_handle()
                           if self.device.type == "cuda" else None)
        self._capture_stream = None
        self._staging: dict[tuple[int, int, int], tuple] = {}
        self.replayed_launches: dict[str, int] = {
            k: 0 for k in dispatch.KERNEL_VARIANTS}
        self._worker_ready: deque = deque()
        if self.mesh is not None and not worker:
            self.mesh_eid = self.mesh.open_engine(self, dict(
                cfg=cfg, scheme=self.scheme, buckets=self.buckets,
                kernels=kernels, keep_distogram=keep_distogram,
                shard_threshold=shard_threshold, inflight_depth=inflight_depth))

    # -- shape policy -----------------------------------------------------
    def bucket_for(self, length: int) -> int | None:
        """Smallest bucket edge holding ``length`` (None = too long)."""
        from repro_torch.serving.scheduler import bucket_for
        return bucket_for(self.buckets, length)

    def batch_for_bucket(self, bucket: int) -> int:
        """The MAX batch size this bucket may launch at (the launch-size
        cap; actual launches fit the batch's occupancy, see
        ``launch_size_for``)."""
        return static_batch_for(bucket, self.max_tokens_per_batch,
                                self.max_batch, self.admission)

    def launch_size_for(self, bucket: int, n: int, scheme: QuantScheme,
                        placement) -> int:
        """Occupancy-fitted launch size for ``n`` real rows: the exact
        count, unless a slightly larger executable is already cached for
        this (bucket, scheme, placement) and reusing it is cheaper than
        capturing the exact size.  With a calibrated cost model the choice
        is priced in measured milliseconds (predicted dummy-row burn
        against the measured capture cost of this bucket's keys); without
        one it falls back to the static waste guard (at most
        ``max(1, n // 2)`` dummy rows).  Calibrated entries are frozen, so
        the choice is deterministic given the trace."""
        cap = self.batch_for_bucket(bucket)
        n = min(n, cap)
        chunk = self.chunk.chunk_for(bucket) or 0
        cached = sorted(b for (bk, b, sn, pl, ck) in self._executables
                        if bk == bucket and sn == scheme.name
                        and pl == placement.label and ck == chunk
                        and b >= n)
        marginal = self.cost_model.marginal_row_ms(bucket,
                                                   calibrated_only=True)
        compile_ms = self.cost_model.compile_ms_for(bucket)
        for b in cached:
            if marginal is not None and compile_ms is not None:
                if (b - n) * marginal <= compile_ms:
                    return b
            elif b - n <= max(1, n // 2):
                return b
        return n

    # -- executable cache -------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Executable-cache misses: graph captures on the card, keys on the
        CPU."""
        return self._compile_count

    def capture_stream(self):
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        return self._capture_stream

    def note_replay(self, launches: dict[str, int]) -> None:
        for k, v in launches.items():
            self.replayed_launches[k] = self.replayed_launches.get(k, 0) + v

    def _executable(self, bucket: int, batch: int, scheme: QuantScheme):
        """The key's executable and the seconds its capture took now (0.0
        on a cache hit)."""
        placement = self.placement.placement_for(bucket)
        chunk = self.chunk.chunk_for(bucket) or 0
        key = (bucket, batch, scheme.name, placement.label, chunk)
        return self._executable_for(key, scheme, placement.sharded)

    def _executable_for(self, key: tuple, scheme: QuantScheme, sharded: bool):
        if key in self._executables:
            return self._executables[key], 0.0
        exe = _Executable(self, key, scheme, key[4], sharded)
        compile_s = exe.build()
        self._executables[key] = exe
        self._compile_count += 1
        self.metrics.record_compile(key[0], compile_s * 1e3,
                                    scheme=scheme.name, placement=key[3])
        self.cost_model.record_compile(key, compile_s * 1e3)
        return exe, compile_s

    def warmup(self, ladder: tuple[int, ...] | None = None) -> None:
        """Capture a size LADDER of (bucket, launch_batch) keys (and their
        FP twins if fidelity is on): by default {1, cap//2, cap} per bucket.
        Chunked buckets capture their chunked keys (the chunk plan is
        consulted inside ``_executable``)."""
        for bucket in self.buckets:
            cap = self.batch_for_bucket(bucket)
            if cap < 1:
                continue                    # bucket over budget even solo
            sizes = ({1, max(1, cap // 2), cap} if ladder is None
                     else {min(cap, max(1, s)) for s in ladder})
            for b in sorted(sizes):
                self._executable(bucket, b, self.scheme)
                if self.fidelity:
                    self._executable(bucket, b, self._fp_scheme)

    def warmup_from_table(self) -> int:
        """Capture every cost-table key matching this engine's context
        (scheme, plus the FP twin when fidelity is on, placement label,
        chunk plan, within bucket caps); returns the keys warmed."""
        want = {self.scheme.name: self.scheme}
        if self.fidelity:
            want[self._fp_scheme.name] = self._fp_scheme
        buckets = set(self.buckets)
        warmed = 0
        for key in sorted(self.cost_model.entries, key=str):
            bucket, b, scheme_name, label, chunk = key
            if bucket not in buckets or scheme_name not in want:
                continue
            placement = self.placement.placement_for(bucket)
            if (label != placement.label
                    or chunk != (self.chunk.chunk_for(bucket) or 0)):
                continue
            if not 1 <= b <= self.batch_for_bucket(bucket):
                continue
            self._executable(bucket, b, want[scheme_name])
            warmed += 1
        return warmed

    # -- a worker rank (serve_worker) ----------------------------------------
    def worker_launch(self, key: tuple, inputs: tuple | None) -> None:
        """Run (``inputs``) or only build (None) the key rank 0 sent: its
        scheme is this core's or the fidelity twin's."""
        scheme = self.scheme if key[2] == self.scheme.name else self._fp_scheme
        exe, _ = self._executable_for(key, scheme, sharded=True)
        if inputs is None:
            return
        # a staging slot is reused only after the launch that last used it
        if len(self._worker_ready) >= self.inflight_depth:
            ready = self._worker_ready.popleft()
            if ready is not None:
                ready.synchronize()
        seq = self._batch_seq
        self._batch_seq += 1
        self._worker_ready.append(exe.launch(*self._stage(seq, inputs))["ready"])

    def describe(self) -> dict:
        """Engine facts: device, keys with their capture cost, and on the
        card the graph pool's reserved bytes."""
        d = {"device": str(self.device), "kernels": self.kernels,
             "scheme": self.scheme.name, "compile_count": self._compile_count,
             "keys": [e.describe() for e in self._executables.values()],
             "replayed_launches": dict(self.replayed_launches)}
        if self.mesh is not None:
            d["mesh"] = self.mesh.describe()
        if self.device.type == "cuda":
            d["pool_reserved_bytes"] = self.pool_reserved_bytes()
            d["memory_reserved_bytes"] = torch.cuda.memory_reserved(self.device)
            d["memory_allocated_bytes"] = torch.cuda.memory_allocated(self.device)
        return d

    def close(self, *, discard_inflight: bool = False) -> None:
        """Release what the engine holds on the card: every key's graph and
        static buffers, the pinned staging buffers and the graphs' pool,
        whose segments go back to the driver.  The engine serves nothing
        after this; an in-flight batch must have been retired first, or,
        with ``discard_inflight`` (a mesh's teardown), is waited for on the
        card and dropped."""
        if self._inflight and not discard_inflight:
            raise RuntimeError(f"close() with {len(self._inflight)} batches in flight; "
                               f"retire() them first")
        if self._inflight and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._inflight.clear()
        if self.mesh_eid is not None and self.mesh.bound:
            self.mesh.close_engine(self.mesh_eid)
            self.mesh_eid = None
        while self._worker_ready:
            ready = self._worker_ready.popleft()
            if ready is not None:
                ready.synchronize()
        with CAPTURE_LOCK:
            for exe in self._executables.values():
                exe.graph = None
                exe.static_in, exe.static_out = (), {}
            self._executables.clear()
            self._staging.clear()
            self.graph_pool = None
            if self.device.type == "cuda":
                if self._capture_stream is not None:
                    self._capture_stream.synchronize()
                torch.cuda.empty_cache()

    def pool_reserved_bytes(self) -> int | None:
        """Bytes the caching allocator holds in the graphs' shared pool (its
        segments in ``torch.cuda.memory_snapshot()``); None on the CPU."""
        if self.graph_pool is None:
            return None
        pool = tuple(self.graph_pool)
        return int(sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                       if tuple(s["segment_pool_id"]) == pool))

    # -- pipelined execution ----------------------------------------------
    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    @property
    def inflight_full(self) -> bool:
        return len(self._inflight) >= self.inflight_depth

    def _stage(self, seq: int, inputs: tuple) -> tuple:
        """Host arrays -> tensors the launch copies from: pinned buffers of
        the batch's ring slot on the card (reused only after the batch that
        last used them retired), plain CPU tensors on the CPU."""
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in inputs)
        if self.device.type != "cuda":
            return tensors
        slot = (seq % self.inflight_depth, *tensors[0].shape)
        bufs = self._staging.get(slot)
        if bufs is None:
            bufs = tuple(torch.empty(t.shape, dtype=t.dtype).pin_memory()
                         for t in tensors)
            self._staging[slot] = bufs
        for b, t in zip(bufs, tensors):
            b.copy_(t)
        return bufs

    def dispatch(self, batch: ScheduledBatch) -> InFlightBatch:
        """Stage 1: resolve executables, pad, stage, LAUNCH, without waiting
        for the result.  Raises RuntimeError when the in-flight ring is
        full (``retire()`` first) and propagates capture/launch errors to
        the caller (the pump turns them into FAILED results)."""
        if self.inflight_full:
            raise RuntimeError(
                f"in-flight ring full ({self.inflight_depth}); retire() "
                f"the oldest batch before dispatching another")
        bucket = batch.bucket
        seq = self._batch_seq
        self._batch_seq += 1
        thread = f"batch-{seq:04d}"
        tr = self.tracer
        d_span = tr.begin("dispatch", process=PROC_ENGINE, thread=thread,
                          batch_seq=seq, bucket=bucket,
                          batch_size=len(batch.requests),
                          scheme=self.scheme.name,
                          requests=[r.request_id for r in batch.requests])
        placement = self.placement.placement_for(bucket)
        try:
            with annotate(f"serve.dispatch/{bucket}"):
                launched_b = self.launch_size_for(
                    bucket, len(batch.requests), self.scheme, placement)
                with tr.span("resolve_executable", process=PROC_ENGINE,
                             thread=thread, parent=d_span) as rs:
                    exe, compile_s = self._executable(
                        bucket, launched_b, self.scheme)
                    fp_exe = None
                    if (self.fidelity
                            and self.scheme.name != self._fp_scheme.name):
                        fp_exe, fp_compile_s = self._executable(
                            bucket, launched_b, self._fp_scheme)
                        compile_s += fp_compile_s
                    rs.attrs["cache"] = "hit" if compile_s == 0.0 else "miss"
                    rs.attrs["compile_s"] = compile_s
                # queue wait ends HERE, after executables resolve: a cold
                # key's capture is queue time for the requests waiting on it
                batch_start = self.clock()
                with tr.span("pad", process=PROC_ENGINE, thread=thread,
                             parent=d_span):
                    inputs = self.workload.pad_inputs(
                        batch.requests, bucket, launched_b)
                with tr.span("device_put", process=PROC_ENGINE,
                             thread=thread, parent=d_span):
                    staged = self._stage(seq, inputs)
                real_tokens = sum(r.length for r in batch.requests)
                with tr.span("launch", process=PROC_ENGINE, thread=thread,
                             parent=d_span):
                    t_launch = time.perf_counter()
                    out = exe.launch(*staged)
                    # the fidelity re-run goes behind the main one on the
                    # same stream
                    fp_out = None if fp_exe is None else fp_exe.launch(*staged)
        except Exception as e:
            tr.end(d_span, status="failed", error=repr(e))
            raise
        chunk = self.chunk.chunk_for(bucket) or 0
        tr.end(d_span, launch_batch=launched_b,
               occupancy=real_tokens / (launched_b * bucket),
               placement=placement.label, chunk_size=chunk)
        flight = InFlightBatch(
            batch=batch, bucket=bucket, launched_b=launched_b,
            placement=placement, chunk_size=chunk, out=out, fp_out=fp_out,
            compile_s=compile_s, batch_start=batch_start,
            t_launch=t_launch,
            est=self.admission.estimate_bytes(bucket, launched_b),
            backend=dispatch.describe(self.kernels, device=self.device),
            occupancy=real_tokens / (launched_b * bucket),
            seq=seq, thread=thread,
            flight_span=tr.begin("in_flight", process=PROC_ENGINE,
                                 thread=thread, batch_seq=seq,
                                 bucket=bucket))
        self._inflight.append(flight)
        self.metrics.record_dispatch(len(self._inflight),
                                     self.inflight_depth, flight.occupancy,
                                     bucket=bucket, scheme=self.scheme.name,
                                     placement=placement.label)
        return flight

    def retire(self) -> list[FoldResult]:
        """Stage 2: wait for the OLDEST in-flight batch, one host copy of
        its coords, lazy distogram handles, fidelity TM scores, and
        FoldResults (recorded in metrics).  Returns [] when nothing is in
        flight; raises ``BatchExecutionError`` (carrying the batch) when
        the launched computation fails."""
        if not self._inflight:
            return []
        flight = self._inflight.popleft()
        batch = flight.batch
        tr = self.tracer
        if flight.flight_span is not None:
            tr.end(flight.flight_span)
        r_span = tr.begin("retire", process=PROC_ENGINE,
                          thread=flight.thread or f"batch-{flight.seq:04d}",
                          batch_seq=flight.seq, bucket=flight.bucket)
        try:
            with annotate(f"serve.retire/{flight.bucket}"):
                with tr.span("block", process=PROC_ENGINE,
                             thread=flight.thread, parent=r_span):
                    self.workload.block_on(flight.out)
                run_s = time.perf_counter() - flight.t_launch
                with tr.span("transfer", process=PROC_ENGINE,
                             thread=flight.thread, parent=r_span):
                    payload = self.workload.transfer(flight)
        except Exception as e:
            tr.end(r_span, status="failed", error=repr(e))
            raise BatchExecutionError(batch, e) from e
        tr.end(r_span)
        self.metrics.record_inflight(len(self._inflight))
        # predict BEFORE observing, then feed this batch's measured
        # launch-to-ready latency back in
        actual_ms = run_s * 1e3
        predicted_ms = self.cost_model.predict_run_ms(flight.bucket,
                                                      flight.launched_b)
        if predicted_ms is not None:
            self.metrics.record_prediction(predicted_ms, actual_ms)
        self.cost_model.observe(
            (flight.bucket, flight.launched_b, self.scheme.name,
             flight.placement.label, flight.chunk_size), actual_ms)
        self.metrics.record_cost_table(self.cost_model.entry_count,
                                       self.cost_model.calibrated_count,
                                       self.cost_model.age_s())
        results = self.workload.build_results(flight, run_s, payload)
        for r in results:
            self.metrics.record(r)
        return results

    def execute(self, batch: ScheduledBatch) -> list[FoldResult]:
        """Synchronous surface: dispatch + immediately retire.  Requires an
        empty in-flight ring."""
        if self._inflight:
            raise RuntimeError(
                "execute() needs an empty in-flight ring; use "
                "dispatch()/retire() when pipelining")
        self.dispatch(batch)
        return self.retire()


def serve_worker(mesh) -> None:
    """A worker rank's loop (ranks > 0 of a ``ServingMesh``): carry out the
    commands rank 0 broadcasts until ``exit`` (module docstring).  A
    failure ends the process, so that rank 0's collective fails instead of
    waiting for it."""
    cores: dict[int, EngineCore] = {}
    try:
        while True:
            msg = mesh.recv()
            op = msg[0]
            if op == "exit":
                break
            if op == "bind":
                _, eid, spec, shapes = msg
                params = mesh.broadcast_params(shapes)
                cores[eid] = EngineCore(
                    params, spec["cfg"], spec["scheme"], buckets=spec["buckets"],
                    kernels=spec["kernels"], keep_distogram=spec["keep_distogram"],
                    mesh=mesh, shard_threshold=spec["shard_threshold"],
                    inflight_depth=spec["inflight_depth"], device=mesh.device,
                    worker=True)
                mesh.engines.add(eid)
            elif op == "build":
                cores[msg[1]].worker_launch(msg[2], None)
            elif op == "run":
                cores[msg[1]].worker_launch(msg[2], msg[3])
            elif op == "close":
                cores.pop(msg[1]).close()
                mesh.engines.discard(msg[1])
            elif op == "stats":
                mesh.gather_stats(msg[1])
            else:
                raise ValueError(f"unknown mesh command {op!r}")
    except BaseException:
        traceback.print_exc()
        os._exit(1)
    for core in cores.values():
        core.close()
    mesh.leave()


def _first_leaf(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
    elif isinstance(tree, torch.Tensor):
        return tree
    return None


class FoldEngine:
    """Legacy blocking surface: ``submit() -> int`` / ``step()`` / ``run()``,
    a thin wrapper over ``FoldClient`` (one code path, identical results)."""

    def __init__(self, params, cfg, scheme: QuantScheme | str | None = None, *,
                 buckets: tuple[int, ...] | None = None,
                 max_tokens_per_batch: int = 1024, max_batch: int = 8,
                 mem_budget_mb: float | None = None,
                 fidelity: bool = False, kernels: str = dispatch.AUTO,
                 keep_distogram: bool = True,
                 mesh=None, shard_threshold: int | None = None,
                 chunk_size: int | str | None = None,
                 inflight_depth: int = 2, linger_ms: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        from repro_torch.serving.client import FoldClient
        self.client = FoldClient(
            params, cfg, scheme, buckets=buckets,
            max_tokens_per_batch=max_tokens_per_batch, max_batch=max_batch,
            mem_budget_mb=mem_budget_mb, fidelity=fidelity, kernels=kernels,
            keep_distogram=keep_distogram, mesh=mesh,
            shard_threshold=shard_threshold, chunk_size=chunk_size,
            inflight_depth=inflight_depth,
            linger_ms=linger_ms, clock=clock, device=device)
        self.core = self.client.core

    # -- delegated state ---------------------------------------------------
    params = property(lambda self: self.core.params)
    cfg = property(lambda self: self.core.cfg)
    scheme = property(lambda self: self.core.scheme)
    buckets = property(lambda self: self.core.buckets)
    kernels = property(lambda self: self.core.kernels)
    fidelity = property(lambda self: self.core.fidelity)
    admission = property(lambda self: self.core.admission)
    placement = property(lambda self: self.core.placement)
    chunk = property(lambda self: self.core.chunk)
    scheduler = property(lambda self: self.client.scheduler)
    metrics = property(lambda self: self.core.metrics)
    compile_count = property(lambda self: self.core.compile_count)

    def bucket_for(self, length: int) -> int | None:
        return self.core.bucket_for(length)

    def batch_for_bucket(self, bucket: int) -> int:
        return self.core.batch_for_bucket(bucket)

    def warmup(self, ladder: tuple[int, ...] | None = None) -> None:
        self.core.warmup(ladder)

    def submit(self, seq) -> int:
        """Queue a sequence (or FoldRequest); returns its request id."""
        return self.client.submit(seq).request_id

    def step(self) -> list[FoldResult]:
        """Serve the next scheduled batch; [] when the queue is empty."""
        return self.client.drive(max_batches=1)

    def drain(self) -> list[FoldResult]:
        return self.client.drive()

    def run(self, seqs, *, reset_metrics: bool = True) -> list[FoldResult]:
        """Submit a trace, drain it, return results in request order."""
        return self.client.run(seqs, reset_metrics=reset_metrics)
