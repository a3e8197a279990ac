"""Device-mesh placement for the serving tier (port of
``repro/serving/placement.py``).

Past one device's memory the paper's story continues across a mesh: shard
the pair representation over the ``model`` axis and the per-device share
of the Table-1 accounting drops by the shard count.  This module decides,
per bucket, where its executable lives:

  * buckets below ``shard_threshold`` (or with no mesh at all) stay
    ``SINGLE``: the controller's own device, the pre-mesh engine;
  * buckets at/above it are ``SHARDED``: the pair tensor's j axis split
    over ``model`` (``repro_torch.parallel.sharding.ppm_serving_rules``,
    ``PairShard``), every rank of the mesh running its shard of the same
    forward.

A ``Placement`` is part of the engine's executable-cache key and its
``label`` (``mesh:DxM``, no commas) rides ``ScheduledBatch`` /
``FoldResult.placement`` into the reports, as the reference's does.  The
admission controller reads ``PlacementPolicy.shards_for`` to price a
sharded bucket per device.

JAX drives a whole mesh from one process; torch runs one process a rank.
``ServingMesh`` is the mesh the port serves on: (data, model) ranks over a
``torch.distributed`` group, rank 0 the controller (client, scheduler,
admission, metrics), ranks > 0 workers (``serving.engine.serve_worker``).
``make_serving_mesh`` only describes it; the first client that binds it
(``bind``) joins the process group the caller initialised (``torchrun``)
or, with none, starts the other ranks itself (``launch.mesh``) over a
``file://`` rendezvous.  The reference's ``lower_sharded`` and
``place_inputs`` become ``open_engine`` (the parameters broadcast once, a
capture on every rank at a key's first use) and ``send`` (each launch's
key and inputs broadcast to the workers).

Several engines may share one mesh (a fleet's replicas under ``--listen
--mesh``, as the reference's replicas all span the same first D*M
devices): each opens its own engine id, and the mesh-wide ``lock`` makes
a command atomic with rank 0's part of it (a launch's ``send`` through
the enqueue of its replay or eager forward), so that every worker sees
the engines' commands, and the communicators their collectives, in one
order.

Routes: the CPU takes gloo.  On CUDA a mesh serves over NCCL, one card a
rank (rank r on ``cuda:r``, keys captured as CUDA graphs with their
collectives inside); NCCL refuses two ranks on one card ("Duplicate GPU
detected"), so a mesh larger than the visible cards is refused with the
reference's "needs N devices" error.  Only when asked for
(``backend="gloo"``) does a mesh put every rank on ``cuda:0`` over gloo,
each CUDA tensor staged through the host (``parallel.collectives``): that
route is eager and checks a multi-rank fold on one card.  Its ranks share
one card while admission prices one rank a device, so an engine on it
takes no memory budget.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import math
import os
import shutil
import threading
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as tr
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh as lm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import PairShard, mesh_axes

SINGLE = "single"
SHARDED = "sharded"


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one bucket's executable is captured and run."""
    kind: str                                  # SINGLE | SHARDED
    label: str                                 # cache-key + report column
    model_shards: int = 1                      # model-axis size (1 = solo)
    mesh: Any = dataclasses.field(default=None, compare=False)

    @property
    def sharded(self) -> bool:
        return self.kind == SHARDED


SINGLE_PLACEMENT = Placement(SINGLE, SINGLE)


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """``--mesh`` CLI spec 'DxM' (data x model), e.g. '2x4' or '1x8'."""
    try:
        d, m = (int(tok) for tok in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh must look like '2x4' (data x model), "
                         f"got {spec!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh axes must be positive, got {spec!r}")
    return d, m


def _torchrun_rank() -> int | None:
    """This process's rank where a launcher (``torchrun``) set the
    environment for a group not yet initialised, else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"])
    return None


def _on_card(device) -> bool:
    """Whether ``device`` (None: the card where there is one, as the entry
    points default) is a CUDA device."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def visible_ranks(device=None, backend: str | None = None) -> int:
    """Ranks a mesh may have on ``device``: the process group's world size
    (or the one a launcher set), or with no group the ranks this host can
    start (one process each, at most one a CPU core); on the card at most
    one a card, unless ``backend`` "gloo" asks for the host-staged route,
    which puts every rank on one card."""
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
    elif _torchrun_rank() is not None:
        n = int(os.environ["WORLD_SIZE"])
    else:
        n = os.cpu_count() or 1
    if _on_card(device) and backend != "gloo":
        n = min(n, torch.cuda.device_count())
    return n


def make_serving_mesh(spec: str | None, *, device=None, backend: str | None = None):
    """The (data, model) serving mesh of a CLI spec (None = no mesh,
    single-device serving) for serving on ``device`` (None: the card where
    there is one).  Raises when the spec asks for more ranks than
    ``visible_ranks``.  Nothing starts here: a client binds the mesh."""
    if spec in (None, "", "none"):
        return None
    d, m = parse_mesh_spec(spec)
    n = visible_ranks(device, backend)
    if d * m > n:
        raise ValueError(_needs(spec, d * m, n))
    return ServingMesh(d, m, backend=backend)


def _needs(spec: str, want: int, n: int) -> str:
    return (f"--mesh {spec} needs {want} devices but only {n} visible (one "
            f"process a rank: under torchrun the group's world size, else at "
            f"most one a CPU core of this host; on the card one a card, as "
            f"NCCL takes it)")


@dataclasses.dataclass
class _Leaf:
    shape: tuple
    dtype: torch.dtype


class ServingMesh:
    """A (data, model) mesh of ranks, one process each (module docstring).

    ``axis_names``/``shape`` read as a JAX mesh's do; ``device_mesh`` is the
    ``DeviceMesh`` once bound, ``pair_shard()`` this rank's place in its
    model group.  ``backend`` None picks the route from the device
    (module docstring); "gloo" asks for the host-staged route on the card."""
    axis_names = ("data", "model")

    def __init__(self, data: int, model: int, *, backend: str | None = None):
        self.shape = {"data": int(data), "model": int(model)}
        self.size = int(data) * int(model)
        self.backend = backend
        self.device_mesh = None
        self.device: torch.device | None = None
        self.rank = 0
        self.route = None                 # "gloo" | "nccl" | "gloo-host-staged"
        self._procs: list = []            # ranks this process started
        self._rendezvous_dir = None
        self._owns_group = False
        self._control = None              # gloo group carrying the commands
        self._next_engine = 0
        self.engines: set[int] = set()    # the live engines' ids on this rank
        self._cores: dict[int, object] = {}   # rank 0: the live engines by id
        self._base_bytes = 0              # allocated at the last stats reset
        #: rank 0: held from a command's send through the enqueue of its
        #: own part, so that the engines sharing the mesh take turns
        self.lock = threading.RLock()

    @property
    def label(self) -> str:
        return f"mesh:{self.shape['data']}x{self.shape['model']}"

    @property
    def bound(self) -> bool:
        return self.device_mesh is not None

    @property
    def graphs(self) -> bool:
        """Whether a sharded key may be a CUDA graph (NCCL on the card)."""
        return self.route == "nccl"

    # -- binding -----------------------------------------------------------
    def _route(self, device: torch.device) -> str:
        want = self.backend
        if device.type != "cuda":
            if want not in (None, "gloo"):
                raise ValueError(f"a CPU mesh runs over gloo, not {want!r}")
            return "gloo"
        if want == "gloo":
            return "gloo-host-staged"
        if want not in (None, "nccl"):
            raise ValueError(f"a mesh on the card runs over nccl or gloo, not {want!r}")
        cards = torch.cuda.device_count()
        if self.size > cards:
            raise ValueError(_needs(self.label.removeprefix("mesh:"), self.size, cards))
        return "nccl"

    def colocated_on(self, device) -> bool:
        """Whether binding on ``device`` puts several ranks on one card
        (the host-staged route)."""
        return self.size > 1 and self._route(torch.device(device)) == "gloo-host-staged"

    def rank_device(self, device: torch.device, rank: int) -> torch.device:
        if device.type != "cuda":
            return torch.device("cpu")
        return torch.device("cuda", rank if self.route == "nccl" else 0)

    def bind(self, device) -> "ServingMesh":
        """Join (or, with no process group, start) the mesh's ranks on
        ``device``'s type; this process is rank 0 when it starts them.
        Idempotent."""
        device = torch.device(device)
        if self.bound:
            if device.type != self.device.type:
                raise ValueError(f"{self.label} is bound on {self.device}, not {device}")
            return self
        self.route = self._route(device)
        if not dist.is_initialized() and _torchrun_rank() is not None:
            lm.init_group(self, _torchrun_rank(), "env://", device)
        if not dist.is_initialized():
            self._rendezvous_dir, init = lm.rendezvous()
            self._procs = lm.start_ranks(self, device, init)
            self._owns_group = True
            lm.init_group(self, 0, init, device)
            atexit.register(self.close)
        elif dist.get_world_size() != self.size:
            raise ValueError(f"{self.label} needs exactly {self.size} ranks; the "
                             f"process group has {dist.get_world_size()}")
        self._setup(device)
        return self

    def _setup(self, device: torch.device) -> None:
        """This rank's device, the ``DeviceMesh``, the command group."""
        self.rank = dist.get_rank()
        self.device = self.rank_device(device, self.rank)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.device_mesh = lm.make_mesh((self.shape["data"], self.shape["model"]),
                                     self.axis_names, device_type=self.device.type)
        # commands travel over gloo on the host whatever the compute route,
        # with no timeout that an idle server could reach
        self._control = dist.new_group(backend="gloo",
                                       timeout=datetime.timedelta(days=7))
        # one eager collective initialises the compute communicator before
        # any capture (NCCL must not initialise inside a graph)
        coll.all_reduce(torch.zeros(1, device=self.device), "sum",
                        self.device_mesh.get_group("model"))

    def pair_shard(self) -> PairShard:
        dm = self.device_mesh
        return PairShard(dm.get_group("model"), self.shape["model"],
                         dm.get_local_rank("model"))

    # -- the command channel (rank 0 -> every rank) ------------------------
    def send(self, msg) -> None:
        with self.lock:
            dist.broadcast_object_list([msg], src=0, group=self._control,
                                       device=torch.device("cpu"))

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self._control,
                                   device=torch.device("cpu"))
        return box[0]

    def open_engine(self, core, spec: dict) -> int:
        """Rank 0: have every worker build an engine like ``core`` (``spec``:
        its constructor's arguments) and broadcast the parameters once;
        returns the engine's id on the mesh."""
        shapes = tr.tree_map(lambda t: _Leaf(tuple(t.shape), t.dtype), core.params)
        with self.lock:
            eid = self._next_engine
            self._next_engine += 1
            self.send(("bind", eid, spec, shapes))
            self.broadcast_params(core.params)
            self.engines.add(eid)
            self._cores[eid] = core
        return eid

    def close_engine(self, eid: int) -> None:
        """Rank 0: have every worker close engine ``eid`` (the mesh stays)."""
        with self.lock:
            self.send(("close", eid))
            self.engines.discard(eid)
            self._cores.pop(eid, None)

    def broadcast_params(self, params):
        """Rank 0 sends ``params``; a worker passes the ``_Leaf`` tree it
        received and gets the tensors on its device."""
        flat = tr.leaves(params)
        if self.rank != 0:
            flat = [torch.empty(leaf.shape, dtype=leaf.dtype, device=self.device)
                    for leaf in flat]
        for t in flat:
            coll.broadcast(t, 0)
        return tr.unflatten(params, flat)

    # -- per-rank readings --------------------------------------------------
    def local_stats(self, reset: bool = False) -> dict:
        """This rank's counters since the last reset: kernel launches and
        plain calls by variant, collectives by name, the pair shard the
        trunk last pinned, the live engines' ids, and on the card the peak
        allocated above what was allocated at the reset.  ``reset`` zeroes
        the counters after reading."""
        out = {"rank": self.rank, "engines": sorted(self.engines),
               "launches": dispatch.launch_counts(),
               "routes": dict(dispatch.counters),
               "plain": dispatch.plain_counts(), "collectives": coll.counts(),
               "pair": sh.PINNED.get("pair"), "peak_bytes": None}
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            out["peak_bytes"] = (torch.cuda.max_memory_allocated(self.device)
                                 - self._base_bytes)
        if reset:
            dispatch.reset_counters()
            coll.reset_counts()
            sh.PINNED.clear()
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
                self._base_bytes = torch.cuda.memory_allocated(self.device)
        return out

    def rank_stats(self, reset: bool = False) -> list[dict]:
        """Rank 0: every rank's ``local_stats``, in rank order."""
        with self.lock:
            self.send(("stats", reset))
            return self.gather_stats(reset)

    def gather_stats(self, reset: bool) -> list[dict] | None:
        mine = self.local_stats(reset)
        box = [None] * self.size if self.rank == 0 else None
        dist.gather_object(mine, box, dst=0, group=self._control)
        return box

    # -- teardown ----------------------------------------------------------
    def leave(self) -> None:
        """Every rank, at ``exit``: meet the others once all have left their
        loops, so that each then tears its groups down with the others
        (NCCL finalises a communicator with its peers)."""
        dist.monitored_barrier(group=self._control,
                               timeout=datetime.timedelta(seconds=60))

    def close(self) -> None:
        """Rank 0: close every engine still open on the mesh (its graphs
        here and on every worker: NCCL waits forever to tear down a
        communicator that live graphs captured), stop the workers (they
        leave their loop), leave the process group it made and wait for
        the ranks it started."""
        if not self.bound or self.rank != 0:
            return
        try:
            for core in list(self._cores.values()):
                core.close(discard_inflight=True)
            with self.lock:
                self.send(("exit",))
                self.leave()
        finally:
            self.device_mesh = None
            if self._owns_group and dist.is_initialized():
                dist.destroy_process_group()
            lm.stop_ranks(self._procs)
            self._procs = []
            if self._rendezvous_dir is not None:
                shutil.rmtree(self._rendezvous_dir, ignore_errors=True)

    def describe(self) -> dict:
        return {"mesh": self.label, "ranks": self.size, "route": self.route,
                "device": None if self.device is None else str(self.device)}


class PlacementPolicy:
    """bucket -> Placement.  Both of mesh/shard_threshold set = sharded
    tier active; both None = everything single-device.  Exactly one set is
    a configuration error: a mesh nothing routes to (or a threshold with
    nowhere to shard) would serve everything single-device while the
    operator believes otherwise."""

    def __init__(self, mesh=None, shard_threshold: int | None = None):
        if (mesh is None) != (shard_threshold is None):
            raise ValueError(
                "mesh and shard_threshold must be set together: a mesh "
                "without a threshold (or vice versa) shards nothing")
        self.mesh = mesh
        self.shard_threshold = shard_threshold
        if mesh is not None:
            if "model" not in mesh.axis_names:
                raise ValueError(f"serving mesh needs a 'model' axis, "
                                 f"got {mesh.axis_names}")
            axes = mesh_axes(mesh)
            self._model = axes["model"]
            data = math.prod(axes.values()) // self._model
            self._sharded = Placement(SHARDED, f"mesh:{data}x{self._model}",
                                      self._model, mesh)

    def placement_for(self, bucket: int) -> Placement:
        if (self.mesh is None or self.shard_threshold is None
                or bucket < self.shard_threshold):
            return SINGLE_PLACEMENT
        if bucket % self._model != 0:
            # an undividable bucket would replicate anyway (the rules are
            # divisibility-guarded); keep it honestly single-device
            return SINGLE_PLACEMENT
        return self._sharded

    def shards_for(self, bucket: int) -> int:
        """Model-axis shard count admission divides per-device bytes by."""
        return self.placement_for(bucket).model_shards

    def label_for(self, bucket: int) -> str:
        return self.placement_for(bucket).label

    def describe(self) -> dict:
        """Run-level placement facts for trace metadata / provenance."""
        out: dict[str, Any] = {"shard_threshold": self.shard_threshold}
        if self.mesh is None:
            out.update(mesh=None, model_shards=1)
        else:
            out.update(mesh="x".join(f"{n}{a[0]}" for a, n in mesh_axes(self.mesh).items()),
                       model_shards=self._model)
        return out
