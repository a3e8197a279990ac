"""Per-device FLOPs, bytes, collective traffic and peak memory of one step,
traced on fake tensors, and its roofline terms (the port's counterpart of
``repro/launch/hlo_analysis.py``).

The reference compiles each step with XLA and parses the optimized
per-device HLO: FLOPs of every dot, the HBM bytes of every top-level op,
collectives with ring traffic factors, and loop trip counts read from each
while-loop's condition, since XLA's own cost analysis counts a loop body
once.  The port has no HLO to read: its steps run eagerly, op by op.  So
``CostMode`` (a ``TorchDispatchMode``) watches the ops rank 0 would run,
on fake tensors (``FakeTensorMode``: shapes, no memory) under a fake
process group, and counts them as they pass.  An eager Python loop is
unrolled as it runs, so no trip count is needed.

What is counted, per device (rank 0's local tensors; a DTensor op is let
through to DTensor, whose local ops and redistributions come back to the
mode one by one):

  * FLOPs: ``torch.utils.flop_counter``'s formulas (the products, as
    ``FlopCounterMode`` counts them, and as the reference counts dots);
  * bytes: the inputs and outputs of every op that computes something,
    view and metadata ops skipped as the reference skips its plumbing ops.
    Nothing is fused, so this is an upper bound on HBM traffic;
  * collectives by kind, with the reference's ring traffic factors:
        all-reduce 2(g-1)/g | all-gather (g-1)/g (result) |
        reduce-scatter (g-1) (result) | all-to-all (g-1)/g | permute 1
    (DTensor's functional collectives and the port's explicit ones; a
    broadcast or gather moves (g-1)/g of its result, as an all-gather);
  * the peak of live bytes: every storage an op makes is held until it is
    freed (a finalizer on the storage), the step's inputs from the start;
    apart, as a diagnostic (not a key of the record), the largest storage
    an op made and that op (``largest``);
  * apart, the bytes of the float32 copies ``common.matmul_f32`` makes of
    bf16 operands where a product cannot keep them bf16 (a DTensor, or the
    CPU): the card's product reads them as bf16, so these copies, the
    casts' traffic and the products' wider reads are in the bytes and the
    peak above but would not be on the card at one device.

DTensor propagates an op's sharding on fake tensors of the GLOBAL shapes
(``empty_strided`` placeholders, only on a cache miss); those ops are not
rank 0's work, so they and whatever they make are not counted.

Hardware constants: the H100 SXM, 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
450 GB/s NVLink a direction (the card's data sheet).
A mesh axis wider than the 8-card NVLink domain (the production mesh's 16)
crosses slower links, so there ``t_collective`` is a lower bound.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.parallel import sharding as sh

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute", "broadcast", "gather")

#: collective ops by name (DTensor's functional ones, the ``c10d`` ops
#: ``torch.distributed`` calls) -> kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "gather_": "gather",
}

#: ops that move no data: metadata, placeholders, a collective's wait
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
             "device", "wait_tensor", "lift_fresh", "_local_scalar_dense", "is_same_size",
             "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "dim"}


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_size(args) -> int:
    """The size of the process group a collective op runs over (its
    ``group_name`` string, or its ``ProcessGroup`` argument)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    return 1


def ring_traffic(kind: str, size: float, g: int) -> float:
    """Bytes a device moves for one collective of ``size`` result bytes
    over a group of ``g`` (the reference's factors)."""
    return {"all-reduce": 2.0 * (g - 1) / g * size,
            "all-gather": (g - 1) / g * size,
            "broadcast": (g - 1) / g * size,      # a root's copy to the others
            "gather": (g - 1) / g * size,
            "reduce-scatter": (g - 1) * size,
            "all-to-all": (g - 1) / g * size,
            "collective-permute": size}[kind]


@dataclasses.dataclass
class ModuleCost:
    """One step's per-device counts (the reference's ``ModuleCost``)."""
    flops: float
    bytes: float
    coll: dict[str, float]
    coll_counts: dict[str, float]
    loops: list[tuple[str, int]]

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


class CostMode(TorchDispatchMode):
    """Counts the local ops that pass (module docstring).  ``track(tree)``
    registers the step's inputs as held from the start; ``mem`` then
    reads the step's argument, output, alias and temporary bytes and its
    peak, once ``outputs(tree)`` has named what the step returned."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        #: the FLOPs by aten op (``overload packet`` name)
        self.flops_by_op: dict[str, float] = {}
        self.bytes = 0.0
        #: the float32 copies of bf16 product operands (module docstring)
        self.widen_bytes = 0.0
        self.coll: dict[str, float] = {}
        self.coll_counts: dict[str, float] = {}
        self.ops = 0
        self._live: dict[int, int] = {}        # storage key -> bytes held
        self._args: dict[int, int] = {}
        #: DTensor's global-shape placeholders and what is made from them
        self._shadow = WeakIdKeyDictionary()
        self.live = 0
        self.peak = 0
        self._out: dict[int, int] = {}
        #: the largest storage an op made (the step's inputs aside): (bytes,
        #: the op, the shape and dtype of the tensor it made), or None
        self.largest: tuple[int, str, tuple, str] | None = None

    # -- storages ------------------------------------------------------------
    def _hold(self, t: torch.Tensor, op: str = "input") -> int | None:
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None
        key = s._cdata
        if key not in self._live:
            n = s.nbytes()
            self._live[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            if op != "input" and (self.largest is None or n > self.largest[0]):
                self.largest = (n, op, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            weakref.finalize(s, self._free, key)
        return key

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def track(self, tree) -> None:
        for t in _tensors(tree):
            t = getattr(t, "_local_tensor", t)
            key = self._hold(t)
            if key is not None:
                self._args[key] = self._live[key]

    def outputs(self, tree) -> None:
        for t in _tensors(tree):
            t = getattr(t, "_local_tensor", t)
            key = self._hold(t)
            if key is not None:
                self._out[key] = self._live.get(key, _nbytes(t))

    @property
    def mem(self) -> dict[str, int]:
        arg = sum(self._args.values())
        out = sum(self._out.values())
        alias = sum(n for k, n in self._out.items() if k in self._args)
        return {"argument_bytes_per_dev": arg, "output_bytes_per_dev": out,
                "temp_bytes_per_dev": max(self.peak - arg - (out - alias), 0),
                "alias_bytes_per_dev": alias, "peak_bytes_per_dev": self.peak}

    def cost(self) -> ModuleCost:
        return ModuleCost(self.flops, self.bytes, dict(self.coll), dict(self.coll_counts), [])

    # -- the ops -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if DTensor in types:
            return NotImplemented           # DTensor's local ops come back here
        from torch.utils.flop_counter import flop_registry
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            # a composite op (matmul, einsum, ... under inference mode) as the
            # ops it runs, as FlopCounterMode takes it
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        ins = _tensors(args) + _tensors(kwargs)
        name = func._schema.name.split("::")[-1]
        if any(t in self._shadow for t in ins) or (name == "empty_strided" and not ins):
            out = func(*args, **kwargs)       # DTensor's sharding propagation
            for t in _tensors(out):
                self._shadow[t] = True
            return out
        out = func(*args, **kwargs)
        self.ops += 1
        outs = _tensors(out)
        for t in outs:
            self._hold(t, name)
        if sh.widening_now():
            self.widen_bytes += sum(_nbytes(t) for t in outs)
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + f
        kind = _COLLECTIVES.get(name) if func.namespace in ("_c10d_functional", "c10d") \
            else None
        if kind is not None:
            size = float(sum(_nbytes(t) for t in (outs or ins)))
            g = _group_size(list(args) + list(kwargs.values()))
            if g > 1 or kind == "collective-permute":
                self.coll[kind] = self.coll.get(kind, 0.0) + ring_traffic(kind, size, g)
                self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            self.bytes += size + sum(_nbytes(t) for t in ins)
        elif name not in _NO_BYTES and not _is_view(func):
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


# --------------------------------------------------------------------------
# roofline (the reference's, with the card's constants)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    flops_global: float
    bytes_global: float
    coll_bytes_global: float
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float = 0.0

    @property
    def t_total(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """time the useful math would take at peak / time the binding
        roofline term takes = achievable MFU given this lowering."""
        if self.t_total <= 0 or self.model_flops <= 0:
            return 0.0
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / self.t_total


def roofline_from_module(mc: ModuleCost, chips: int, model_flops: float = 0.0,
                         links_per_chip: float = 1.0) -> Roofline:
    fl = mc.flops * chips
    by = mc.bytes * chips
    cb = mc.coll_bytes * chips
    t_c = fl / (chips * PEAK_FLOPS)
    t_m = by / (chips * HBM_BW)
    t_l = cb / (chips * LINK_BW * links_per_chip)
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    return Roofline(fl, by, cb, chips, t_c, t_m, t_l,
                    bottleneck=max(terms, key=terms.get), model_flops=model_flops)


def model_flops_estimate(n_params: float, tokens: float, step: str,
                         n_active: float | None = None) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference); MoE uses N_active."""
    n = n_active if n_active is not None else n_params
    return (6.0 if step == "train" else 2.0) * n * tokens


def count_params(tree) -> int:
    """Elements of every tensor leaf (a scalar counts 1)."""
    return sum(math.prod(t.shape) if t.dim() else 1 for t in _tensors(tree))
