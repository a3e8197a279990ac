"""Logical-axis sharding for the serving tier (port of the serving half of
``repro/parallel/sharding.py``: ``data_axes``, ``_axis_size``, ``_maybe``,
the activation-rule scope and the PPM specs).

The specs are framework-free arithmetic: ``P`` is a tuple with one entry a
tensor dim (an axis name, a tuple of axis names, or ``None`` for
replicated), normalised as JAX normalises ``PartitionSpec`` (a one-name
tuple is the name), so a spec here equals the reference's for the same
mesh shape entry for entry.  A mesh is anything with ``axis_names`` and a
``shape`` mapping axis -> size (the serving tier's ``ServingMesh``), or a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and a
shape tuple).

GSPMD reads the reference's specs and partitions implicitly.  The port
shards explicitly: ``PairShard`` is the runtime form of the one rule the
serving tier uses, ``ppm_serving_rules``' "the pair tensor (B, i, j, Hz)
is split on j over ``model``".  Each rank of the model group holds
``z[:, :, j0:j1]``; the ops that need more issue the collectives of
``repro_torch.parallel.collectives`` through its methods, and
``constrain(z, "pair")`` at every block boundary checks that the tensor is
still the rank's shard (the port's pin where the reference's pins the
sharding for GSPMD).

The training half (``param_spec`` through ``opt_state_shardings``) keeps
the reference's rules as ``P`` specs; ``placements(spec, mesh)`` turns a
spec into DTensor placements on a ``DeviceMesh`` (``Shard(d)`` on each mesh
dim that tensor dim ``d`` names, else ``Replicate()``), and ``constrain``
redistributes a DTensor to its rule's placements, the counterpart of
``jax.lax.with_sharding_constraint``.  The port keeps a model's layers as a
list (``blocks.3.attn.q.w``) where the reference stacks them
(``blocks.attn.q.w`` with a leading layer axis), so ``param_shardings``
applies a rule to a leaf as it is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import sys
import threading
from typing import Any

import torch

from repro_torch.parallel import collectives as coll

DATA = "data"            # logical data axis (("pod", "data") on a multi-pod mesh)
MODEL = "model"


class P(tuple):
    """A partition spec: one entry a dim, ``None`` = replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else (tuple(e) if isinstance(e, list) else e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> dict[str, int]:
    """axis name -> size, for a ``ServingMesh``-like object or a
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    axes = mesh_axes(mesh)
    if isinstance(axis, (tuple, list)):
        return math.prod(axes[a] for a in axis)
    return axes[axis]


def data_axes(mesh):
    """The composite data-parallel axis for this mesh."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def _maybe(mesh, dim: int, axis):
    """axis if dim divides its size, else None (replicate)."""
    return axis if dim % _axis_size(mesh, axis) == 0 and dim > 0 else None


class AbstractMesh:
    """Axis names and sizes without ranks (``jax.sharding.AbstractMesh``):
    rule evaluation for a mesh that is not there, e.g. the 16 x 16 pod."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------
_COL = r"(\.q|\.k|\.v|\.up|\.gate|\.in_x|\.in_gate|\.kv_down|\.k_up|\.v_up|\.in_proj|\.qkv|\.a_proj|\.a_gate|\.b_proj|\.b_gate|\.left|\.right|\.coord|\.bias|\.pair_bias)\.w$"
_ROW = r"(\.o|\.down|\.out|\.out_proj|\.out_gate)\.w$"

FSDP_THRESHOLD = 4 * 1024 * 1024   # elements; from this size, 2-axis sharding


def param_spec(path: str, shape: tuple[int, ...], mesh, cfg=None) -> P:
    """The spec of one parameter, by path regex.

    Big weights (``FSDP_THRESHOLD`` elements or more) also shard their
    second dim over the data axis (2-D weight sharding / FSDP); the
    ops that use them gather it.  Every entry is divisibility-guarded: a
    dim the axis does not divide is replicated."""
    mdl = MODEL
    big = math.prod(shape) >= FSDP_THRESHOLD if shape else False
    fs = data_axes(mesh) if big else None

    def fsd(dim):   # fsdp axis, divisibility-guarded
        return _maybe(mesh, dim, fs) if fs else None

    # --- MoE expert banks: (E, din, dout) --------------------------------
    if re.search(r"experts\..*\.w$", path) and len(shape) == 3:
        e, din, dout = shape
        if e % _axis_size(mesh, mdl) == 0:
            return P(mdl, fsd(din), None)              # EP + fsdp
        if re.search(r"\.down\.w$", path):
            return P(None, _maybe(mesh, din, mdl), fsd(dout))
        return P(None, fsd(din), _maybe(mesh, dout, mdl))  # TP inside expert
    if re.search(r"router\.w$", path):
        return P(None, None)
    # --- embeddings -------------------------------------------------------
    if re.search(r"embed\.e$", path):
        return P(_maybe(mesh, shape[0], mdl), fsd(shape[1]))   # vocab-sharded
    if re.search(r"(relpos|pos_dec)\.e$", path):
        return P(None, None)
    if re.search(r"lm_head\.w$", path):
        return P(fsd(shape[0]), _maybe(mesh, shape[-1], mdl))
    # --- column/row parallel linears ---------------------------------------
    if re.search(_COL, path) and len(shape) == 2:
        return P(fsd(shape[0]), _maybe(mesh, shape[1], mdl))
    if re.search(_ROW, path) and len(shape) == 2:
        return P(_maybe(mesh, shape[0], mdl), fsd(shape[1]))
    # --- conv / per-channel vectors ----------------------------------------
    if re.search(r"conv_w$", path) and len(shape) == 2:
        return P(None, _maybe(mesh, shape[1], mdl))
    if re.search(r"(conv_b|lam)$", path) and len(shape) == 1:
        return P(_maybe(mesh, shape[0], mdl))
    if len(shape) == 2 and big:
        return P(fsd(shape[0]), _maybe(mesh, shape[1], mdl))
    # everything else (norms, biases, scalars): replicated
    return P(*([None] * len(shape)))


def _path_str(path) -> str:
    """A tree path (dict keys and list indices) as ``a.0.b``."""
    return ".".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(param_tree, mesh, cfg=None):
    """The spec tree of ``param_tree`` (tensors, or anything with
    ``shape``).  The port's layers are list entries (``blocks.3.…``), so a
    rule applies to each leaf as it is: the reference's stacked leaves
    carry a leading layer axis that no rule shards."""
    return _map_with_path(
        lambda path, leaf: param_spec(_path_str(path), tuple(leaf.shape), mesh, cfg),
        param_tree)


def param_shardings(param_tree, mesh, cfg=None):
    """``NamedSharding`` tree matching ``param_tree``."""
    return to_shardings(mesh, param_specs(param_tree, mesh, cfg))


# --------------------------------------------------------------------------
# step-input rules
# --------------------------------------------------------------------------
def batch_specs(cfg, shape, mesh, quantized_kv: bool = False) -> Any:
    """Specs for the input pytree of this cell (``configs.ShapeSpec``)."""
    dp = data_axes(mesh)
    b = shape.global_batch
    dp_ok = dp if b % _axis_size(mesh, dp) == 0 else _maybe(mesh, b, "data")

    def tok():
        return P(dp_ok, None)

    def with_inputs(batch):
        if cfg.kind == "vlm":
            batch["image_embeds"] = P(dp_ok, None, None)
        if cfg.kind == "encdec":
            batch["audio_frames"] = P(dp_ok, None, None)
        return {"batch": batch}

    if shape.step == "train":
        return with_inputs({"tokens": tok(), "labels": tok()})
    if shape.step == "prefill":
        return with_inputs({"tokens": tok()})
    if shape.step == "decode":
        return {"batch": {"tokens": tok()},
                "cache": cache_specs(cfg, shape, mesh, quantized_kv=quantized_kv)}
    raise ValueError(shape.step)


def cache_specs(cfg, shape, mesh, quantized_kv: bool = False):
    """Specs for the decode cache pytree (leading layer axis)."""
    dp = data_axes(mesh)
    b = shape.global_batch
    bd = dp if b % _axis_size(mesh, dp) == 0 else None
    mdl_sz = _axis_size(mesh, MODEL)

    def kv_spec(n_kv: int, hd: int, seq_shardable: bool):
        if n_kv % mdl_sz == 0:
            return P(None, bd, None, MODEL, None)
        if hd % mdl_sz == 0:
            return P(None, bd, None, None, MODEL)
        if seq_shardable:
            return P(None, bd, MODEL, None, None)
        return P(None, bd, None, None, None)

    if cfg.kind in ("dense", "vlm") or (cfg.kind == "moe" and not cfg.mla):
        spec = kv_spec(cfg.n_kv_heads, cfg.hd, True)
        out = {"k": spec, "v": spec, "pos": P()}
        if quantized_kv:
            sspec = P(*spec[:-1], None)     # scales: no head-dim sharding
            out["k_scale"] = sspec
            out["v_scale"] = sspec
        return out
    if cfg.kind == "moe" and cfg.mla:
        r = cfg.mla.kv_lora_rank
        return {"latent": P(None, bd, None, _maybe(mesh, r, MODEL)),
                "k_rope": P(None, bd, None, None),
                "pos": P()}
    if cfg.kind == "ssm":
        d_inner = cfg.ssm.expand * cfg.d_model
        nh = d_inner // cfg.ssm.head_dim
        conv_dim = d_inner + 2 * cfg.ssm.d_state
        return {"state": P(None, bd, _maybe(mesh, nh, MODEL), None, None),
                "conv": P(None, bd, None, _maybe(mesh, conv_dim, MODEL)),
                "pos": P()}
    if cfg.kind == "hybrid":
        w = cfg.hybrid.lru_width or cfg.d_model
        rec = {"state": P(None, bd, _maybe(mesh, w, MODEL)),
               "conv": P(None, bd, None, _maybe(mesh, w, MODEL))}
        attn = {"k": P(None, bd, None, None, _maybe(mesh, cfg.hd, MODEL)),
                "v": P(None, bd, None, None, _maybe(mesh, cfg.hd, MODEL))}
        period = {f"b{j}": (attn if j == cfg.hybrid.attn_every - 1 else rec)
                  for j in range(cfg.hybrid.attn_every)}
        tail = cfg.layers % cfg.hybrid.attn_every     # hybrid._n_periods_tail
        tail_spec = [{"state": P(bd, _maybe(mesh, w, MODEL)),
                      "conv": P(bd, None, _maybe(mesh, w, MODEL))}
                     for _ in range(tail)]
        return {"periods": period, "tail": tail_spec, "pos": P()}
    if cfg.kind == "encdec":
        return {"k": kv_spec(cfg.n_kv_heads, cfg.hd, True),
                "v": kv_spec(cfg.n_kv_heads, cfg.hd, True),
                "enc_out": P(bd, None, _maybe(mesh, cfg.d_model, MODEL)),
                "pos": P()}
    raise ValueError(cfg.kind)


# --------------------------------------------------------------------------
# activation rules (context-scoped; models stay mesh-agnostic)
# --------------------------------------------------------------------------
_ACT = threading.local()


@contextlib.contextmanager
def act_rules(rules: dict[str, P] | None):
    """Scope a dict of named activation specs; models call
    ``constrain(x, name)`` at layer boundaries."""
    prev = getattr(_ACT, "rules", None)
    _ACT.rules = rules
    try:
        yield
    finally:
        _ACT.rules = prev


def rule_value(name: str, default=None):
    """Non-spec configuration riding the act-rules scope."""
    rules = getattr(_ACT, "rules", None)
    if rules and name in rules:
        return rules[name]
    return default


#: name -> the shape ``constrain`` last pinned under it (this process)
PINNED: dict[str, tuple] = {}


def constrain(x, name: str):
    """Pin ``x`` to the spec the active rules give ``name``.

    A DTensor is redistributed to the rule's placements on its own mesh
    (``jax.lax.with_sharding_constraint``), a dim that its axes do not
    divide replicated.  Inside a ``sharded`` scope
    (the serving tier's j-split pair tensor) every dim the spec puts on
    ``model`` must hold the rank's share (n / size) of the scope's pair
    length: raises where it does not; ``x`` itself passes through (the
    port's tensors are the shards, nothing is moved) and its shape is
    kept in ``PINNED``.  Anything else passes through."""
    rules = getattr(_ACT, "rules", None)
    if not rules or name not in rules:
        return x
    if is_dtensor(x):
        mesh = x.device_mesh
        # GSPMD pads a dim its axes do not divide; DTensor's uneven shards
        # (and a sharded dim of size 1) break the reshapes after them, so
        # such a dim is replicated (the same values, laid out otherwise)
        spec = P(*(e if e is None or (x.shape[d] > 1 and x.shape[d] % _axis_size(mesh, e) == 0)
                   else None for d, e in enumerate(rules[name])))
        return redistribute(x, placements(spec, mesh))
    scope = getattr(_ACT, "shard", None)
    if scope is None:
        return x
    shard, n = scope
    for dim, entry in enumerate(rules[name]):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if MODEL in axes and x.shape[dim] != n // shard.size:
            raise ValueError(f"constrain({name!r}): dim {dim} holds {x.shape[dim]}, "
                             f"the rank's shard is {n // shard.size} of {n}")
    PINNED[name] = tuple(x.shape)
    return x


def default_act_rules(mesh, step: str, cfg=None) -> dict[str, P]:
    """Sequence-parallel residuals for train/prefill; nothing for decode.

    MoE inner tensors: with n_experts % |model| == 0 the expert dim rides
    the model axis (EP); otherwise tokens ride data and the FFN hidden
    rides model (TP inside the expert), with xe/ye 2-axis sharded (groups
    x d_model)."""
    dp = data_axes(mesh)
    rules = {"logits": P(dp, None, MODEL),
             "pair": P(None, dp, MODEL, None),       # PPM (B, i, j, Hz)
             "seq_track": P(None, dp, None)}         # PPM (B, N, Hm)
    if step in ("train", "prefill"):
        rules["residual"] = P(dp, MODEL, None)       # (B, S, D): seq over model
    if cfg is not None and getattr(cfg, "moe", None):
        ep = cfg.moe.n_experts % _axis_size(mesh, MODEL) == 0
        if ep:
            rules["moe_tokens"] = P(dp, None, None)
            rules["moe_xe"] = P(dp, MODEL, None, None)       # experts on model
            rules["moe_hidden"] = P(MODEL, dp, None)         # (E, ng*C, f)
        else:
            rules["moe_tokens"] = P(dp, None, MODEL)
            rules["moe_xe"] = P(dp, None, None, MODEL)       # d_model on model
            rules["moe_hidden"] = P(None, dp, MODEL)         # f on model
    return rules


# --------------------------------------------------------------------------
# specs as DTensor placements
# --------------------------------------------------------------------------
def is_dtensor(x) -> bool:
    """Is ``x`` a DTensor?  (None exists before ``torch.distributed.tensor``
    is imported, so a process that never imports it never pays for it.)"""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: for each mesh
    dim, ``Shard(d)`` where tensor dim ``d`` names it, else
    ``Replicate()``.  A dim that names several axes (``("pod", "data")``)
    shards over them in the mesh's order, outer first, as JAX does; an
    entry that names them in another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} named twice")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``); ``placements`` on
    a ``DeviceMesh``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def to_shardings(mesh, spec_tree):
    """``NamedSharding`` for every ``P`` of ``spec_tree``."""
    return _map_with_path(lambda _, s: NamedSharding(mesh, s), spec_tree)


def opt_state_shardings(param_sh, mesh):
    """AdamW moments shard exactly like their parameters (ZeRO-by-TP)."""
    return {"m": param_sh, "v": param_sh, "step": NamedSharding(mesh, P())}


#: redistributions around ops DTensor cannot shard as they come, by op:
#: ``local:<op>`` (``on_local``/``on_rows``) and ``fold`` (``foldable``)
REDISTRIBUTED: dict[str, int] = {}


def _note(kind: str) -> None:
    REDISTRIBUTED[kind] = REDISTRIBUTED.get(kind, 0) + 1


def mixed_ops(tree):
    """A scope where plain tensors meet DTensors as replicated ones
    (``implicit_replication``) when ``tree`` holds a DTensor; nothing
    otherwise."""
    from repro_torch.tree import leaves
    if any(is_dtensor(t) for t in leaves(tree)):
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def to_global(x):
    """A DTensor's whole value on every rank (``full_tensor``); anything
    else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def to_local(x):
    """A DTensor's local shard (a replicated one's whole value); anything
    else as it is."""
    return x.to_local() if is_dtensor(x) else x


def unsharded_dim(x, dim: int) -> bool:
    """Is no mesh dim sharding tensor dim ``dim`` of the DTensor ``x``?"""
    from torch.distributed.tensor import Shard
    return not any(isinstance(p, Shard) and p.dim == dim for p in x.placements)


def redistribute(x, to: tuple):
    """``x`` (a DTensor) with ``to`` placements (itself where it has them)."""
    if tuple(x.placements) == tuple(to):
        return x
    return x.redistribute(x.device_mesh, to)


def distribute(t, mesh, spec: P):
    """A global tensor, the same on every rank (parameters from one seed,
    the batch a pure function of the step), as a DTensor of ``spec``: each
    rank keeps its own shard, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)


def distribute_params(part, mesh, cfg=None, path: tuple = ()):
    """Each leaf of ``part`` (the part at ``path`` of a parameter tree, the
    same global tensors on every rank) as the DTensor of its
    ``param_spec``: the ``place`` of the model inits (``lm.init_params``)
    in a sharded run, so only one part is ever whole on a device."""
    return _map_with_path(lambda p, t: distribute(
        t, mesh, param_spec(_path_str(p), tuple(t.shape), mesh, cfg)), part, tuple(path))


def on_local(op: str, fn, *args, keep: tuple[int, ...] = (), n_out: int = 1):
    """``fn(*args)`` on each rank's local tensors (``local_map``), for an op
    that DTensor has no sharding rule for, or a wrong one: every DTensor
    argument is first redistributed so that only its dims in ``keep``
    stay sharded, and only where the mesh divides them (a move counted
    under ``local:<op>``); the ``n_out`` tensors ``fn`` returns come back
    as DTensors of those placements, so ``fn`` must keep the leading dims
    ``keep`` names and act on each of their entries alone.  Without a
    DTensor argument it is ``fn(*args)``."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    lead = dts[0]
    mesh = lead.device_mesh

    def even(d):   # every mesh dim that shards tensor dim d, together
        n = math.prod(mesh.size(i) for i, p in enumerate(lead.placements)
                      if isinstance(p, Shard) and p.dim == d)
        return lead.shape[d] % n == 0

    to = tuple(p if isinstance(p, Shard) and p.dim in keep and even(p.dim) else Replicate()
               for p in lead.placements)
    if any(tuple(a.placements) != to for a in dts):
        _note(f"local:{op}")
    args = [redistribute(a, to) if is_dtensor(a) else a for a in args]
    # (local_map reads a tuple as one entry an output, a list as one output's)
    run = local_map(_waited(fn), out_placements=list(to) if n_out == 1 else (list(to),) * n_out,
                    in_placements=tuple(list(to) if is_dtensor(a) else None for a in args),
                    device_mesh=mesh)
    return run(*args)


def _waited(fn):
    """``fn`` on local tensors whose collectives have completed: a
    redistribution hands back an ``AsyncCollectiveTensor``, which waits at
    its first op but not at a view, so a kernel handed its storage could
    read it before the collective has written it (``local_map`` waits in
    PyTorch 2.13, not in 2.11)."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    def run(*args):
        return fn(*(a.wait() if isinstance(a, AsyncCollectiveTensor) else a for a in args))
    return run


def foldable(x):
    """``x`` with none of its middle dims (between the first and the last)
    sharded: ``torch.matmul`` folds (B, S, D) into (B·S, D) before its
    product, which DTensor cannot do with S sharded in every PyTorch (2.11
    refuses; the reference's sequence-parallel residual is gathered before
    a linear, as GSPMD gathers it).  Anything else passes through."""
    if not is_dtensor(x) or x.dim() < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard
    to = tuple(Replicate() if isinstance(p, Shard) and 0 < p.dim < x.dim() - 1 else p
               for p in x.placements)
    if to != tuple(x.placements):
        _note("fold")
    return redistribute(x, to)


_WIDEN = threading.local()


@contextlib.contextmanager
def widening():
    """Scope the casts that widen a bf16 product's operands to float32
    where the product cannot keep them bf16 (``common.matmul_f32``), so
    that the dry-run counts those copies apart (``widening_now``)."""
    prev = getattr(_WIDEN, "on", False)
    _WIDEN.on = True
    try:
        yield
    finally:
        _WIDEN.on = prev


def widening_now() -> bool:
    return getattr(_WIDEN, "on", False)


def fold_matmul(x, w):
    """``torch.matmul(x, w)`` of a (…, K) activation and a (K, N) weight
    that DTensor can fold both ways: ``x`` made ``foldable`` first, and the
    gradient of the product handed back on the product's own placements
    (the backward folds it too, and a gradient can arrive sharded on a
    middle dim, e.g. from a sequence-parallel residual)."""
    y = torch.matmul(foldable(x), w)
    return _GradOnPlacements.apply(y) if is_dtensor(y) and y.dim() >= 3 else y


class _GradOnPlacements(torch.autograd.Function):
    """The identity; its backward redistributes the gradient to the
    forward tensor's placements (replicated where that was partial)."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate
        # a partial sum's gradient is the same on every rank: replicated
        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def embedding(ids, table):
    """Rows ``ids`` of a DTensor ``table`` (V, D), vocabulary-parallel as
    GSPMD lays it out: the table's D made whole (its FSDP shard gathered),
    each rank looks up the ids of its own batch rows that fall in its
    vocabulary shard (zeros for the rest), and the result is a partial sum
    over the mesh dim that shards the vocabulary (``local_map``).  DTensor's
    own rule (``MaskPartial``) fails in PyTorch 2.11 when the batch and the
    table's D share a mesh dim, and reduces only once where a lookup feeds
    two ops."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if isinstance(p, Shard) and p.dim == 0]
    if len(vocab) > 1:
        raise ValueError(f"embedding: the vocabulary is sharded over {len(vocab)} mesh dims")
    if not is_dtensor(ids):
        ids = distribute(ids, mesh, P())
    t_to = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    i_to = [p if isinstance(p, Shard) and i not in vocab else Replicate()
            for i, p in enumerate(ids.placements)]
    out = [Partial() if i in vocab else p for i, p in enumerate(i_to)]

    def lookup(t, i):
        if not vocab:
            return torch.nn.functional.embedding(i, t)
        n = t.shape[0]
        j = i - mesh.get_local_rank(vocab[0]) * n
        mine = (j >= 0) & (j < n)
        return torch.nn.functional.embedding(j.clamp(0, n - 1), t).masked_fill(
            ~mine[..., None], 0)

    table, ids = redistribute(table, tuple(t_to)), redistribute(ids, tuple(i_to))
    return local_map(_waited(lookup), out_placements=out, in_placements=(t_to, i_to),
                     device_mesh=mesh)(table, ids)


def local_attention(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)`` (``dispatch.attention``, which takes local
    tensors) on each rank's local batch rows and heads when q is a DTensor
    (a sharded train step; ``on_local``): attention is independent per
    (row, head), so a rank needs only whole sequences, and the plain
    version's merges of batch and heads never meet DTensor's planner.  The
    heads stay sharded where q's and k's head counts both divide the mesh
    dims that shard them, and there is no bias; else only the rows do.  A
    decode step's ``kv_valid_len`` (one entry a row) is split with the rows."""
    if not is_dtensor(q):
        return attend(q, k, v, **kw)
    kvlen = kw.pop("kv_valid_len", None)
    if kvlen is not None:
        if not is_dtensor(kvlen):
            kvlen = distribute(kvlen, q.device_mesh, P(None))
        return on_local("attention", lambda q, k, v, n: attend(q, k, v, kv_valid_len=n, **kw),
                        q, k, v, kvlen, keep=(0,))
    heads = kw.get("bias") is None and _heads_split(q, k)
    return on_local("attention", lambda *a: attend(*a, **kw), q, k, v,
                    keep=(0, 2) if heads else (0,))


def split_heads(x, heads: int):
    """``x`` (..., heads * hd) as (..., heads, hd).  A DTensor whose last
    dim is sharded over more ranks than divide ``heads`` (8 K/V heads on a
    16-wide model axis) is gathered on that dim first: DTensor cannot cut
    a head across ranks, where GSPMD shards the head dim instead."""
    if is_dtensor(x) and heads > 1:
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        split = [isinstance(p, Shard) and p.dim == last for p in x.placements]
        n = math.prod(x.device_mesh.size(i) for i, s in enumerate(split) if s)
        if heads % n:
            _note("heads")
            x = redistribute(x, tuple(Replicate() if s else p
                                      for p, s in zip(x.placements, split)))
    return x.reshape(*x.shape[:-1], heads, x.shape[-1] // heads)


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.heads = x.shape[-2]
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.heads)


def merge_heads(x):
    """``x`` (..., heads, hd) as (..., heads * hd); a DTensor's gradient
    comes back through ``split_heads`` (gathered where DTensor cannot cut
    its shard into the heads)."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _MergeHeads.apply(x)


def _heads_split(q, k) -> bool:
    """Do q's head-dim placements split k's heads evenly too?"""
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    n = 1
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 2:
            n *= mesh.size(i)
    return q.shape[2] % n == 0 and k.shape[2] % n == 0


def on_rows(op: str, fn, x):
    """``fn`` (a token-wise op: each row of the last dim alone) on each
    rank's local rows of ``x``: its last dim made whole (and a partial
    sum reduced) first, counted under ``local:<op>`` when that moves it."""
    return on_local(op, fn, x, keep=tuple(range(x.dim() - 1)))


# --------------------------------------------------------------------------
# PPM
# --------------------------------------------------------------------------
def ppm_input_shardings(mesh):
    """aatype (B, N): replicate batch (B = 1), shard nothing: the pair
    tensor constraint inside the model does the work."""
    return {"aatype": P(None, data_axes(mesh))}


def ppm_constraints(mesh):
    """Specs used inside the PPM forward."""
    return {
        "z": P(None, data_axes(mesh), MODEL, None),   # (B, i, j, Hz)
        "s": P(None, data_axes(mesh), None),          # (B, N, Hm)
    }


def ppm_serving_rules(mesh) -> dict[str, P]:
    """The serving tier's rule: the pair tensor (B, i, j, Hz) rides the
    model axis on j, the dimension every Table-1 activation shares, so a
    block's per-device pair bytes drop by |model|, which is what admission
    divides by.  Batch and i stay replicated, and so does the sequence
    track (B, N, Hm): it is linear in N."""
    return {"pair": P(None, None, MODEL, None)}


# --------------------------------------------------------------------------
# the pair tensor split on j over the model group
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PairShard:
    """This rank's place in the model group that splits the pair tensor's
    j axis: rank ``index`` of ``size`` holds columns ``cols(n)``.

    The methods are the data movement the j-sharded ops need, each one
    collective of ``collectives`` over ``group``:

      * ``gather(x, dim)``: every rank's share along ``dim`` concatenated
        in rank order (an operand a contraction needs whole);
      * ``cols_to_rows(x)``: (B, N, N/W, H) column shard -> (B, N/W, N, H)
        row shard of the same tensor (an all-to-all), and ``rows_to_cols``
        back;
      * ``amax(t)``: the maximum over the group (a scheme's tensor- or
        channel-wide statistic);
      * ``gather_to_root(x, dim)``: the concatenation on the group's rank 0
        only, ``None`` elsewhere.
    """
    group: Any
    size: int
    index: int

    def cols(self, n: int) -> slice:
        w = n // self.size
        return slice(self.index * w, (self.index + 1) * w)

    def gather(self, x, dim: int):
        return coll.all_gather(x, dim, self.group)

    def cols_to_rows(self, x):
        return coll.all_to_all(x, 1, 2, self.group)

    def rows_to_cols(self, x):
        return coll.all_to_all(x, 2, 1, self.group)

    def amax(self, t):
        return coll.all_reduce(t.clone(), "max", self.group)

    def gather_to_root(self, x, dim: int):
        return coll.gather(x, dim, self.group)


@contextlib.contextmanager
def sharded(shard: PairShard | None, n: int):
    """Run a forward of pair length ``n`` as ``shard``'s part: the serving
    rules are active (``constrain``) and the schemes' tensor- and
    channel-wide statistics are maxima over the group (``global_amax``).
    ``shard`` None is the single-device forward: nothing is scoped."""
    if shard is None:
        yield
        return
    prev = getattr(_ACT, "shard", None)
    _ACT.shard = (shard, n)
    try:
        with act_rules(ppm_serving_rules(None)):
            yield
    finally:
        _ACT.shard = prev


def current_shard() -> PairShard | None:
    scope = getattr(_ACT, "shard", None)
    return None if scope is None else scope[0]


def global_amax(t):
    """``t`` (a maximum over this rank's part of an activation) as the
    maximum over the whole activation: all-reduced over the model group in
    a ``sharded`` scope, ``t`` itself outside one."""
    shard = current_shard()
    return t if shard is None else shard.amax(t)
