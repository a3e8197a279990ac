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
#: the rules of the scope entered last in any thread, for a thread that
#: never entered one: autograd's device thread, which on the card runs a
#: backward and its checkpointed blocks' recompute
_LAST: dict = {"rules": None}


@contextlib.contextmanager
def act_rules(rules: dict[str, P] | None):
    """Scope a dict of named activation specs; models call
    ``constrain(x, name)`` at layer boundaries.  A thread that never
    entered a scope reads the one entered last (a backward's recompute
    lays its blocks out as their forward did)."""
    prev, prev_last = getattr(_ACT, "rules", None), _LAST["rules"]
    _ACT.rules = _LAST["rules"] = rules
    try:
        yield
    finally:
        _ACT.rules, _LAST["rules"] = prev, prev_last


def _rules():
    return getattr(_ACT, "rules", _LAST["rules"])


def rule_value(name: str, default=None):
    """Non-spec configuration riding the act-rules scope."""
    rules = _rules()
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
    (the serving tier's j-split pair tensor, or a ``PairGrid``) every dim
    the spec puts on a mesh axis of the scope's shard must hold the rank's
    share (n / the axis's size) of the scope's pair length: raises where
    it does not; ``x`` itself passes through (the
    port's tensors are the shards, nothing is moved) and its shape is
    kept in ``PINNED``.  Anything else passes through."""
    rules = _rules()
    if not rules or name not in rules:
        return x
    if is_dtensor(x):
        return pin(x, rules[name])
    scope = getattr(_ACT, "shard", None)
    if scope is None:
        return x
    shard, n = scope
    for dim, entry in enumerate(rules[name]):
        k = shard.parts(entry)
        if k and x.shape[dim] != n // k:
            raise ValueError(f"constrain({name!r}): dim {dim} holds {x.shape[dim]}, "
                             f"the rank's shard is {n // k} of {n}")
    PINNED[name] = tuple(x.shape)
    return x


def guarded(spec: P, shape, mesh) -> P:
    """``spec`` for a tensor of ``shape``: a dim its axes do not divide (or
    of size 1) replicated.  GSPMD pads such a dim; DTensor's uneven shards
    (and a sharded dim of size 1) break the reshapes after them."""
    return P(*(e if e is None or (shape[d] > 1 and shape[d] % _axis_size(mesh, e) == 0)
               else None for d, e in enumerate(spec)))


def pin(x, spec: P):
    """A DTensor redistributed to ``spec``'s placements on its own mesh, a
    dim the spec cannot divide replicated (``guarded``: the same values,
    laid out otherwise)."""
    mesh = x.device_mesh
    return redistribute(x, placements(guarded(spec, x.shape, mesh), mesh))


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


def whole_dim(x, dim: int):
    """``x`` with no mesh dim sharding its dim ``dim`` (a DTensor's shard of
    it gathered); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.dim()
    return redistribute(x, tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                                 for p in x.placements))


def columns_shards(w) -> int:
    """How many ranks shard ``w``'s last dim (1 for a plain tensor)."""
    if not is_dtensor(w):
        return 1
    from torch.distributed.tensor import Shard
    last = w.dim() - 1
    return math.prod(w.device_mesh.size(i) for i, p in enumerate(w.placements)
                     if isinstance(p, Shard) and p.dim == last)


def columns(w, lo: int, hi: int | None, sharded: bool):
    """``w[..., lo:hi]`` of a weight whose last dim (its columns) is
    sharded: made whole on that dim and cut (a weight's gather, where
    slicing the product's output would gather an activation), then
    sharded again as ``w`` was where ``sharded`` and the mesh divides the
    cut, else replicated on those mesh dims.  A plain tensor is sliced."""
    part = whole_dim(w, -1)[..., lo:hi]
    if not is_dtensor(w):
        return part
    from torch.distributed.tensor import Replicate, Shard
    last = w.dim() - 1
    n = columns_shards(w)
    keep = sharded and part.shape[-1] % n == 0
    return redistribute(part, tuple(p if not (isinstance(p, Shard) and p.dim == last) or keep
                                    else Replicate() for p in w.placements))


def heads_local(fn, x, dt, a, b, c, d):
    """``fn(x, dt, a, b, c, d)`` (the SSD: x (B, S, H, P), dt (B, S, H), a
    and d (H,), b and c (B, S, N)) on each rank's local rows and heads:
    x's rows and heads keep their shards, dt, a and d follow the heads,
    b and c are made whole on the heads' mesh dims (their gradient there a
    partial sum, as a and d's over the rows'); the result (B, S, H, P) on
    x's placements.  ``fn`` must treat each (row, head) alone."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    dims = _dims_by_tensor_dim(x)
    rows = [i for i in dims.get(0, []) if x.shape[0] % mesh.size(i) == 0]
    heads = dims.get(2, [])
    h_to = [Shard(0) if i in rows else Shard(2) if i in heads else Replicate()
            for i in range(mesh.ndim)]
    v_to = [Shard(0) if i in heads else Replicate() for i in range(mesh.ndim)]
    r_to = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    v_grad = [Partial() if i in rows else p for i, p in enumerate(v_to)]
    r_grad = [Partial() if i in heads else p for i, p in enumerate(r_to)]
    args = [redistribute(t, tuple(to)) for t, to in
            ((x, h_to), (dt, h_to), (a, v_to), (b, r_to), (c, r_to), (d, v_to))]
    return local_map(_waited(fn), out_placements=h_to,
                     in_placements=(h_to, h_to, v_to, r_to, r_to, v_to),
                     in_grad_placements=(h_to, h_to, v_grad, r_grad, r_grad, v_grad),
                     device_mesh=mesh)(*args)


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
    return grad_on_placements(y) if y.dim() >= 3 else y


def grad_on_placements(y):
    """``y``, whose gradient comes back on ``y``'s own placements (a
    partial sum's replicated) where ``y`` is a DTensor: the identity."""
    return _GradOnPlacements.apply(y) if is_dtensor(y) else y


class _GradOnPlacements(torch.autograd.Function):
    """The identity; its backward redistributes the gradient to the
    forward tensor's placements (replicated where that was partial), its
    local shard contiguous (DTensor's reshape views a local shard)."""

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
        return g.contiguous()


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

    # a rank looks up only its own batch rows: the table's gradient is a
    # partial sum over the mesh dims that shard the ids
    t_grad = [Partial() if isinstance(p, Shard) else t for p, t in zip(i_to, t_to)]
    table, ids = redistribute(table, tuple(t_to)), redistribute(ids, tuple(i_to))
    return local_map(_waited(lookup), out_placements=out, in_placements=(t_to, i_to),
                     in_grad_placements=(t_grad, i_to), device_mesh=mesh)(table, ids)


def vocab_split(w, vdim: int):
    """The mesh dim (of more than one rank) over which a sharded step's
    cross-entropy splits the vocabulary, dim ``vdim`` of the unembedding
    weight ``w``: the one that shards it, or, where none does (a
    vocabulary the mesh does not divide, so the table is replicated there),
    the one the ``logits`` rule puts the vocabulary on (GSPMD pads the
    uneven shards; a rank here takes a ceil(V / n) slice).  None where
    nothing splits it: a plain tensor, a 1 x 1 mesh."""
    if not is_dtensor(w):
        return None
    from torch.distributed.tensor import Shard
    mesh = w.device_mesh
    dims = [i for i, p in enumerate(w.placements)
            if isinstance(p, Shard) and p.dim == vdim and mesh.size(i) > 1]
    if len(dims) > 1:
        raise ValueError(f"vocab_split: the vocabulary is sharded over {len(dims)} mesh dims")
    if dims:
        return dims[0]
    rule = rule_value("logits")
    names = tuple(mesh.mesh_dim_names or ())
    if rule and rule[-1] in names and mesh.size(names.index(rule[-1])) > 1:
        return names.index(rule[-1])
    return None


def vocab_parallel_xent(x, w, labels, vdim: int, v: int):
    """``[sum of the masked next-token NLL, count of labels >= 0]`` of hidden
    states ``x`` (B, S, D) against ``labels`` (B, S), the logits
    ``x @ w`` (``w`` (D, V); ``vdim`` 0: ``w`` is the (V, D) table, used
    transposed) never made whole: as GSPMD reduces over the vocabulary's
    shards (the reference's ``chunked_xent`` pins its logits to
    ``P(dp, None, model)``).  Mesh dim ``v`` splits the vocabulary
    (``vocab_split``): ``w``'s shard there, or a slice of its whole
    vocabulary.  ``w``'s other dim is gathered (an FSDP shard), ``x``
    keeps only its batch rows sharded, and each rank works in float32 on
    its local (B/|data|, S, V/|model|) logits: a max, a sum of
    exponentials and the label's logit, each all-reduced over ``v``
    (``_VocabXent``), whose backward is the rank's local
    ``softmax - onehot``.  The two sums are all-reduced over the mesh dims
    that shard the batch, so the result is the same on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    sliced = not isinstance(w.placements[v], Shard)
    if not is_dtensor(x):
        x = distribute(x, mesh, P())
    if not is_dtensor(labels):
        labels = distribute(labels, mesh, P())
    rows = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == 0
            and i != v and mesh.size(i) > 1]
    if rows and x.shape[0] % math.prod(mesh.size(i) for i in rows):
        rows = []
    x_to = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    w_to = [Shard(vdim) if i == v and not sliced else Replicate() for i in range(mesh.ndim)]
    # gradients: x's is a partial sum over the vocabulary's shards, w's over
    # the batch's (and over the slices, where it is sliced)
    x_grad = [Partial() if i == v else p for i, p in enumerate(x_to)]
    w_grad = [Partial() if i in rows or (i == v and sliced) else p for i, p in enumerate(w_to)]
    groups = (mesh.get_group(v), [mesh.get_group(i) for i in rows])
    r = mesh.get_local_rank(v)

    def local(xl, wl, ll):
        if sliced:
            n = -(-wl.shape[vdim] // mesh.size(v))
            lo = min(r * n, wl.shape[vdim])
            wl = wl.narrow(vdim, lo, min(n, wl.shape[vdim] - lo))
        else:
            lo = r * wl.shape[vdim]
        return _VocabXent.apply(xl, wl.t() if vdim == 0 else wl, ll, lo, groups)

    x, w = redistribute(x, tuple(x_to)), redistribute(w, tuple(w_to))
    labels = redistribute(labels, tuple(x_to))
    return local_map(_waited(local), out_placements=[Replicate()] * mesh.ndim,
                     in_placements=(x_to, w_to, x_to),
                     in_grad_placements=(x_grad, w_grad, x_to), device_mesh=mesh)(x, w, labels)


def _f32_product(x, w):
    """``x @ w`` (plain tensors) accumulated in float32 with a float32
    result: a bf16 product keeps its operands on the card (``out_dtype``);
    elsewhere they are widened (counted apart, ``widening``)."""
    if x.dtype == w.dtype and x.dtype != torch.float32 and x.device.type == "cuda":
        return torch.mm(x, w, out_dtype=torch.float32)
    with widening():
        x, w = x.float(), w.float()
    return x @ w


class _VocabXent(torch.autograd.Function):
    """On local tensors: x (b, s, D), w (D, V/M) (the rank's vocabulary
    columns, starting at ``off``), labels (b, s); returns ``[NLL sum,
    count]`` over every rank's rows.  The forward's collectives are
    ``collectives``' (counted); the backward needs none."""

    @staticmethod
    def forward(ctx, x, w, labels, off, groups):
        vgroup, bgroups = groups
        x2 = x.reshape(-1, x.shape[-1])
        logits = _f32_product(x2, w.to(x.dtype))                   # (T, V/M) f32
        m = coll.all_reduce(logits.amax(dim=-1), "max", vgroup)
        e = torch.exp(logits - m[:, None])
        se = coll.all_reduce(e.sum(dim=-1), "sum", vgroup)
        lab = labels.reshape(-1).long()
        j = lab.clamp_min(0) - off
        mine = (j >= 0) & (j < logits.shape[1])
        j = j.clamp(0, logits.shape[1] - 1)
        picked = torch.where(mine, torch.gather(logits, 1, j[:, None])[:, 0], 0.0)
        picked = coll.all_reduce(picked, "sum", vgroup)
        del logits
        mask = (lab >= 0).float()
        nll = torch.log(se) + m - picked
        out = torch.stack([torch.sum(nll * mask), torch.sum(mask)])
        for g in bgroups:
            out = coll.all_reduce(out, "sum", g)
        ctx.save_for_backward(x, w, e, se, j, mine, mask)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, w, e, se, j, mine, mask = ctx.saved_tensors
        # d NLL / d logits = softmax - onehot (the label's column where it is
        # this rank's), for each unmasked row
        p = e.div_(se[:, None])
        p.scatter_add_(1, j[:, None], -mine.to(p.dtype)[:, None])
        p.mul_((mask * gout[0])[:, None])
        x2 = x.reshape(-1, x.shape[-1])
        gx = (p @ w.t().to(p.dtype)).to(x.dtype).reshape(x.shape)
        gw = (x2.t().to(p.dtype) @ p).to(w.dtype)
        return gx, gw, None, None, None


def local_attention(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)`` (``dispatch.attention``, which takes local
    tensors) on each rank's local tensors when q or k is a DTensor (a
    sharded step; ``local_map``), as GSPMD partitions the reference's
    attention: attention is independent per (row, head), so a rank needs
    whole sequences of its own rows and heads only.

    Prefill and training (no ``kv_valid_len``): where the mesh dims that
    shard q's heads divide q's head count (and there is no bias), each
    rank takes its contiguous block of q heads and the K/V heads those
    read, replicated where several ranks share one (GQA: 2 K/V heads on 16
    ranks); where the mesh dims beside the rows divide neither (whisper's
    8 heads on a 16-wide model axis), each rank takes a block of the heads
    and a block of the query rows (``_split_attention``); else only the
    rows stay sharded.

    Decode (``kv_valid_len``, one entry a row): the ring's placements (k's)
    decide, and q and ``kv_valid_len`` are brought to them; the ring is
    not moved.  A ring sharded on rows and K/V heads: each rank attends its
    own rows and heads (``_heads_attention``).  A ring sharded on the head
    dim: the scores are partial sums over each rank's slice, all-reduced
    (``_hd_attention``).  A ring sharded on its positions (``cache_specs``'
    third branch): each rank attends its own positions and the partial
    results merge by their maxima and sums (``_seq_attention``)."""
    mesh = (q if is_dtensor(q) else k).device_mesh if is_dtensor(q) or is_dtensor(k) else None
    if mesh is None:
        return attend(q, k, v, **kw)
    q, k, v = (t if is_dtensor(t) else distribute(t, mesh, P()) for t in (q, k, v))
    kvlen = kw.pop("kv_valid_len", None)
    if kvlen is not None:
        if not is_dtensor(kvlen):
            kvlen = distribute(kvlen, mesh, P(None))
        dims = _dims_by_tensor_dim(k)
        if not dims.get(1) and not dims.get(3):
            return _heads_attention(attend, q, k, v, kvlen, dims.get(0, []), dims.get(2, []),
                                    **kw)
        if dims.get(3) and not dims.get(1) and not dims.get(2):
            return _hd_attention(q, k, v, kvlen, dims.get(0, []), dims[3], **kw)
        if dims.get(1) and not dims.get(2) and not dims.get(3):
            return _seq_attention(q, k, v, kvlen, dims.get(0, []), dims[1], **kw)
        return on_local("attention", lambda q, k, v, n: attend(q, k, v, kv_valid_len=n, **kw),
                        q, k, v, kvlen, keep=(0,))
    dims = _dims_by_tensor_dim(q)
    heads = dims.get(2, [])
    if kw.get("bias") is None and heads and \
            q.shape[2] % math.prod(mesh.size(i) for i in heads) == 0:
        rows = [i for i in dims.get(0, []) if q.shape[0] % mesh.size(i) == 0]
        return _heads_attention(attend, q, k, v, None, rows, heads, **kw)
    if kw.get("bias") is None and not heads:
        rows = [i for i in dims.get(0, []) if q.shape[0] % mesh.size(i) == 0]
        split = [i for i in range(mesh.ndim) if i not in rows and mesh.size(i) > 1]
        n = math.prod(mesh.size(i) for i in split)
        blocks = n // math.gcd(k.shape[2], n)
        if n > 1 and q.shape[2] % n and q.shape[1] % blocks == 0:
            return _split_attention(attend, q, k, v, rows, split, **kw)
    return on_local("attention", lambda *a: attend(*a, **kw), q, k, v, keep=(0,))


def _dims_by_tensor_dim(x) -> dict[int, list[int]]:
    """tensor dim -> the mesh dims that shard it."""
    from torch.distributed.tensor import Shard
    out: dict[int, list[int]] = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            out.setdefault(p.dim, []).append(i)
    return out


def _block_index(mesh, dims) -> int:
    """This rank's block along a tensor dim that ``dims`` shard together
    (outer mesh dim first, as DTensor lays such a dim out)."""
    r = 0
    for i in dims:
        r = r * mesh.size(i) + mesh.get_local_rank(i)
    return r


def _heads_attention(attend, q, k, v, kvlen, rows, heads, **kw):
    """Attention on each rank's rows (mesh dims ``rows`` shard the batch)
    and block of q heads (``heads`` shard dim 2); K/V sharded on the same
    dims where the heads divide (a decode ring's own layout), else made
    whole on ``heads`` and cut to the heads the rank's q heads read (their
    gradient then a partial sum over ``heads``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    n = math.prod(mesh.size(i) for i in heads)
    hq, hkv = q.shape[2], k.shape[2]
    q_to = [Shard(0) if i in rows else Shard(2) if i in heads else Replicate()
            for i in range(mesh.ndim)]
    split = hkv % n == 0
    k_to = q_to if split else [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    k_grad = k_to if split else [Partial() if i in heads else p for i, p in enumerate(k_to)]
    n_to = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    group = hq // hkv

    def local(ql, kl, vl, nl=None):
        if not split:
            # the K/V heads this rank's q heads [q0, q0 + hq_l) read
            hq_l = ql.shape[2]
            q0 = _block_index(mesh, heads) * hq_l
            idx = [(q0 + j) // group for j in range(hq_l)]
            lo, hi = idx[0], idx[-1] + 1
            if hq_l % (hi - lo) == 0 and idx == [lo + j // (hq_l // (hi - lo))
                                                  for j in range(hq_l)]:
                kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
            else:            # a block that straddles K/V heads unevenly: one a q head
                sel = torch.tensor(idx, device=kl.device)
                kl, vl = kl.index_select(2, sel), vl.index_select(2, sel)
        if nl is not None:
            return attend(ql, kl, vl, kv_valid_len=nl, **kw)
        return attend(ql, kl, vl, **kw)

    if not (split and all(tuple(t.placements) == tuple(q_to) for t in (q, k, v))):
        _note("local:attention")
    args = [redistribute(q, tuple(q_to)), redistribute(k, tuple(k_to)),
            redistribute(v, tuple(k_to))]
    ins, grads = [q_to, k_to, k_to], [q_to, k_grad, k_grad]
    if kvlen is not None:
        args.append(redistribute(kvlen, tuple(n_to)))
        ins.append(n_to)
        grads.append(n_to)
    return local_map(_waited(local), out_placements=q_to, in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh)(*args)


def _hd_attention(q, k, v, kvlen, rows, hd, *, causal=False, window=None,
                  softmax_scale=None, bias=None):
    """Decode attention over a ring sharded on its head dim (mesh dims
    ``hd``), as GSPMD contracts it: each rank's q·kᵀ over its slice of the
    head dim, all-reduced over ``hd`` into the scores; the scale, the
    ``kv_valid_len`` mask and the float32 softmax on every rank; PV on the
    rank's slice of v, so the output stays sharded on the head dim.  The
    plain version's arithmetic (``mha_ref``) with the contraction split;
    no kernel takes a partial contraction.  Not differentiable."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if causal or window is not None or bias is not None:
        raise ValueError("_hd_attention: a decode step's attention is over the ring alone")
    mesh = k.device_mesh
    to = [Shard(0) if i in rows else Shard(3) if i in hd else Replicate()
          for i in range(mesh.ndim)]
    n_to = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    groups = [mesh.get_group(i) for i in hd]

    def local(ql, kl, vl, nl):
        from repro_torch.kernels.flash_attention.ref import NEG
        b, sq, hq, dl = ql.shape
        hkv = kl.shape[2]
        qg = ql.float().reshape(b, sq, hkv, hq // hkv, dl)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kl.float())
        for g in groups:
            s = coll.all_reduce(s, "sum", g)
        s = s * scale
        valid = torch.arange(kl.shape[1], device=kl.device)[None] < nl[:, None]   # (B, W)
        s = torch.where(valid[:, None, None, None], s, torch.full((), NEG, device=s.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, vl.float())
        return o.reshape(b, sq, hq, vl.shape[-1]).to(ql.dtype)

    if tuple(k.placements) != tuple(to) or tuple(v.placements) != tuple(to):
        raise ValueError(f"_hd_attention: ring placements {k.placements} / {v.placements}")
    if tuple(q.placements) != tuple(to):
        _note("local:attention")
    args = (redistribute(q, tuple(to)), k, v, redistribute(kvlen, tuple(n_to)))
    return local_map(_waited(local), out_placements=to, in_placements=(to, to, to, n_to),
                     device_mesh=mesh)(*args)


def _split_attention(attend, q, k, v, rows, split, **kw):
    """Attention where the mesh dims ``split`` (n ranks beside the rows)
    divide neither q's heads nor so the K/V heads: each rank of ``split``
    takes one of g = gcd(K/V heads, n) blocks of the K/V heads with the q
    heads that read them, and one of n/g blocks of the query rows (under
    a causal or window mask at its offset among the keys), as GSPMD cuts
    the projections' columns n ways.  A rank's block is its output's only
    nonzero part, so the output is a partial sum over ``split``, reduced
    where it is used; the inputs' gradients are partial sums too."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    n = math.prod(mesh.size(i) for i in split)
    hq, hkv, sq = q.shape[2], k.shape[2], q.shape[1]
    g = math.gcd(hkv, n)
    blocks = n // g
    to = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    part = [Partial() if i in split else p for i, p in enumerate(to)]
    offset = kw.get("causal") or kw.get("window") is not None

    def local(ql, kl, vl):
        h, b = divmod(_block_index(mesh, split), blocks)
        gq, gk, rq = hq // g, hkv // g, sq // blocks
        o = attend(ql[:, b * rq:(b + 1) * rq, h * gq:(h + 1) * gq],
                   kl[:, :, h * gk:(h + 1) * gk], vl[:, :, h * gk:(h + 1) * gk],
                   **kw, **({"q_offset": b * rq} if offset else {}))
        # the block in place among zeros: (rows, heads) of the whole output
        return torch.nn.functional.pad(o, (0, 0, h * gq, hq - (h + 1) * gq,
                                           b * rq, sq - (b + 1) * rq))

    _note("local:attention")
    args = [redistribute(t, tuple(to)) for t in (q, k, v)]
    return local_map(_waited(local), out_placements=part, in_placements=(to, to, to),
                     in_grad_placements=(part, part, part), device_mesh=mesh)(*args)


def _seq_attention(q, k, v, kvlen, rows, seq, *, causal=False, window=None,
                   softmax_scale=None, bias=None):
    """Decode attention over a ring sharded on its positions (mesh dims
    ``seq``): each rank's scores over its own positions (the
    ``kv_valid_len`` mask at its offset), their float32 maximum
    all-reduced over ``seq``, then each rank's sums of the exponentials and
    of the weighted values all-reduced (a log-sum-exp merge), so no rank
    holds another's positions; a fully masked row
    returns mean(v), as ``mha_ref`` does.  Plain PyTorch, not
    differentiable."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if causal or window is not None or bias is not None:
        raise ValueError("_seq_attention: a decode step's attention is over the ring alone")
    mesh = k.device_mesh
    to = [Shard(0) if i in rows else Shard(1) if i in seq else Replicate()
          for i in range(mesh.ndim)]
    q_to = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    groups = [mesh.get_group(i) for i in seq]

    def local(ql, kl, vl, nl):
        from repro_torch.kernels.flash_attention.ref import NEG
        b, sq, hq, d = ql.shape
        w, hkv = kl.shape[1], kl.shape[2]
        p0 = _block_index(mesh, seq) * w
        qg = ql.float().reshape(b, sq, hkv, hq // hkv, d)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kl.float()) * scale
        valid = p0 + torch.arange(w, device=kl.device)[None] < nl[:, None]      # (B, W/n)
        s = torch.where(valid[:, None, None, None], s, torch.full((), NEG, device=s.device))
        mx = s.amax(dim=-1, keepdim=True)
        for gr in groups:
            coll.all_reduce(mx, "max", gr)
        e = torch.exp(s - mx)
        den = e.sum(dim=-1, keepdim=True)
        num = torch.einsum("bgrqk,bkgd->bgrqd", e, vl.float())
        for gr in groups:
            coll.all_reduce(den, "sum", gr)
            coll.all_reduce(num, "sum", gr)
        o = (num / den).permute(0, 3, 1, 2, 4)
        return o.reshape(b, sq, hq, vl.shape[-1]).to(ql.dtype)

    if tuple(k.placements) != tuple(to) or tuple(v.placements) != tuple(to):
        raise ValueError(f"_seq_attention: ring placements {k.placements} / {v.placements}")
    if tuple(q.placements) != tuple(q_to):
        _note("local:attention")
    args = (redistribute(q, tuple(q_to)), k, v, redistribute(kvlen, tuple(q_to)))
    return local_map(_waited(local), out_placements=q_to, in_placements=(q_to, to, to, q_to),
                     device_mesh=mesh)(*args)


def write_positions(ring, rows, x):
    """``ring.index_copy_(1, rows, x)`` for a ring sharded on its positions
    (dim 1; ``rows`` consecutive, as a decode step's are): each rank
    rewrites its own positions, taking the rows of ``x`` that land there
    and keeping the others (no size read back from the device).  Returns
    the ring."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = ring.device_mesh
    dims = _dims_by_tensor_dim(ring)[1]
    to = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in ring.placements)
    xl = redistribute(x.to(ring.dtype), to).to_local()
    rl = ring.to_local()
    w, s = rl.shape[1], xl.shape[1]
    t = _block_index(mesh, dims) * w + torch.arange(w, device=rl.device) - to_local(rows)[:1]
    ok = ((t >= 0) & (t < s)).view(1, w, *([1] * (rl.dim() - 2)))
    rl.copy_(torch.where(ok, xl.index_select(1, t.clamp(0, s - 1)), rl))
    return ring


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
        return _heads_not_hd(x).reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.heads)


def _heads_not_hd(x):
    """A DTensor (..., heads, hd) whose head dim is sharded (attention over
    a ring sharded on it) moved to shard the heads instead where they
    divide (else made whole): a view cannot merge a sharded head dim into
    the heads (PyTorch 2.11 refuses)."""
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    split = [isinstance(p, Shard) and p.dim == last for p in x.placements]
    if not any(split):
        return x
    n = math.prod(x.device_mesh.size(i) for i, s in enumerate(split) if s)
    to = Shard(last - 1) if x.shape[-2] % n == 0 else Replicate()
    return redistribute(x, tuple(to if s else p for p, s in zip(x.placements, split)))


def merge_heads(x):
    """``x`` (..., heads, hd) as (..., heads * hd); a DTensor's gradient
    comes back through ``split_heads`` (gathered where DTensor cannot cut
    its shard into the heads)."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _MergeHeads.apply(x)


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

    It also speaks the ``PairGrid``'s vocabulary as the grid of one row
    strip (``d`` 1, ``m`` its size), slab methods included, so the trunk
    ops and the chunked stack are written once.
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

    # the grid's vocabulary (``PairGrid``), on a grid of one row strip: rows
    # are whole, a column strip is the rank's own block
    specs = None
    d = 1

    def parts(self, entry) -> int:
        axes = entry if isinstance(entry, tuple) else (entry,)
        return self.size if MODEL in axes else 0

    def rules(self) -> dict[str, P]:
        return ppm_serving_rules(None)

    def rows(self, n: int) -> slice:
        return slice(0, n)

    def row_strip(self, x):
        return self.gather(x, 2)

    def col_strip(self, x):
        return x

    def seq_whole(self, x):
        return x

    def seq_cols(self, x):
        return x[:, self.cols(x.shape[1])]

    def swap(self, x):
        return self.cols_to_rows(x)

    swap_rows = swap
    swap_cols = row_strip
    whole = row_strip
    to_fine_rows = swap
    from_fine_rows = rows_to_cols

    def fine_rows_whole(self, x):
        return self.gather(x, 1)

    to_fine_cols = from_fine_cols = row_strip_t = col_strip
    fine_cols_whole = whole_t = fine_rows_whole

    @property
    def m(self) -> int:
        return self.size

    def swap_rows_slab(self, x, n: int, t: int, c: int):
        return self.cols_to_rows(x)

    def swap_cols_slab(self, x, n: int, s: int, c: int):
        return self.gather(x, 2)

    def block_to_root(self, x):
        return self.gather_to_root(x, 2)


# --------------------------------------------------------------------------
# the pair tensor on a two-dimensional grid: rows on the data axes, columns
# on model (the reference's production layout)
# --------------------------------------------------------------------------
def _cut(lo: int, n: int, lo2: int, n2: int) -> tuple[int, int] | None:
    """[lo, lo + n) and [lo2, lo2 + n2) intersected; None where empty."""
    a, b = max(lo, lo2), min(lo + n, lo2 + n2)
    return (a, b) if a < b else None


def _meet(a, b) -> list:
    """Two lists of global index ranges [lo, hi) intersected, in order."""
    return sorted(x for x in (_cut(lo, hi - lo, lo2, hi2 - lo2) for lo, hi in a for lo2, hi2 in b)
                  if x is not None)


def _at(layout, g: int) -> int:
    """The local index of global index ``g`` in a tensor axis that holds
    the ranges of ``layout`` one after the other."""
    off = 0
    for lo, hi in layout:
        if lo <= g < hi:
            return off + g - lo
        off += hi - lo
    raise IndexError(g)


def _span(layout) -> int:
    return sum(hi - lo for lo, hi in layout)


def _pieces(x, layouts, pieces):
    """The ``pieces`` (per axis 1 and 2: global ranges inside that axis's
    ``layouts``) of ``x``, concatenated axis by axis."""
    for dim, (layout, want) in enumerate(zip(layouts, pieces), 1):
        parts = [x.narrow(dim, _at(layout, lo), hi - lo) for lo, hi in want]
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return x


def _place(out, layouts, pieces, x) -> None:
    """Write ``x`` (the ``pieces`` concatenated, as ``_pieces`` cuts them)
    into ``out``, whose axes 1 and 2 hold ``layouts``."""
    i = 0
    for lo, hi in pieces[0]:
        j = 0
        for lo2, hi2 in pieces[1]:
            out.narrow(1, _at(layouts[0], lo), hi - lo).narrow(
                2, _at(layouts[1], lo2), hi2 - lo2).copy_(
                x.narrow(1, i, hi - lo).narrow(2, j, hi2 - lo2))
            j += hi2 - lo2
        i += hi - lo


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map2(fn, v, sp) for v, sp in zip(tree, specs)]
    return fn(tree, specs)


@dataclasses.dataclass(frozen=True)
class PairGrid:
    """This rank's cell (r, c) of a D x M grid over the pair tensor, the
    reference's production rules (``default_act_rules``: "pair" ``P(None,
    dp, MODEL, None)``, "seq_track" ``P(None, dp, None)``) made explicit:
    rank (r, c) holds the block z[:, I_r, J_c] (I_r = ``rows(n)``, rows
    split D ways over the data axes ``dp``; J_c = ``cols(n)``, columns
    split M ways over ``model``) and the sequence track's rows I_r.
    ``model_group`` is the M ranks of row strip r (index c), ``data_group``
    the D ranks of column strip c (index r), ``ranks[r][c]`` the global
    rank of cell (r, c).

    The data movement the ops need, x a (B, N/D, N/M, H) block unless
    said otherwise; a group of one rank is skipped, so a 1 x 1 grid moves
    nothing:

      * ``row_strip(x)``: x[I_r, :] (an all-gather over ``model``);
        ``col_strip(x)``: x[:, J_c] (over the data axes); ``whole(x)``;
      * ``swap(x)``: x[J_c, I_r] as (B, N/M, N/D, H), the block the
        transpose puts here (point to point between the cells that hold
        its pieces: (r, c) <-> (c, r) where D = M; an all-to-all where D
        or M is 1); ``swap_rows(x)``: x[J_c, :] and ``swap_cols(x)``:
        x[:, I_r], a swap gathered over one axis;
      * ``to_fine_rows(x)``: the rank's N/(DM) rows of I_r with every
        column (an all-to-all over ``model``), ``from_fine_rows`` back,
        ``fine_rows_whole`` every rank's fine rows gathered; the same on a
        transposed block for columns (``to_fine_cols``, an all-to-all over
        the data axes);
      * ``seq_whole(s)``: the sequence track's rows gathered;
        ``seq_cols(s)``: its rows J_c;
      * ``amax(t)``: the maximum over the grid; ``block_to_root(x)``: the
        blocks concatenated on cell (0, 0), ``None`` elsewhere;
      * ``cut``/``uncut``: a parameter's shard by its ``param_spec`` on
        the grid's mesh (``axes``), and the whole gathered back;
      * a slab at a time (the row-chunked pair stack): ``row_strip`` and
        ``row_strip_t`` of a slab as of a block; ``swap_rows_slab`` and
        ``swap_cols_slab``, one slab of ``swap_rows`` and ``swap_cols``
        (point to point, every rank sending and receiving at every slab);
        ``whole_t``, a transposed block gathered whole.

    ``axes`` names the mesh's axes with their sizes where the rows ride
    more than ``data`` (``pod`` and ``data``); ``specs`` is the spec tree
    of the parameters ``grid_params`` cut.
    """
    model_group: Any
    data_group: Any
    d: int
    m: int
    r: int
    c: int
    ranks: tuple
    axes: tuple | None = None
    specs: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def size(self) -> int:
        return self.d * self.m

    @property
    def mesh(self) -> AbstractMesh:
        """The mesh's axes (name, size), outer first: ``axes``, or ``data``
        and ``model`` of the grid's sizes."""
        axes = self.axes or ((DATA, self.d), (MODEL, self.m))
        return AbstractMesh(tuple(s for _, s in axes), tuple(a for a, _ in axes))

    def parts(self, entry) -> int:
        if entry is None:
            return 0
        return self.m if entry == MODEL else self.d

    def rules(self) -> dict[str, P]:
        dp = data_axes(self.mesh)
        return {"pair": P(None, dp, MODEL, None), "seq_track": P(None, dp, None)}

    def rows(self, n: int) -> slice:
        w = n // self.d
        return slice(self.r * w, (self.r + 1) * w)

    def cols(self, n: int) -> slice:
        w = n // self.m
        return slice(self.c * w, (self.c + 1) * w)

    # -- gathers --------------------------------------------------------
    def _over_model(self, x, dim: int):
        return x if self.m == 1 else coll.all_gather(x, dim, self.model_group)

    def _over_data(self, x, dim: int):
        return x if self.d == 1 else coll.all_gather(x, dim, self.data_group)

    def row_strip(self, x):
        return self._over_model(x, 2)

    def col_strip(self, x):
        return self._over_data(x, 1)

    def row_strip_t(self, x):
        """A transposed block (B, N/M, N/D, H) with every row of it."""
        return self._over_data(x, 2)

    def whole(self, x):
        return self.col_strip(self.row_strip(x))

    def seq_whole(self, x):
        return self._over_data(x, 1)

    def seq_cols(self, x):
        return self.seq_whole(x)[:, self.cols(x.shape[1] * self.d)]

    # -- the transpose's blocks -------------------------------------------
    def swap(self, x):
        if self.d == 1:
            return x if self.m == 1 else coll.all_to_all(x, 1, 2, self.model_group)
        if self.m == 1:
            return coll.all_to_all(x, 2, 1, self.data_group)
        rd, cw = x.shape[1], x.shape[2]
        r0, c0 = self.r * rd, self.c * cw
        out = x.new_empty((x.shape[0], cw, rd, *x.shape[3:]))
        sends, recvs, pieces = [], [], []
        for r2 in range(self.d):
            for c2 in range(self.m):
                # to (r2, c2), whose swap is rows J_c2 x columns I_r2
                rs, cs = _cut(r0, rd, c2 * cw, cw), _cut(c0, cw, r2 * rd, rd)
                mine = None if rs is None or cs is None else \
                    x[:, rs[0] - r0:rs[1] - r0, cs[0] - c0:cs[1] - c0]
                if (r2, c2) == (self.r, self.c):
                    if mine is not None:
                        out[:, rs[0] - c0:rs[1] - c0, cs[0] - r0:cs[1] - r0] = mine
                    continue
                if mine is not None:
                    sends.append((self.ranks[r2][c2], mine))
                # from (r2, c2): its rows in J_c, its columns in I_r
                ri, ci = _cut(r2 * rd, rd, c0, cw), _cut(c2 * cw, cw, r0, rd)
                if ri is not None and ci is not None:
                    buf = x.new_empty((x.shape[0], ri[1] - ri[0], ci[1] - ci[0], *x.shape[3:]))
                    recvs.append((self.ranks[r2][c2], buf))
                    pieces.append((ri, ci, buf))
        coll.exchange(sends, recvs)
        for ri, ci, buf in pieces:
            out[:, ri[0] - c0:ri[1] - c0, ci[0] - r0:ci[1] - r0] = buf
        return out

    def swap_rows(self, x):
        return self._over_data(self.swap(x), 2)

    # -- one slab at a time (the row-chunked pair stack) ---------------------
    def _redistribute(self, x, have, want):
        """Every rank's ``have`` of a pair-shaped tensor handed to the ranks
        that ``want`` it: ``have(r, c)`` and ``want(r, c)`` give cell (r,
        c)'s (row ranges, column ranges), global, which its axes 1 and 2
        hold one range after the other; ``x`` is this rank's ``have``, the
        result its ``want``.  One point-to-point exchange (``swap``'s), each
        peer's pieces in one message; every rank computes every cell's
        ranges, so the sends and receives pair up."""
        me = (self.r, self.c)
        hv, wt = have(*me), want(*me)
        out = x.new_empty((x.shape[0], _span(wt[0]), _span(wt[1]), *x.shape[3:]))
        sends, recvs, landed = [], [], []
        for r2 in range(self.d):
            for c2 in range(self.m):
                theirs = want(r2, c2)
                mine = [_meet(hv[0], theirs[0]), _meet(hv[1], theirs[1])]
                if (r2, c2) == me:
                    if all(mine):
                        _place(out, wt, mine, _pieces(x, hv, mine))
                    continue
                if all(mine):
                    sends.append((self.ranks[r2][c2], _pieces(x, hv, mine)))
                got = have(r2, c2)
                got = [_meet(got[0], wt[0]), _meet(got[1], wt[1])]
                if all(got):
                    buf = x.new_empty((x.shape[0], _span(got[0]), _span(got[1]), *x.shape[3:]))
                    recvs.append((self.ranks[r2][c2], buf))
                    landed.append((got, buf))
        coll.exchange(sends, recvs)
        for got, buf in landed:
            _place(out, wt, got, buf)
        return out

    def _segments(self, n: int) -> tuple[int, int]:
        """(segment length, count): the rows cut at every row strip's and
        every column strip's bounds, into lcm(D, M) equal segments."""
        k = math.lcm(self.d, self.m)
        return n // k, k

    def swap_rows_slab(self, x, n: int, t: int, c: int):
        """Slab ``t`` of ``swap_rows``: ``x`` holds rows t*c:(t+1)*c of
        each segment (``_segments``) of the rank's rows I_r on its columns
        J_c; the result, the same rows of each segment of J_c over every
        column (B, c * segments in J_c, N, H), in order.  Every rank sends
        and receives at each ``t``."""
        seg, k = self._segments(n)

        def slabs(first, count):
            return [(e * seg + t * c, e * seg + (t + 1) * c) for e in range(first, first + count)]

        rd, cm = k // self.d, k // self.m
        return self._redistribute(
            x, lambda r, c2: (slabs(r * rd, rd), [(c2 * (n // self.m), (c2 + 1) * (n // self.m))]),
            lambda r, c2: (slabs(c2 * cm, cm), [(0, n)]))

    def swap_cols_slab(self, x, n: int, s: int, c: int):
        """Slab ``s`` of ``swap_cols``: ``x`` holds rows s*c:(s+1)*c of the
        rank's rows I_r on its columns J_c; the result, the same rows of
        every row strip on the columns I_r (B, D * c, N/D, H), in order."""
        rw, cw = n // self.d, n // self.m
        return self._redistribute(
            x, lambda r, c2: ([(r * rw + s * c, r * rw + (s + 1) * c)], [(c2 * cw, (c2 + 1) * cw)]),
            lambda r, c2: ([(r2 * rw + s * c, r2 * rw + (s + 1) * c) for r2 in range(self.d)],
                           [(r * rw, (r + 1) * rw)]))

    def swap_cols(self, x):
        return self.row_strip(x) if self.d == 1 else self._over_model(self.swap(x), 1)

    def to_fine_rows(self, x):
        return x if self.m == 1 else coll.all_to_all(x, 1, 2, self.model_group)

    def from_fine_rows(self, x):
        return x if self.m == 1 else coll.all_to_all(x, 2, 1, self.model_group)

    def fine_rows_whole(self, x):
        return self._over_data(self._over_model(x, 1), 1)

    def to_fine_cols(self, x):
        return x if self.d == 1 else coll.all_to_all(x, 1, 2, self.data_group)

    def from_fine_cols(self, x):
        return x if self.d == 1 else coll.all_to_all(x, 2, 1, self.data_group)

    def fine_cols_whole(self, x):
        return self._over_model(self._over_data(x, 1), 1)

    def whole_t(self, x):
        """A transposed block (B, N/M, N/D, H) gathered whole."""
        return self._over_model(self.row_strip_t(x), 1)

    # -- reductions -------------------------------------------------------
    def amax(self, t):
        t = t.clone()
        if self.m > 1:
            coll.all_reduce(t, "max", self.model_group)
        if self.d > 1:
            coll.all_reduce(t, "max", self.data_group)
        return t

    def block_to_root(self, x):
        if self.m > 1:
            x = coll.gather(x, 2, self.model_group)
            if x is None:
                return None
        return x if self.d == 1 else coll.gather(x, 1, self.data_group)

    # -- parameters -------------------------------------------------------
    def _part(self, entry) -> tuple[int, int]:
        """(parts, this rank's index) along a dim a spec entry names."""
        if entry is None:
            return 1, 0
        return (self.m, self.c) if entry == MODEL else (self.d, self.r)

    def cut(self, t, spec: P):
        """This rank's shard of ``t`` (its own storage)."""
        for dim, entry in enumerate(spec):
            k, i = self._part(entry)
            if k > 1:
                t = t.narrow(dim, i * (t.shape[dim] // k), t.shape[dim] // k)
        return t.clone()

    def uncut(self, t, spec: P):
        """``t`` (a shard ``cut`` made) gathered whole."""
        for dim, entry in enumerate(spec):
            if entry is not None:
                t = self._over_model(t, dim) if entry == MODEL else self._over_data(t, dim)
        return t

    def whole_params(self, tree, specs):
        return _map2(self.uncut, tree, specs)


def pair_grid(mesh) -> PairGrid:
    """This rank's ``PairGrid`` on a ``DeviceMesh`` with a ``model`` dim and
    the data dims (``data``, or ``pod`` and ``data``, flattened pod-major
    into one group of the grid's rows, as JAX orders a dim that names
    both)."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import _disable_current_modes
    names = tuple(mesh.mesh_dim_names)
    dp = data_axes(mesh)
    axes = mesh_axes(mesh)
    d, m = math.prod(axes[a] for a in dp), axes[MODEL]
    with _disable_current_modes():
        table = mesh.mesh.permute(*[names.index(a) for a in (*dp, MODEL)]).reshape(d, m).tolist()
    if len(dp) == 1:
        data_group = mesh.get_group(dp[0])
    else:
        data_group, _ = dist.new_subgroups_by_enumeration(
            [[table[r][c] for r in range(d)] for c in range(m)])
    me = dist.get_rank()
    r, c = next((r, c) for r in range(d) for c in range(m) if table[r][c] == me)
    if mesh.size() == dist.get_world_size():
        # one collective over the whole grid first: a transpose's point-to-
        # point exchanges leave the diagonal cells out, and NCCL starts a
        # group's communicator only where every rank takes part
        dist.all_reduce(torch.zeros(1, device=mesh.device_type))
    return PairGrid(mesh.get_group(MODEL), data_group, d, m, r, c,
                    tuple(tuple(row) for row in table),
                    tuple((a, axes[a]) for a in (*dp, MODEL)))


def grid_params(params, grid: PairGrid):
    """(``params`` cut to this rank's shards by the reference's
    ``param_spec`` on the grid's mesh, the grid with their spec tree): what
    ``param_shardings(params, mesh, None)`` puts on a device, each leaf a
    tensor of its own (the whole ones may then be dropped)."""
    specs = param_specs(params, grid.mesh)
    return _map2(grid.cut, params, specs), dataclasses.replace(grid, specs=specs)


@contextlib.contextmanager
def sharded(shard: PairShard | PairGrid | None, n: int):
    """Run a forward of pair length ``n`` as ``shard``'s part: its rules
    are active (``constrain``; the serving rule for a ``PairShard``, the
    production rules for a ``PairGrid``) and the schemes' tensor- and
    channel-wide statistics are maxima over the shard's ranks
    (``global_amax``).
    ``shard`` None is the single-device forward: nothing is scoped."""
    if shard is None:
        yield
        return
    prev = getattr(_ACT, "shard", None)
    _ACT.shard = (shard, n)
    try:
        with act_rules(shard.rules()):
            yield
    finally:
        _ACT.shard = prev


def current_shard() -> PairShard | PairGrid | None:
    scope = getattr(_ACT, "shard", None)
    return None if scope is None else scope[0]


def global_amax(t):
    """``t`` (a maximum over this rank's part of an activation) as the
    maximum over the whole activation: all-reduced over the model group in
    a ``sharded`` scope, ``t`` itself outside one."""
    shard = current_shard()
    return t if shard is None else shard.amax(t)
