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
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

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
    """Pin ``x`` to the spec the active rules give ``name``: inside a
    ``sharded`` scope every dim the spec puts on ``model`` must hold the
    rank's share (n / size) of the scope's pair length.  Raises where it
    does not; ``x`` itself passes through (the port's tensors are the
    shards, nothing is moved) and its shape is kept in ``PINNED``."""
    rules = getattr(_ACT, "rules", None)
    scope = getattr(_ACT, "shard", None)
    if not rules or name not in rules or scope is None:
        return x
    shard, n = scope
    for dim, entry in enumerate(rules[name]):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if MODEL in axes and x.shape[dim] != n // shard.size:
            raise ValueError(f"constrain({name!r}): dim {dim} holds {x.shape[dim]}, "
                             f"the rank's shard is {n // shard.size} of {n}")
    PINNED[name] = tuple(x.shape)
    return x


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
