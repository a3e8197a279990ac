"""Explicit collectives over a process group (the port's own module: GSPMD
inserts these implicitly in the reference).

  * ``all_gather(x, dim, group)``: every rank's ``x`` concatenated along
    ``dim`` in rank order;
  * ``all_to_all(x, split_dim, cat_dim, group)``: ``x`` cut into W equal
    pieces along ``split_dim``, piece r sent to rank r, the W pieces
    received concatenated along ``cat_dim`` in rank order;
  * ``all_reduce(x, op, group)``: in place, ``op`` "sum" or "max";
  * ``gather(x, dim, group)``: the concatenation on the group's rank 0,
    ``None`` on the others;
  * ``broadcast(x, src, group)``: in place, from global rank ``src``;
  * ``permute(x, perm, group)``: ``jax.lax.ppermute``, each (src, dst)
    pair of group ranks a send of ``x`` (zeros where a rank receives
    nothing), through ``batch_isend_irecv``; autograd-aware: the gradient
    goes back along the inverse permutation (a ring's too: ``[(i, i+1 mod
    W)]``); ``RingShift`` is one step of a ring left in flight;
  * ``exchange(sends, recvs, group)``: point-to-point sends and receives
    between named ranks in one batch (a block transpose over a grid);
  * ``reduce_scatter(x, dim, group)``: the sum over the group, cut along
    ``dim`` in W pieces, piece r to rank r (``psum_scatter``, tiled);
    autograd-aware: the gradient is the all-gather of the pieces' ones;
  * ``all_reduce_sum(x, group)``: out of place, autograd-aware, for a sum
    that every rank then uses as its own copy of one value (GPipe's last
    stage broadcast to every stage): the gradient of each rank's term is
    its own copy's, unreduced.

Routes.  On NCCL (a group whose backend names ``nccl``, CUDA tensors) each
is the one ``torch.distributed`` call, which a CUDA graph can capture.
Gloo has no all-gather and no all-to-all for CUDA tensors, so with a gloo
group a CUDA tensor is staged through the host: copied to the CPU, the
collective run there, the result copied back.  That route synchronises
with the host and cannot sit inside a CUDA graph: the engine runs such
keys eagerly.  CPU tensors take gloo directly.

Every call is counted by name, with the bytes this rank hands the
collective (``counts()``, ``reset_counts()``), as ``dispatch`` counts
kernel launches; inside a CUDA graph the count moves at capture, not at
replay.  ``counting_dtensor()`` adds the collectives DTensor issues (a
sharded train step's redistributions) to the same counts, by the name of
their kind.
"""
from __future__ import annotations

import threading
from collections import Counter

import torch
import torch.distributed as dist

NAMES = ("all_gather", "all_to_all", "all_reduce", "gather", "broadcast")

_LOCK = threading.Lock()
_CALLS: Counter = Counter()
_BYTES: Counter = Counter()


def _note(name: str, x: torch.Tensor) -> None:
    with _LOCK:
        _CALLS[name] += 1
        _BYTES[name] += x.numel() * x.element_size()


def counts() -> dict[str, dict[str, int]]:
    """name -> {"calls", "bytes"} since the last ``reset_counts``: every
    name of ``NAMES``, and ``permute``/``reduce_scatter`` once called."""
    with _LOCK:
        names = (*NAMES, *sorted(n for n in _CALLS if n not in NAMES))
        return {n: {"calls": _CALLS[n], "bytes": _BYTES[n]} for n in names}


def reset_counts() -> None:
    with _LOCK:
        _CALLS.clear()
        _BYTES.clear()


def group_size(group) -> int:
    return dist.get_world_size(group)


def host_staged(x: torch.Tensor, group) -> bool:
    """True where ``x`` is a CUDA tensor and the group has no NCCL (nor is
    the dry-run's ``fake`` group, which takes fake CUDA tensors as NCCL
    would)."""
    backend = str(dist.get_backend(group))
    return x.is_cuda and "nccl" not in backend and "fake" not in backend


def _on_host(x: torch.Tensor, group):
    """(the tensor the collective runs on, the device to return to)."""
    if host_staged(x, group):
        return x.detach().to("cpu"), x.device
    return x, None


def _back(t: torch.Tensor, device) -> torch.Tensor:
    return t if device is None else t.to(device)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    _note("all_gather", x)
    w = group_size(group)
    dim = dim % x.dim()
    src, dev = _on_host(x.movedim(dim, 0).contiguous(), group)
    out = src.new_empty((w * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    # (W*S, ...) is the ranks' pieces one after another along the gathered dim
    return _back(out, dev).movedim(0, dim)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    _note("all_to_all", x)
    w = group_size(group)
    split_dim, cat_dim = split_dim % x.dim(), cat_dim % x.dim()
    if x.shape[split_dim] % w:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {w} ranks")
    # (W, piece...) with piece r the r-th cut of x along split_dim
    pieces = x.unflatten(split_dim, (w, -1)).movedim(split_dim, 0).contiguous()
    src, dev = _on_host(pieces, group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    out = _back(out, dev)                    # out[r]: the piece rank r sent here
    return out.movedim(0, cat_dim).flatten(cat_dim, cat_dim + 1)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    _note("all_reduce", x)
    src, dev = _on_host(x, group)
    dist.all_reduce(src, op=_OPS[op], group=group)
    if dev is not None:
        x.copy_(src)
    return x


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor | None:
    _note("gather", x)
    w = group_size(group)
    dim = dim % x.dim()
    src, dev = _on_host(x.contiguous(), group)
    root = dist.get_rank(group) == 0
    parts = [torch.empty_like(src) for _ in range(w)] if root else None
    dist.gather(src, parts, dst=dist.get_global_rank(group, 0), group=group)
    return _back(torch.cat(parts, dim=dim), dev) if root else None


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    _note("broadcast", x)
    t, dev = _on_host(x, group if group is not None else dist.group.WORLD)
    dist.broadcast(t, src=src, group=group)
    if dev is not None:
        x.copy_(t)
    return x


# --------------------------------------------------------------------------
# autograd-aware collectives (GPipe, the ring matmuls)
# --------------------------------------------------------------------------
def _send_recv(x: torch.Tensor, perm: tuple, group) -> torch.Tensor:
    me = dist.get_rank(group)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    out = torch.zeros_like(x)
    src_t, dev = _on_host(x.contiguous(), group)
    recv = torch.zeros_like(src_t)
    ops = [dist.P2POp(dist.isend, src_t, dist.get_global_rank(group, d), group)
           for d in dsts]
    ops += [dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, s), group)
            for s in srcs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if srcs:
        out.copy_(_back(recv, dev))
    return out


def exchange(sends, recvs, group=None) -> None:
    """Point to point in one ``batch_isend_irecv``: each (peer, tensor) of
    ``sends`` to global rank ``peer``, each (peer, buffer) of ``recvs``
    filled from ``peer`` in place; at most one of each a peer.  Counted as
    ``permute``, once for each tensor sent, with its bytes."""
    ops, back = [], []
    for peer, t in sends:
        _note("permute", t)
        src, _ = _on_host(t.contiguous(), group)
        ops.append(dist.P2POp(dist.isend, src, peer, group))
    for peer, buf in recvs:
        tgt, dev = _on_host(buf, group)
        ops.append(dist.P2POp(dist.irecv, tgt, peer, group))
        back.append((buf, tgt, dev))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for buf, tgt, dev in back:
        if dev is not None:
            buf.copy_(tgt)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group, anchor):
        ctx.perm, ctx.group = perm, group
        _note("permute", x)
        return _send_recv(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return permute(g.contiguous(), inv, ctx.group), None, None, None


def permute(x: torch.Tensor, perm, group, anchor: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.lax.ppermute(x, perm)`` over the group's ranks: for each
    (src, dst), rank src's ``x`` lands on rank dst; a rank no pair sends
    to gets zeros.  Its backward is the inverse exchange, which every rank
    of a pair must run: ``anchor`` (a tensor that requires grad) puts the
    exchange in the graph even where this rank's ``x`` does not require
    grad, so its peer's backward is never left waiting."""
    return _Permute.apply(x, tuple(tuple(p) for p in perm), group, anchor)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        _note("reduce_scatter", x)
        w = group_size(group)
        if x.shape[dim] % w:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not "
                             f"split over {w} ranks")
        src, dev = _on_host(x.movedim(dim, 0).contiguous(), group)
        out = src.new_empty((src.shape[0] // w, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=group)
        return _back(out, dev).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum of ``x``, rank r keeping the r-th of W equal pieces
    along ``dim`` (``psum_scatter(..., tiled=True)``)."""
    return _ReduceScatter.apply(x, dim % x.dim(), group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of ``x`` (a new tensor) that each rank uses as its
    own copy of one value: each rank's term gets its own copy's gradient
    (the loss counted once, not once a rank)."""
    return _AllReduceSum.apply(x, group)


# --------------------------------------------------------------------------
# DTensor's collectives, counted
# --------------------------------------------------------------------------
_FUNCOL = {"all_reduce": "all_reduce", "all_reduce_coalesced": "all_reduce",
           "all_gather_into_tensor": "all_gather",
           "all_gather_into_tensor_coalesced": "all_gather",
           "reduce_scatter_tensor": "reduce_scatter",
           "reduce_scatter_tensor_coalesced": "reduce_scatter",
           "all_to_all_single": "all_to_all", "broadcast": "broadcast"}


def counting_dtensor():
    """A scope (a ``TorchDispatchMode``) that counts every functional
    collective DTensor issues, forward and backward, into ``counts()``
    under its kind's name, with the bytes of its input: those of a
    redistribution inside an op too (a DTensor op is handed back to
    DTensor with the mode still active, so its local ops pass here)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if DTensor in types:
                return NotImplemented
            ns = getattr(func, "namespace", "")
            if ns == "_c10d_functional":
                name = _FUNCOL.get(func._opname)
                if name is not None:
                    first = args[0]
                    for t in (first if isinstance(first, (list, tuple)) else [first]):
                        _note(name, t)
            return func(*args, **(kwargs or {}))

    return _Count()


class RingShift:
    """One step of a ring, started now and finished by ``wait()``: rank i's
    ``x`` on its way to rank (i + shift) mod W while the caller computes
    (``isend``/``irecv``, counted as a ``permute``).  Not differentiable:
    the ring matmuls are forward primitives, as the reference's are."""

    def __init__(self, x: torch.Tensor, group, shift: int = 1):
        _note("permute", x)
        w = group_size(group)
        me = dist.get_rank(group)
        src, self._dev = _on_host(x.detach().contiguous(), group)
        self._buf = torch.empty_like(src)
        self._send = src
        # one group of both (NCCL deadlocks a ring of separate sends and receives)
        self._reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, dist.get_global_rank(group, (me + shift) % w), group),
            dist.P2POp(dist.irecv, self._buf, dist.get_global_rank(group, (me - shift) % w),
                       group)])

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        return _back(self._buf, self._dev)
