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
  * ``broadcast(x, src, group)``: in place, from global rank ``src``.

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
replay.
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
    """name -> {"calls", "bytes"} since the last ``reset_counts``."""
    with _LOCK:
        return {n: {"calls": _CALLS[n], "bytes": _BYTES[n]} for n in NAMES}


def reset_counts() -> None:
    with _LOCK:
        _CALLS.clear()
        _BYTES.clear()


def group_size(group) -> int:
    return dist.get_world_size(group)


def host_staged(x: torch.Tensor, group) -> bool:
    """True where ``x`` is a CUDA tensor and the group has no NCCL."""
    return x.is_cuda and "nccl" not in str(dist.get_backend(group))


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
