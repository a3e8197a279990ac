"""Atomic, async checkpointing (port of ``repro/checkpoint/checkpointing.py``),
on the reference's on-disk layout, so a checkpoint the reference wrote
restores into the port and back, for every config.

Layout per step:  <dir>/step_<n>/
    manifest.json           treedef, shapes, dtypes, step metadata
    arr_<i>.npy             one file per leaf (host-local full array)

Leaves are numbered in ``jax.tree`` flatten order (dict keys sorted, lists
in order; ``repro_torch.tree.leaves``).  The reference stacks an LM's
``blocks`` on a leading layer axis when its config scans layers
(``scan_layers``, every config but recurrentgemma's and whisper's) and a
hybrid's ``periods`` always; the port keeps lists of per-layer dicts.  Given
the model's config (``cfg=``), ``save`` stacks each such list into the
reference's leaves on the host, wherever it sits in the tree (the
parameters and the AdamW moments that mirror them), and ``restore`` splits
them back; MoE's dense ``first_block`` and the lists the reference keeps
(a hybrid's ``tail``, the enc-dec's blocks) stay as they are
(``stacked_entries``).  Without ``cfg`` the tree is written as it is.
``restore`` checks every shape against the template.

Guarantees:
  * atomicity: writes land in ``.tmp-step_<n>`` and are renamed only after
    the manifest is fsynced; a crash mid-save never corrupts the latest step,
  * retention: the ``keep_last_k`` newest steps are kept, older ones removed
    after a successful save (never before),
  * async: ``AsyncCheckpointer.save_async`` copies the tensors to the host
    (blocking only for the copy) and writes on a worker thread.

Sharded state (DTensor leaves, a ``--model-parallel`` run): a checkpoint
holds the host view, the whole array a leaf, as the reference's does, so it
is mesh-agnostic.  Every rank gathers each DTensor leaf (``full_tensor``)
on the caller's thread, one leaf at a time in leaf order (a collective on
the writer thread could hang its peers), only global rank 0 copies it to
the host and writes, and the layers stack there.  ``restore(...,
shardings=)`` splits a stacked array on the host and distributes each
layer's leaf to its ``NamedSharding``'s placements; a DTensor template leaf
without one takes the template's.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.parallel import sharding as sh
from repro_torch.tree import leaves, unflatten


def _writer() -> bool:
    """Does this process write checkpoints (global rank 0, or no group)?"""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _host(leaf, snapshot: bool = False) -> np.ndarray:
    """A leaf as a host numpy array (bf16 tensors as numpy's bfloat16; a
    DTensor gathered whole first, a collective); ``snapshot``: never a
    view of the leaf's memory (a device leaf's host copy is one already)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if sh.is_dtensor(t):
            t = t.full_tensor()
        t = t.clone() if snapshot and t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes   # numpy's bfloat16 type
            return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.array(leaf) if snapshot else np.asarray(leaf)


def _treedef(tree) -> str:
    """A description of the tree's shape for the manifest (the reference
    writes JAX's ``PyTreeDef``; neither side parses it back)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def stacked_entries(cfg) -> tuple[str, ...]:
    """The dict entries the reference stacks on a leading layer axis for
    ``cfg`` (none without one): a hybrid's ``periods`` always, ``blocks``
    when the config scans its layers (``repro/models/transformer.py``
    ``init_lm``, ``repro/models/hybrid.py`` ``init_hybrid_lm``)."""
    if cfg is None:
        return ()
    return ("blocks", "periods") if cfg.scan_layers else ("periods",)


class _Layers:
    """One leaf of the reference's tree that the port holds a layer at a
    time: the per-layer parts, in layer order."""
    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = parts


def _combine(layers: list, combine):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _combine([lay[k] for lay in layers], combine) for k in first}
    if isinstance(first, (list, tuple)):
        return [_combine([lay[i] for lay in layers], combine) for i in range(len(first))]
    return combine(layers)


def _stacked(tree, keys: tuple[str, ...], combine):
    """``tree`` in the reference's layout: each ``keys`` entry that is a
    list of per-layer dicts becomes one dict of that structure whose leaves
    are ``combine`` of the layers' leaves."""
    if isinstance(tree, dict):
        return {k: (_combine(v, combine) if k in keys and isinstance(v, list) and v
                    else _stacked(v, keys, combine)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_stacked(v, keys, combine) for v in tree]
    return tree


def stack_layers(tree, cfg):
    """A tree of host arrays in the reference's layout for ``cfg``: the
    lists of ``stacked_entries(cfg)`` stacked on a leading axis."""
    return _stacked(tree, stacked_entries(cfg), np.stack)


def _gathered(tree, snapshot: bool = False) -> list | None:
    """The writer's host arrays of ``tree``'s leaves (None on another
    rank); every rank takes part in each DTensor leaf's gather, in leaf
    order, and only the writer copies it to the host."""
    if _writer():
        return [_host(x, snapshot) for x in leaves(tree)]
    for x in leaves(tree):
        if sh.is_dtensor(x):
            x.full_tensor()                 # the writer's gather needs this rank
    return None


def save(ckpt_dir: str, step: int, tree, keep_last_k: int = 3, cfg=None) -> str:
    """Write ``tree`` as step ``step``, its layers stacked as the reference
    stacks ``cfg``'s; with a process group, every rank calls it (DTensor
    leaves are gathered) and rank 0 alone writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = _gathered(tree)
    if flat is None:
        return final
    tree = stack_layers(unflatten(tree, flat), cfg)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = leaves(tree)
    manifest = {"step": step, "treedef": _treedef(tree), "n_leaves": len(flat),
                "dtypes": [], "shapes": []}
    for i, arr in enumerate(flat):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest["dtypes"].append(str(arr.dtype))
        manifest["shapes"].append(list(arr.shape))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last_k)
    return final


def _gc(ckpt_dir: str, keep_last_k: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last_k]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot to the host synchronously, write to disk on a worker thread.

    ``records`` gets one dict a finished save: its step, the host snapshot's
    and the write's wall time (ms) and the bytes of the arrays."""

    def __init__(self, ckpt_dir: str, keep_last_k: int = 3, cfg=None):
        self.ckpt_dir = ckpt_dir
        self.keep_last_k = keep_last_k
        self.cfg = cfg
        self.records: list[dict] = []
        self._thread: threading.Thread | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree) -> None:
        self.wait()                                   # one in flight
        t0 = time.perf_counter()
        # DTensor leaves gather here, on the caller's thread, on every rank
        flat = _gathered(tree, snapshot=True)
        if flat is None:
            return
        rec = {"step": step, "snapshot_ms": (time.perf_counter() - t0) * 1e3,
               "bytes": sum(a.nbytes for a in flat)}

        def write():
            t1 = time.perf_counter()
            save(self.ckpt_dir, step, unflatten(tree, flat), self.keep_last_k, self.cfg)
            rec["write_ms"] = (time.perf_counter() - t1) * 1e3
            self.records.append(rec)

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def _tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":      # (ascontiguousarray makes a 0-d array 1-d)
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.reshape(arr.shape).to(device=device, dtype=dtype or t.dtype)


def _like(arr: np.ndarray, template, sharding=None):
    """``arr`` as the template leaf's kind: a tensor of its dtype on its
    device, else a numpy array; a DTensor of ``sharding``'s placements
    (else a DTensor template's) on that mesh, each rank keeping its shard."""
    if isinstance(template, torch.Tensor) and tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf of shape {arr.shape} does not match the "
                         f"template's {tuple(template.shape)}")
    if sharding is not None:
        mesh, to = sharding.mesh, sharding.placements
    elif sh.is_dtensor(template):
        mesh, to = template.device_mesh, tuple(template.placements)
    elif isinstance(template, torch.Tensor):
        return _tensor(arr, template.dtype, template.device)
    else:
        return arr
    from torch.distributed.tensor import distribute_tensor
    dtype = template.dtype if isinstance(template, torch.Tensor) else None
    return distribute_tensor(_tensor(arr, dtype, mesh.device_type), mesh, to,
                             src_data_rank=None)


def restore(ckpt_dir: str, template, step: int | None = None, shardings=None, cfg=None):
    """Restore onto the template's tree: (step, tree), each tensor leaf on
    its template leaf's device and dtype, the layers ``save`` stacked for
    ``cfg`` split back (on the host); with ``shardings`` (a
    ``NamedSharding`` tree of the template's shape, possibly on another
    mesh than the one that saved: the elastic path) each leaf distributed
    to its placements."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = leaves(template)
    # each file's template leaves, by their place in ``flat``
    slots = leaves(_stacked(unflatten(template, list(range(len(flat)))),
                            stacked_entries(cfg), _Layers))
    if len(slots) != manifest["n_leaves"]:
        raise ValueError(f"template has {len(slots)} leaves, checkpoint "
                         f"{manifest['n_leaves']}")
    shards = leaves(shardings) if shardings is not None else [None] * len(flat)
    out = [None] * len(flat)
    for i, slot in enumerate(slots):
        arr = np.load(os.path.join(d, f"arr_{i}.npy"))
        if not isinstance(slot, _Layers):
            out[slot] = _like(arr, flat[slot], shards[slot])
            continue
        if arr.shape[:1] != (len(slot.parts),):
            raise ValueError(f"checkpoint leaf of shape {arr.shape} does not stack "
                             f"the template's {len(slot.parts)} layers")
        for layer, j in zip(arr, slot.parts):
            out[j] = _like(layer, flat[j], shards[j])
    return step, unflatten(template, out)
