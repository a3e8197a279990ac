"""Parameter bridge: the JAX reference's parameter pytrees, as nested dicts
of numpy arrays, to the port's parameters (and the fold's back).

The reference stacks the trunk's blocks on a leading axis for ``scan``
(``trunk.<leaf>`` of shape ``(blocks, ...)``), and an LM's ``blocks`` (and a
hybrid's ``periods``) too when its config scans layers (a list otherwise);
the port keeps one dict per block (``trunk[i].<leaf>``, ``blocks[i].<leaf>``).
Dense weights keep the ``(in, out)`` layout.
bfloat16 arrays (numpy's ``bfloat16`` extension type) move bit for bit.
This module imports neither JAX nor the reference: callers convert with
``np.asarray`` first.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:             # torch.from_numpy wants a writable buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def params_from_numpy(tree: dict[str, Any], cfg, device=None, dtype=None) -> dict:
    """Reference pytree (numpy leaves) -> port params on ``device`` (default
    CUDA), each leaf cast to ``dtype`` when given."""
    dev = resolve_device(device)
    conv = lambda a: _to_tensor(np.asarray(a), dev, dtype)  # noqa: E731
    out = {k: _map(v, conv) for k, v in tree.items() if k != "trunk"}
    stacked = tree["trunk"]
    out["trunk"] = [_map(stacked, lambda a, i=i: conv(np.asarray(a)[i]))
                    for i in range(cfg.blocks)]
    return out


#: LM entries that the reference stacks on a leading axis for ``scan`` (a
#: list when the config does not scan): the layers, and the hybrid's periods
_LM_STACKED = ("blocks", "periods")


def lm_params_from_numpy(tree: dict[str, Any], cfg, device=None, dtype=None) -> dict:
    """Reference LM pytree (``repro.models.lm.init_params``, numpy leaves),
    any kind -> port params on ``device`` (default CUDA).  ``blocks`` (and
    the hybrid's ``periods``, dicts ``b0..``) stacked for ``scan`` become
    lists of per-layer dicts, one per index of the leading axis; lists
    (the layers the reference does not scan: the hybrid's ``tail``, the
    enc-dec's ``enc_blocks``/``dec_blocks``) stay lists; every other entry
    (``first_block``, norms, embeddings, ``lm_head``) converts leaf by leaf.
    The MoE experts keep their own stacked axis inside each block."""
    dev = resolve_device(device)
    conv = lambda a: _to_tensor(np.asarray(a), dev, dtype)  # noqa: E731
    out = {}
    for k, v in tree.items():
        if k in _LM_STACKED and isinstance(v, dict):
            n = np.asarray(_first_leaf(v)).shape[0]
            out[k] = [_map(v, lambda a, i=i: conv(np.asarray(a)[i])) for i in range(n)]
        else:
            out[k] = _map(v, conv)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16 type; shipped with the reference's stack
        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: dict[str, Any]) -> dict[str, Any]:
    """Inverse of :func:`params_from_numpy`: restack the trunk's blocks."""
    out = {k: _map(v, _to_numpy) for k, v in params.items() if k != "trunk"}
    blocks = [_map(b, _to_numpy) for b in params["trunk"]]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    out["trunk"] = stack(*blocks)
    return out
