"""Shared functional building blocks (port of ``repro/models/common.py``).

Params are plain nested dicts of tensors with the reference's layout: a
dense layer is ``{"w": (in, out), "b": (out,)}`` and applies as ``x @ w``.
Every init function takes an explicit ``torch.Generator`` (its device is
where the parameters are made); the numbers differ from ``jax.random``'s,
so parity tests bring the reference's parameters through ``bridge``.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.device import per_row
from repro_torch.parallel import sharding as sh

Params = dict[str, Any]


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               scale: float | None = None, dtype=torch.float32) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def as_made(path: tuple, part):
    """The default ``place`` of the model inits: a part as it was made."""
    return part


def ln_init(dim: int, dtype=torch.float32, device=None) -> Params:
    return {"g": torch.ones((dim,), dtype=dtype, device=device),
            "b": torch.zeros((dim,), dtype=dtype, device=device)}


def rms_init(dim: int, dtype=torch.float32, device=None) -> Params:
    return {"g": torch.ones((dim,), dtype=dtype, device=device)}


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype=torch.float32) -> Params:
    e = torch.randn((vocab, dim), generator=gen, device=gen.device) * 0.02
    return {"e": e.to(dtype)}


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------
def dense(p: Params, x: torch.Tensor, scheme=None, site: str = "") -> torch.Tensor:
    """Linear layer routed through the active quantization scheme."""
    if scheme is not None:
        return scheme.linear(x, p["w"].to(x.dtype), p.get("b"), site)
    w = p["w"].to(x.dtype)
    y = per_row(lambda t: sh.fold_matmul(t, w), x)   # f32 accumulation, x's dtype out
    return y if "b" not in p else y + p["b"].to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32; the variance is the population variance
    (``jnp.var``), hence ``correction=0``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * p["g"]).to(x.dtype)


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of the table; a DTensor table (a sharded train step)
    looks up vocabulary-parallel (``sharding.embedding``)."""
    if sh.is_dtensor(p["e"]):
        return sh.embedding(ids, p["e"])
    return torch.nn.functional.embedding(ids, p["e"])


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with every product accumulated in float32 and a float32
    result (``jnp.dot(..., preferred_element_type=jnp.float32)``).  On the
    card a bf16 product keeps its bf16 operands (``out_dtype``); the CPU has
    no such product, and DTensor no sharding rule for it, so there the
    operands are widened (exact for bf16; the dry-run counts the copies
    apart, ``sharding.widening``)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return sh.fold_matmul(x, w)
    if x.device.type == "cuda" and x.dtype == w.dtype and not sh.is_dtensor(x):
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*lead, w.shape[-1])
    with sh.widening():
        x, w = x.float(), w.float()
    return sh.fold_matmul(x, w)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10000.0,
               rotary_frac: float = 1.0) -> torch.Tensor:
    rot_dim = int(head_dim * rotary_frac)
    return 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32) / rot_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    Rotates interleaved pairs (``x[..., 0::2]``, ``x[..., 1::2]``) of the
    leading ``rotary_frac`` of the head dim (ChatGLM's partial rotary)."""
    d = x.shape[-1]
    rot = int(d * rotary_frac)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=x.device) / rot))
    ang = positions[..., None].float() * inv                   # (..., S, rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1, o2 = x1 * cos - x2 * sin, x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(*x1.shape[:-1], rot).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < d else out


# --------------------------------------------------------------------------
# attention masks
# --------------------------------------------------------------------------
NEG_INF = -1e9


def key_padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """(..., N) bool key mask -> additive f32 bias: 0 real, NEG_INF padded.

    NEG_INF underflows to exactly 0.0 through float32 softmax's exp, so
    padded keys contribute literal +0.0 to the normalizer.  Every masked
    attention path (trunk, structure module) uses this helper.  The two
    constants are Python scalars, not tensors made on the device: building
    a tensor from a host value is a host-to-device copy, which a CUDA graph
    capture does not allow.
    """
    return torch.where(mask, 0.0, NEG_INF).float()


def causal_mask(q_len: int, kv_len: int, *, window: int | None = None,
                q_offset: int = 0, device=None) -> torch.Tensor:
    """(q_len, kv_len) additive mask. ``window`` = sliding-window attention."""
    qpos = torch.arange(q_len, device=device)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).float()


def _leaves(params):
    if isinstance(params, dict):
        for v in params.values():
            yield from _leaves(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from _leaves(v)
    else:
        yield params


def count_params(params) -> int:
    return sum(p.numel() for p in _leaves(params))


def param_bytes(params) -> int:
    return sum(p.numel() * p.element_size() for p in _leaves(params))
