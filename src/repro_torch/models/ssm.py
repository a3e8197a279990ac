"""Mamba-2: State Space Duality (SSD), chunked dual form [arXiv:2405.21060]
(port of ``repro/models/ssm.py``).

Prefill uses the chunked algorithm (quadratic within chunks, linear state
passing across chunks: the chunk-local work is batched products).  Decode
carries the (B, H, P, N) state, O(1) in sequence length.  The chunk loop
and the decode recurrence are plain PyTorch, as they are plain XLA in the
reference (no Pallas kernel).

AAQ hook: the inter-chunk states and the decode state are token-like
(trailing feature axis) and pass through ``aaq.act(., 'ssm.state')``.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.models import common as cm
from repro_torch.parallel import sharding as sh

Params = dict[str, Any]


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.d_state, s.head_dim


def init_ssm_block(gen: torch.Generator, cfg: ArchConfig) -> Params:
    s, dev, dt = cfg.ssm, gen.device, cfg.torch_dtype
    d_inner, n_heads, n, _ = _dims(cfg)
    conv_dim = d_inner + 2 * n                       # x, B, C share the conv
    return {
        "norm": cm.rms_init(cfg.d_model, dt, dev),
        # in_proj -> [z (gate), xBC (conv'd), dt]
        "in_proj": cm.dense_init(gen, cfg.d_model, 2 * d_inner + 2 * n + n_heads, dtype=dt),
        "conv_w": (torch.randn((s.conv_width, conv_dim), generator=gen, device=dev)
                   * 0.1).to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                        device=dev)).to(dt),
        "D": torch.ones((n_heads,), dtype=dt, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=dt, device=dev),
        "out_norm": cm.rms_init(d_inner, dt, dev),
        "out_proj": cm.dense_init(gen, d_inner, cfg.d_model, dtype=dt),
    }


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv, width K, then SiLU.  xbc (B,S,C); state
    (B,K-1,C) or None.  Returns (out (B,S,C), new_state (B,K-1,C))."""
    kw = w.shape[0]
    if state is None:
        state = torch.zeros((xbc.shape[0], kw - 1, xbc.shape[-1]), dtype=xbc.dtype,
                            device=xbc.device)
    full = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    out = sum(full[:, i:i + xbc.shape[1]] * w[i] for i in range(kw)) + b
    return F.silu(out), full[:, -(kw - 1):]


def _segsum_decay(a_cum):
    """L[i,j] = exp(a_cum_i - a_cum_j) masked to i >= j. a_cum (..., L).

    Mask BEFORE exp: for i < j the exponent is positive (decays accumulate
    downward) and exp overflows to inf."""
    li = a_cum[..., :, None] - a_cum[..., None, :]
    n = li.shape[-1]
    mask = torch.ones((n, n), dtype=torch.bool, device=li.device).tril()
    return torch.exp(torch.where(mask, li, torch.full((), -1e30, device=li.device)))


def ssd_chunked(x, dt, A, B, C, D, chunk: int, aaq: AAQConfig = DISABLED,
                init_state=None):
    """SSD chunked dual form.
    x (b,s,h,p); dt (b,s,h); A (h,) (negative); B,C (b,s,n); D (h,).
    Returns (y (b,s,h,p), final_state (b,h,p,n))."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    sp = x.shape[1]
    nc, q = sp // chunk, chunk
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)

    a_bar = dtc * A[None, None, None]                       # (b,nc,q,h) <= 0
    a_cum = torch.cumsum(a_bar, dim=2)
    xdt = xc * dtc[..., None]

    # intra-chunk (quadratic within chunk)
    L = _segsum_decay(a_cum.movedim(-1, -2))                # (b,nc,h,q,q)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)        # (b,nc,q,q)
    y_diag = torch.einsum("bchls,bcls,bcshp->bclhp", L, scores, xdt)

    # chunk states and the inter-chunk recurrence
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)   # (b,nc,q,h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, decay_states, xdt)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])             # (b,nc,h)
    carry = (init_state if init_state is not None
             else torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)).to(x.dtype)
    prev = []
    for c in range(nc):                                      # emit the state BEFORE chunk c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = aaq.act(torch.stack(prev, dim=1), "ssm.state")   # (b,nc,h,p,n)

    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states, torch.exp(a_cum))
    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    y = y + x[:, :s] * D[None, None, :, None]
    return y, carry


def ssm_block_apply(p, x, cfg: ArchConfig, *, positions=None, cache=None,
                    aaq: AAQConfig = DISABLED):
    """Full mamba2 block: norm -> in_proj -> conv -> SSD -> gated out, plus
    the residual.  ``cache``: this layer's {'state', 'conv'} (a
    ``transformer.LockstepRing``), advanced in place."""
    d_inner, n_heads, n, hd = _dims(cfg)
    b, sl, _ = x.shape
    h = cm.rmsnorm(p["norm"], aaq.act(x, "lm.pre_ln"))
    if cache is None and sh.is_dtensor(h) and _heads_divide(p["in_proj"]["w"], n_heads):
        y, z = _ssm_sharded(p, h, cfg, aaq)
        y = cm.rmsnorm(p["out_norm"], y.reshape(b, sl, d_inner).to(x.dtype)) * F.silu(z)
        return x + cm.dense(p["out_proj"], y)
    zxbcdt = cm.dense(p["in_proj"], h)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = F.softplus(zxbcdt[..., -n_heads:].float() + p["dt_bias"].float())

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                                 conv_state)
    xs = xbc[..., :d_inner].reshape(b, sl, n_heads, hd)
    Bm = xbc[..., d_inner:d_inner + n]
    Cm = xbc[..., d_inner + n:]
    A = -torch.exp(p["A_log"].float())
    Df = p["D"].float()

    if cache is None:
        y, _ = ssd_chunked(xs.float(), dt, A, Bm.float(), Cm.float(), Df, cfg.ssm.chunk, aaq)
    else:
        st = cache["state"].float()                          # (b,h,p,n)
        dA = torch.exp(dt[:, 0] * A[None])                   # (b,h)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xs[:, 0].float(), Bm[:, 0].float())
        st = aaq.act(st * dA[..., None, None] + upd, "ssm.state")
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), st)
        y = (y + xs[:, 0].float() * Df[None, :, None])[:, None]   # (b,1,h,p)
        cache["state"].copy_(st)
        cache["conv"].copy_(new_conv)
    y = y.reshape(b, sl, d_inner).to(x.dtype)
    y = cm.rmsnorm(p["out_norm"], y) * F.silu(z)
    return x + cm.dense(p["out_proj"], y)


def _heads_divide(w, n_heads: int) -> bool:
    """Do the mesh dims that shard ``in_proj``'s columns divide the heads?"""
    return n_heads % sh.columns_shards(w) == 0


def _ssm_sharded(p, h, cfg: ArchConfig, aaq: AAQConfig):
    """A sharded prefill or training step's block up to the gate (y (B, S,
    H, P) and z), as GSPMD keeps it: ``in_proj`` (and the conv) cut into
    their z / x / (B, C) / dt columns at use, z, x and dt sharded on their
    own columns (the heads) and B, C made whole (every head reads them), so
    no activation is gathered; the SSD on each rank's rows and heads."""
    d_inner, n_heads, n, _ = _dims(cfg)
    w, cw, cb = p["in_proj"]["w"], p["conv_w"], p["conv_b"]
    cuts = ((0, d_inner, True), (d_inner, 2 * d_inner, True),
            (2 * d_inner, 2 * d_inner + 2 * n, False), (2 * d_inner + 2 * n, None, True))
    z, xr, bc, dtr = (cm.dense({"w": sh.columns(w, lo, hi, keep)}, h) for lo, hi, keep in cuts)
    dt = F.softplus(dtr.float() + p["dt_bias"].float())
    xs, _ = _causal_conv(xr, sh.columns(cw, 0, d_inner, True).to(h.dtype),
                         sh.columns(cb, 0, d_inner, True).to(h.dtype))
    bc, _ = _causal_conv(bc, sh.columns(cw, d_inner, None, False).to(h.dtype),
                         sh.columns(cb, d_inner, None, False).to(h.dtype))
    xs = xs.reshape(*xs.shape[:2], n_heads, -1)
    A = -torch.exp(p["A_log"].float())
    y = sh.heads_local(lambda x_, dt_, a_, b_, c_, d_: ssd_chunked(
        x_, dt_, a_, b_, c_, d_, cfg.ssm.chunk, aaq)[0],
        xs.float(), dt, A, bc[..., :n].float(), bc[..., n:].float(), p["D"].float())
    return y, z


def init_ssm_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None):
    s = cfg.ssm
    d_inner, n_heads, n, hd = _dims(cfg)
    dt = dtype or cfg.torch_dtype
    return {
        "state": torch.zeros((cfg.layers, batch, n_heads, hd, n), dtype=dt, device=device),
        "conv": torch.zeros((cfg.layers, batch, s.conv_width - 1, d_inner + 2 * n), dtype=dt,
                            device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }

