"""RecurrentGemma / Griffin: RG-LRU recurrent blocks + local attention, 2:1
pattern [arXiv:2402.19427] (port of ``repro/models/hybrid.py``).

Prefill runs the RG-LRU with a log-depth scan (the reference's
``jax.lax.associative_scan``: ceil(log2 S) whole-sequence steps, not a loop
over time); decode carries the (B, lru_width) hidden state.  Layers group
into periods of ``attn_every`` ([rec, rec, attn] for RecurrentGemma) plus a
tail of leftover recurrent layers.  The scan is plain PyTorch, as it is
plain XLA in the reference (no Pallas kernel).

Parameters: ``periods`` is a list of per-period dicts ``{'b0', 'b1', ...}``
(the reference stacks them on a leading axis), ``tail`` a list.  The decode
cache keeps the reference's layout (each period entry stacked on a leading
period axis) and is written in place.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding as sh

Params = dict[str, Any]
_C = 8.0   # RG-LRU decay sharpness constant (Griffin paper)


def _lru_width(cfg: ArchConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def init_rglru_block(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, w, dt, dev = cfg.d_model, _lru_width(cfg), cfg.torch_dtype, gen.device
    lam = torch.rand((w,), generator=gen, device=dev) * (0.999 - 0.9) + 0.9
    return {
        "norm": tf._norm_init(cfg, dev),
        "in_x": cm.dense_init(gen, d, w, dtype=dt),
        "in_gate": cm.dense_init(gen, d, w, dtype=dt),
        "conv_w": (torch.randn((cfg.hybrid.conv_width, w), generator=gen, device=dev)
                   * 0.1).to(dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=dev),
        "gate_a": cm.dense_init(gen, w, w, dtype=dt),      # recurrence gate
        "gate_i": cm.dense_init(gen, w, w, dtype=dt),      # input gate
        "lam": lam.to(dt),
        "out": cm.dense_init(gen, w, d, dtype=dt),
        "mlp_norm": tf._norm_init(cfg, dev),
        "mlp": tf.init_mlp(gen, cfg),
    }


def _linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along axis 1 with h_{-1} = 0, in
    ceil(log2 S) steps (Hillis-Steele over the pairs (a, b), combined as
    (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2), in float32)."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _rglru(x, gate_in, p, state=None, aaq: AAQConfig = DISABLED):
    """h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t);  x (B,S,W).
    Returns (h (B,S,W) float32, the last h (B,W))."""
    r = torch.sigmoid(cm.dense(p["gate_a"], gate_in).float())
    i = torch.sigmoid(cm.dense(p["gate_i"], gate_in).float())
    lam = F.softplus(p["lam"].float())
    a = torch.exp(-_C * lam[None, None] * r)                 # (B,S,W) in (0, 1]
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * x.float())
    if x.shape[1] == 1 and state is not None:                # decode step
        h = aaq.act(a[:, 0] * state.float() + gated[:, 0], "hybrid.rnn_state")
        return h[:, None], h
    if state is not None:
        gated = torch.cat([gated[:, :1] + a[:, :1] * state.float()[:, None], gated[:, 1:]],
                          dim=1)
    h = aaq.act(_linear_scan(a, gated), "hybrid.rnn_state")
    return h, h[:, -1]


def rglru_block_apply(p, x, cfg: ArchConfig, *, positions=None, cache=None,
                      aaq: AAQConfig = DISABLED):
    """Griffin recurrent block: norm -> (conv + RG-LRU) x gelu-gate -> out,
    then the MLP.  ``cache``: this layer's {'state': (B, W), 'conv':
    (B, K-1, W)} views, advanced in place."""
    h = tf.apply_norm(p["norm"], aaq.act(x, "lm.pre_ln"), cfg)
    xb = cm.dense(p["in_x"], h)
    gate = tf._act("gelu", cm.dense(p["in_gate"], h))        # jax.nn.gelu: the tanh form
    kw = p["conv_w"].shape[0]
    if cache is None:
        conv_state = torch.zeros((x.shape[0], kw - 1, xb.shape[-1]), dtype=xb.dtype,
                                 device=xb.device)
    else:
        conv_state = cache["conv"].to(xb.dtype)
    full = torch.cat([conv_state, xb], dim=1)
    xc = sum(full[:, i:i + xb.shape[1]] * p["conv_w"][i] for i in range(kw)) + p["conv_b"]
    hseq, last = _rglru(xc, h, p, None if cache is None else cache["state"], aaq)
    x = x + cm.dense(p["out"], hseq.to(x.dtype) * gate)
    x = x + tf.mlp_apply(p["mlp"], tf.apply_norm(p["mlp_norm"], x, cfg), cfg)
    if cache is not None:
        cache["state"].copy_(last)
        cache["conv"].copy_(full[:, -(kw - 1):])
    return x


def _n_periods_tail(cfg: ArchConfig) -> tuple[int, int]:
    """Periods of ``attn_every`` layers, and the leftover recurrent layers."""
    return cfg.layers // cfg.hybrid.attn_every, cfg.layers % cfg.hybrid.attn_every


def _init_period(gen: torch.Generator, cfg: ArchConfig) -> Params:
    last = cfg.hybrid.attn_every - 1
    return {f"b{j}": tf.init_block(gen, cfg) if j == last else init_rglru_block(gen, cfg)
            for j in range(cfg.hybrid.attn_every)}


def _period_apply(period, x, cfg, positions, aaq, caches=None):
    """caches: {'b0': layer cache, ...} (the attention layer's a
    ``LockstepRing``) or None."""
    last = cfg.hybrid.attn_every - 1
    for j in range(cfg.hybrid.attn_every):
        lc = None if caches is None else caches[f"b{j}"]
        fn = tf.block_apply if j == last else rglru_block_apply
        x = fn(period[f"b{j}"], x, cfg, positions=positions, cache=lc, aaq=aaq)
    return x


def init_hybrid_lm(gen: torch.Generator, cfg: ArchConfig, place=cm.as_made) -> Params:
    """``place``: as ``transformer.init_lm``'s, a part at a time."""
    n_periods, tail = _n_periods_tail(cfg)
    dt, dev = cfg.torch_dtype, gen.device
    p = {"embed": place(("embed",), cm.embed_init(gen, cfg.vocab, cfg.d_model, dt)),
         "periods": [place(("periods", i), _init_period(gen, cfg)) for i in range(n_periods)],
         "tail": [place(("tail", i), init_rglru_block(gen, cfg)) for i in range(tail)],
         "final_norm": place(("final_norm",), tf._norm_init(cfg, dev))}
    if not cfg.tie_embeddings:
        p["lm_head"] = place(("lm_head",), cm.dense_init(gen, cfg.d_model, cfg.vocab, dtype=dt))
    return p


def hybrid_forward(params, batch, cfg: ArchConfig, *, aaq: AAQConfig = DISABLED,
                   remat=False, last_only=False, return_hidden=False):
    """Logits (B, S, V) f32 (the last position only with ``last_only``),
    or the final hidden states with ``return_hidden``.  ``remat``: each
    period recomputed in the backward (the reference's scan body), the
    tail as it is."""
    # (pinned as ``transformer.lm_hidden`` pins it: a sharded lookup is a
    # partial sum that every product after it would carry)
    x = sh.constrain(cm.embed(params["embed"], batch["tokens"]), "residual")
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for period in params["periods"]:
        x = tf.rematted(lambda y, period=period: sh.constrain(
            _period_apply(period, y, cfg, positions, aaq), "residual"), remat)(x)
    for p in params["tail"]:
        x = sh.constrain(rglru_block_apply(p, x, cfg, positions=positions, aaq=aaq),
                         "residual")
    x = tf.apply_norm(params["final_norm"], x, cfg)
    if return_hidden:
        return x
    if last_only:
        x = x[:, -1:]
    return sh.constrain(tf.unembed(params, x, cfg), "logits")


def hybrid_loss(params, batch, cfg: ArchConfig, *, aaq: AAQConfig = DISABLED, remat=True):
    x = hybrid_forward(params, batch, cfg, aaq=aaq, remat=remat, return_hidden=True)
    return tf.chunked_xent(params, x, batch["labels"], cfg)


def _rnn_cache(cfg: ArchConfig, lead: tuple, batch: int, dt, device) -> Params:
    w = _lru_width(cfg)
    return {"state": torch.zeros(lead + (batch, w), dtype=dt, device=device),
            "conv": torch.zeros(lead + (batch, cfg.hybrid.conv_width - 1, w), dtype=dt,
                                device=device)}


def init_hybrid_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None):
    dt = dtype or cfg.torch_dtype
    window = min(max_len, cfg.hybrid.window)
    n_periods, tail = _n_periods_tail(cfg)
    last = cfg.hybrid.attn_every - 1
    kv = (n_periods, batch, window, cfg.n_kv_heads, cfg.hd)
    periods = {f"b{j}": _rnn_cache(cfg, (n_periods,), batch, dt, device)
               for j in range(last)}
    periods[f"b{last}"] = {"k": torch.zeros(kv, dtype=dt, device=device),
                           "v": torch.zeros(kv, dtype=dt, device=device)}
    return {"periods": periods, "tail": [_rnn_cache(cfg, (), batch, dt, device)
                                         for _ in range(tail)],
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def hybrid_decode_step(params, batch, cache, cfg: ArchConfig, *, aaq: AAQConfig = DISABLED):
    """One-token decode: ``batch['tokens']`` (B, 1); the cache from
    ``init_hybrid_cache``, written in place.  Returns (logits (B, 1, V) f32,
    the cache with ``pos`` advanced)."""
    x = cm.embed(params["embed"], batch["tokens"])
    pos = cache["pos"]
    positions = pos.reshape(1, 1).expand(x.shape[0], 1)
    last = cfg.hybrid.attn_every - 1
    pc = cache["periods"]
    for i, period in enumerate(params["periods"]):
        caches = {f"b{j}": {name: a[i] for name, a in pc[f"b{j}"].items()}
                  for j in range(last)}
        caches[f"b{last}"] = tf.LockstepRing(
            {"k": pc[f"b{last}"]["k"][i], "v": pc[f"b{last}"]["v"][i], "pos": pos})
        x = _period_apply(period, x, cfg, positions, aaq, caches=caches)
    for p, lc in zip(params["tail"], cache["tail"]):
        x = rglru_block_apply(p, x, cfg, positions=positions, cache=lc, aaq=aaq)
    x = tf.apply_norm(params["final_norm"], x, cfg)
    cache["pos"] = pos + 1
    return tf.unembed(params, x, cfg), cache
