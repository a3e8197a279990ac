"""Whisper-style encoder-decoder backbone [arXiv:2212.04356] (port of
``repro/models/encdec.py``).

The conv audio frontend is a stub: the encoder consumes precomputed
(B, n_frames, d_model) frame embeddings (what the two conv layers would
produce).  Encoder = bidirectional self-attention; decoder = causal
self-attention + cross-attention to the encoder output.  LayerNorm
throughout (population variance, ``cm.layernorm``).  The decode cache is
the self-attention K/V ring per decoder layer plus the encoder output,
written in place.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding as sh

Params = dict[str, Any]


def init_enc_block(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dt, dev = cfg.torch_dtype, gen.device
    return {"attn_norm": cm.ln_init(cfg.d_model, dt, dev), "attn": tf.init_attn(gen, cfg),
            "mlp_norm": cm.ln_init(cfg.d_model, dt, dev), "mlp": tf.init_mlp(gen, cfg)}


def init_dec_block(gen: torch.Generator, cfg: ArchConfig) -> Params:
    p = init_enc_block(gen, cfg)
    p["cross_norm"] = cm.ln_init(cfg.d_model, cfg.torch_dtype, gen.device)
    p["cross"] = tf.init_attn(gen, cfg)
    return p


def init_encdec(gen: torch.Generator, cfg: ArchConfig, place=cm.as_made) -> Params:
    """``place``: as ``transformer.init_lm``'s, a part at a time."""
    dt, dev = cfg.torch_dtype, gen.device
    return {
        "embed": place(("embed",), cm.embed_init(gen, cfg.vocab, cfg.d_model, dt)),
        "pos_dec": place(("pos_dec",), cm.embed_init(gen, cfg.max_seq, cfg.d_model, dt)),
        "enc_blocks": [place(("enc_blocks", i), init_enc_block(gen, cfg))
                       for i in range(cfg.enc_layers)],
        "enc_norm": place(("enc_norm",), cm.ln_init(cfg.d_model, dt, dev)),
        "dec_blocks": [place(("dec_blocks", i), init_dec_block(gen, cfg))
                       for i in range(cfg.layers)],
        "final_norm": place(("final_norm",), cm.ln_init(cfg.d_model, dt, dev)),
    }


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None]
    ang = pos / torch.pow(torch.full((), 10000.0, device=device), dim / (d // 2))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _self_attn(p, x, cfg, causal, cache=None, aaq: AAQConfig = DISABLED):
    """Self-attention; with ``cache`` (this layer's ``LockstepRing``), one
    decode step over the ring."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = sh.split_heads(cm.dense(p["q"], x), hq)
    k = aaq.act(sh.split_heads(cm.dense(p["k"], x), hkv), "lm.kv_cache")
    v = aaq.act(sh.split_heads(cm.dense(p["v"], x), hkv), "lm.kv_cache")
    if cache is None:
        o = sh.local_attention(dispatch.attention, q, k, v, causal=causal)
    else:
        kd, vd, kvlen = cache.append(k, v)
        o = sh.local_attention(dispatch.attention, q, kd, vd, kv_valid_len=kvlen, causal=False)
    return cm.dense(p["o"], sh.merge_heads(o))


def _cross_attn(p, x, enc_out, cfg):
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = sh.split_heads(cm.dense(p["q"], x), hq)
    k = sh.split_heads(cm.dense(p["k"], enc_out), hkv)
    v = sh.split_heads(cm.dense(p["v"], enc_out), hkv)
    o = sh.local_attention(dispatch.attention, q, k, v, causal=False)
    return cm.dense(p["o"], sh.merge_heads(o))


def encode(params, frames, cfg: ArchConfig, aaq: AAQConfig = DISABLED):
    """frames (B, n_frames, d_model): the stubbed conv frontend's output."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)[None]
    for p in params["enc_blocks"]:
        x = x + _self_attn(p["attn"], cm.layernorm(p["attn_norm"], x), cfg, causal=False,
                           aaq=aaq)
        x = x + tf.mlp_apply(p["mlp"], cm.layernorm(p["mlp_norm"], x), cfg)
    return cm.layernorm(params["enc_norm"], x)


def _dec_block(p, x, enc_out, cfg, aaq, cache=None):
    x = x + _self_attn(p["attn"], cm.layernorm(p["attn_norm"], x), cfg, causal=True,
                       cache=cache, aaq=aaq)
    x = x + _cross_attn(p["cross"], cm.layernorm(p["cross_norm"], x), enc_out, cfg)
    return x + tf.mlp_apply(p["mlp"], cm.layernorm(p["mlp_norm"], x), cfg)


def _unembed(params, x):
    """Tied: logits against the token embedding, in float32."""
    return cm.matmul_f32(x, params["embed"]["e"].to(x.dtype).t())


def decode_full(params, tokens, enc_out, cfg: ArchConfig, aaq: AAQConfig = DISABLED,
                last_only=False, return_hidden=False):
    s = tokens.shape[1]
    x = sh.constrain(cm.embed(params["embed"], tokens), "residual")   # as lm_hidden pins it
    x = x + params["pos_dec"]["e"][:s][None].to(cfg.torch_dtype)
    for p in params["dec_blocks"]:
        x = sh.constrain(_dec_block(p, x, enc_out, cfg, aaq), "residual")
    x = cm.layernorm(params["final_norm"], x)
    if return_hidden:
        return x
    if last_only:
        x = x[:, -1:]
    return _unembed(params, x)


def encdec_loss(params, batch, cfg: ArchConfig, aaq: AAQConfig = DISABLED, remat=False):
    """Decoder cross-entropy against ``batch['labels']``; ``remat`` is
    accepted and ignored, as in the reference (its layers are not scanned)."""
    enc_out = encode(params, batch["audio_frames"], cfg, aaq)
    x = decode_full(params, batch["tokens"], enc_out, cfg, aaq, return_hidden=True)
    return tf.chunked_xent(params, x, batch["labels"], cfg)     # tied: _unembed's product


def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None):
    """The decoder's self-attention K/V ring per layer and the encoder
    output (zeros: the caller writes ``encode``'s result into it)."""
    dt = dtype or cfg.torch_dtype
    shape = (cfg.layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "enc_out": torch.zeros((batch, cfg.n_audio_frames, cfg.d_model), dtype=dt,
                                   device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def encdec_decode_step(params, batch, cache, cfg: ArchConfig, aaq: AAQConfig = DISABLED):
    """One decoder token against the self-KV ring and the cached encoder
    output; the cache is written in place.  Returns (logits (B, 1, V) f32,
    the cache with ``pos`` advanced)."""
    pos = cache["pos"]
    # a gather, not an index by a 0-d tensor (no host read of ``pos``)
    row = torch.clamp(pos, max=cfg.max_seq - 1).reshape(1).long()
    pos_emb = params["pos_dec"]["e"].index_select(0, row)[0]
    x = cm.embed(params["embed"], batch["tokens"]) + pos_emb[None, None].to(cfg.torch_dtype)
    enc_out = cache["enc_out"].to(x.dtype)
    for li, p in enumerate(params["dec_blocks"]):
        x = _dec_block(p, x, enc_out, cfg, aaq, cache=tf.LockstepRing(cache, li))
    x = cm.layernorm(params["final_norm"], x)
    cache["pos"] = pos + 1
    return _unembed(params, x), cache
