"""Unified architecture API (port of ``repro/models/lm.py``), dispatched on
``ArchConfig.kind`` (dense, vlm, moe, ssm, hybrid, encdec):

    init_params(gen, cfg)                      -> params
    prefill_fn(params, batch, cfg, aaq)        -> last-position logits
    make_cache(cfg, batch_size, max_len)       -> cache (on the card unless device="cpu")
    decode_fn(params, batch, cache, cfg, aaq)  -> (logits, cache')
    loss_fn(params, batch, cfg, aaq, remat)    -> scalar loss (training)

Caches are written in place (``decode_fn`` returns the same object with
``pos`` advanced).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import encdec as ed
from repro_torch.models import hybrid as hy
from repro_torch.models import moe as me
from repro_torch.models import ssm as sm
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding as sh


def _dense_first(cfg: ArchConfig) -> bool:
    return cfg.kind == "moe" and bool(cfg.moe.dense_first_layer_ff)


def init_params(gen: torch.Generator, cfg: ArchConfig, place=cm.as_made):
    """Random parameters from ``gen`` (made on ``gen.device``).
    ``place(path, part)`` takes each top-level part (the embedding, each
    block, ...) as it is made (``transformer.init_lm``)."""
    if cfg.kind in ("dense", "vlm"):
        return tf.init_lm(gen, cfg, place=place)
    if cfg.kind == "moe":
        scan_cfg = cfg.replace(layers=cfg.layers - 1) if _dense_first(cfg) else cfg
        p = tf.init_lm(gen, scan_cfg, init_block_fn=me.moe_block_init, place=place)
        if _dense_first(cfg):
            dev = gen.device
            p["first_block"] = place(("first_block",), {
                "attn_norm": tf._norm_init(cfg, dev),
                "attn": me.init_mla(gen, cfg) if cfg.mla else tf.init_attn(gen, cfg),
                "mlp_norm": tf._norm_init(cfg, dev),
                "mlp": tf.init_mlp(gen, cfg, d_ff=cfg.moe.dense_first_layer_ff),
            })
        return p
    if cfg.kind == "ssm":
        return tf.init_lm(gen, cfg, init_block_fn=sm.init_ssm_block, place=place)
    if cfg.kind == "hybrid":
        return hy.init_hybrid_lm(gen, cfg, place=place)
    if cfg.kind == "encdec":
        return ed.init_encdec(gen, cfg, place=place)
    raise ValueError(cfg.kind)


def _moe_first_block_fn(p, x, cfg, *, positions, cache=None, aaq=DISABLED):
    """DeepSeek layer 0: MLA attention + a *dense* FFN."""
    hn = tf.apply_norm(p["attn_norm"], aaq.act(x, "lm.pre_ln"), cfg)
    if cfg.mla:
        a = me.mla_apply(p["attn"], hn, cfg, positions=positions, cache=cache, aaq=aaq)
    else:
        a = tf.attn_apply(p["attn"], hn, cfg, positions=positions, cache=cache, aaq=aaq)
    x = x + a
    return x + tf.mlp_apply(p["mlp"], tf.apply_norm(p["mlp_norm"], aaq.act(x, "lm.pre_ln"),
                                                    cfg), cfg)


def _block_fn_for(cfg: ArchConfig):
    if cfg.kind == "moe":
        return me.moe_block_apply
    if cfg.kind == "ssm":
        return sm.ssm_block_apply
    return tf.block_apply


def loss_fn(params, batch, cfg: ArchConfig, aaq: AAQConfig = DISABLED, remat: bool = True):
    """Mean next-token cross-entropy of ``batch`` ('tokens', 'labels' (B, S),
    and the kind's 'image_embeds' or 'audio_frames'), differentiable in the
    parameters.  ``remat``: blocks recomputed in the backward, as the
    reference's ``jax.checkpoint`` (each scanned layer; a hybrid's periods;
    not the enc-dec).  Train with ``AAQConfig(ste=True)`` or ``DISABLED``."""
    if cfg.kind == "hybrid":
        return hy.hybrid_loss(params, batch, cfg, aaq=aaq, remat=remat)
    if cfg.kind == "encdec":
        return ed.encdec_loss(params, batch, cfg, aaq=aaq, remat=remat)
    if _dense_first(cfg):
        return _moe_loss_with_first(params, batch, cfg, aaq, remat)
    return tf.lm_loss(params, batch, cfg, aaq=aaq, block_fn=_block_fn_for(cfg), remat=remat)


def _moe_loss_with_first(params, batch, cfg, aaq, remat):
    """DeepSeek: the dense first block as it is, the MoE blocks rematted.
    The embedding's output is pinned to the residual's layout, as
    ``lm_hidden`` pins it (a sharded step's lookup is a partial sum over
    the vocabulary's shards, which every later product would carry)."""
    x = sh.constrain(tf._embed_inputs(params, batch, cfg), "residual")
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = _moe_first_block_fn(params["first_block"], x, cfg, positions=positions, aaq=aaq)
    for p in params["blocks"]:
        x = tf.rematted(lambda y, p=p: sh.constrain(
            me.moe_block_apply(p, y, cfg, positions=positions, aaq=aaq), "residual"), remat)(x)
    x = tf.apply_norm(params["final_norm"], x, cfg)
    return tf.chunked_xent(params, x, batch["labels"], cfg)


def prefill_fn(params, batch, cfg: ArchConfig, aaq: AAQConfig = DISABLED):
    """Full-sequence forward -> logits of the last position (B, 1, V) f32.
    ``batch``: 'tokens' (B, S); the VLM's 'image_embeds' (B, n_image, D)
    and the enc-dec's 'audio_frames' (B, n_frames, D) where the kind has them."""
    if cfg.kind == "hybrid":
        return hy.hybrid_forward(params, batch, cfg, aaq=aaq, last_only=True)
    if cfg.kind == "encdec":
        enc = ed.encode(params, batch["audio_frames"], cfg, aaq)
        return ed.decode_full(params, batch["tokens"], enc, cfg, aaq, last_only=True)
    if _dense_first(cfg):
        x = sh.constrain(tf._embed_inputs(params, batch, cfg), "residual")
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x = _moe_first_block_fn(params["first_block"], x, cfg, positions=positions, aaq=aaq)
        for p in params["blocks"]:
            x = sh.constrain(me.moe_block_apply(p, x, cfg, positions=positions, aaq=aaq),
                             "residual")
        x = tf.apply_norm(params["final_norm"], x, cfg)
        return sh.constrain(tf.unembed(params, x[:, -1:], cfg), "logits")
    return tf.lm_forward(params, batch, cfg, aaq=aaq, block_fn=_block_fn_for(cfg),
                         last_only=True)


def make_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               quantized: bool = False, device=None):
    """The decode cache of ``cfg``'s kind, the reference's shapes, on
    ``device`` (default CUDA); ``quantized`` (INT8 K/V rows) applies to the
    dense and VLM kinds."""
    device = resolve_device(device)
    if cfg.kind in ("dense", "vlm"):
        return tf.init_cache(cfg, batch, max_len, dtype, quantized=quantized, device=device)
    if cfg.kind == "moe":
        if cfg.mla:
            return me.init_mla_cache(cfg, batch, max_len, dtype, device=device)
        return tf.init_cache(cfg, batch, min(max_len, cfg.window or max_len), dtype,
                             device=device)
    if cfg.kind == "ssm":
        return sm.init_ssm_cache(cfg, batch, max_len, dtype, device=device)
    if cfg.kind == "hybrid":
        return hy.init_hybrid_cache(cfg, batch, max_len, dtype, device=device)
    if cfg.kind == "encdec":
        return ed.init_encdec_cache(cfg, batch, max_len, dtype, device=device)
    raise ValueError(cfg.kind)


def decode_fn(params, batch, cache, cfg: ArchConfig, aaq: AAQConfig = DISABLED):
    """One token a row: ``batch['tokens']`` (B, 1) -> (logits (B, 1, V) f32,
    the cache, written in place, ``pos`` advanced)."""
    if cfg.kind == "hybrid":
        return hy.hybrid_decode_step(params, batch, cache, cfg, aaq=aaq)
    if cfg.kind == "encdec":
        return ed.encdec_decode_step(params, batch, cache, cfg, aaq=aaq)
    if _dense_first(cfg):
        # the cache's layer 0 is the dense first block's, 1.. the MoE blocks'
        x = cm.embed(params["embed"], batch["tokens"])
        positions = cache["pos"].reshape(1, 1).expand(x.shape[0], 1)
        x = _moe_first_block_fn(params["first_block"], x, cfg, positions=positions,
                                cache=tf.LockstepRing(cache, 0), aaq=aaq)
        for li, p in enumerate(params["blocks"]):
            x = me.moe_block_apply(p, x, cfg, positions=positions,
                                   cache=tf.LockstepRing(cache, li + 1), aaq=aaq)
        x = tf.apply_norm(params["final_norm"], x, cfg)
        cache["pos"] = cache["pos"] + 1
        return tf.unembed(params, x, cfg), cache
    return tf.decode_step(params, batch, cache, cfg, aaq=aaq, block_fn=_block_fn_for(cfg))


# --------------------------------------------------------------------------
# dry-run specs (shapes and dtypes, nothing allocated)
# --------------------------------------------------------------------------
def _meta(tree):
    """Each tensor of ``tree`` as a ``meta`` tensor of its shape and dtype."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def param_specs(cfg: ArchConfig):
    """The parameters' shapes and dtypes as ``meta`` tensors, without
    allocating (``init_params`` traced on fake tensors): the reference's
    ``eval_shape`` over its init, with the port's per-layer lists."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return _meta(init_params(torch.Generator().manual_seed(0), cfg))


def input_specs(cfg: ArchConfig, shape, quantized_kv: bool = False) -> dict:
    """``meta`` stand-ins for every input of this cell's step
    (``configs.ShapeSpec``): the batch, and a decode step's cache."""
    b, s = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, cfg.torch_dtype
    spec = lambda *shp, dtype=i32: torch.empty(shp, dtype=dtype, device="meta")  # noqa: E731
    if shape.step in ("train", "prefill"):
        n_tok = s - cfg.n_image_tokens if cfg.kind == "vlm" else s
        batch = {"tokens": spec(b, n_tok)}
        if shape.step == "train":
            batch["labels"] = spec(b, n_tok)
        if cfg.kind == "vlm":
            batch["image_embeds"] = spec(b, cfg.n_image_tokens, cfg.d_model, dtype=dt)
        if cfg.kind == "encdec":
            batch["audio_frames"] = spec(b, cfg.n_audio_frames, cfg.d_model, dtype=dt)
        return {"batch": batch}
    if shape.step == "decode":
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            cache = _meta(make_cache(cfg, b, s, quantized=quantized_kv, device="cpu"))
        return {"batch": {"tokens": spec(b, 1)}, "cache": cache}
    raise ValueError(shape.step)
