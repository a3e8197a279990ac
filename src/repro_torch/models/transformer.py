"""Generic decoder-only transformer (port of ``repro/models/transformer.py``):
the dense and VLM members of the zoo, and the attention blocks and the
forward/decode drivers that the MoE, SSM, hybrid and enc-dec models reuse
(``block_fn``).

GQA with decoupled head_dim, optional QKV bias, RoPE (partial rotary for
ChatGLM's 2D scheme), RMS/LayerNorm, (Si/Ge)GLU MLPs, sliding window, and a
ring-buffer KV cache for decode with the AAQ hooks of the reference: the
KV cache and the residual stream can be routed through token-wise
quantization.  Prefill, the lockstep ``decode_step`` and the served decode
step (``serving.lm``) run the one ``block_apply``; decode hands
``attn_apply`` a ring that it writes in place.  Attention goes through ``dispatch.attention`` (the CUDA
flash kernel on the card).

Parameters are the reference's pytree with one change: ``blocks`` is a list
of per-layer dicts (the reference stacks them on a leading axis for
``scan``; ``bridge.lm_params_from_numpy`` unstacks).  A ``block_fn`` takes
``(p, x, cfg, *, positions, cache=None, aaq)`` and returns the new ``x``;
in decode it writes its layer of the cache in place.  The reference's
sharding constraints sit where its do (``residual`` at every layer
boundary, ``logits``, ``kv_cache``): ``parallel.sharding.constrain``
redistributes a DTensor to the active rule (a sharded train step) and
passes anything else through.
Training: ``lm_hidden(remat=True)`` checkpoints each block
(``torch.utils.checkpoint``, non-reentrant: ``jax.checkpoint`` of the
scanned body), ``chunked_xent`` is the loss without the full (B, S, V)
logits, ``lm_loss`` the two together.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import constrain as _constrain

Params = dict[str, Any]


# --------------------------------------------------------------------------
# init (random, from a torch.Generator: not jax.random's numbers)
# --------------------------------------------------------------------------
def init_attn(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, hd, dt = cfg.d_model, cfg.hd, cfg.torch_dtype
    return {
        "q": cm.dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias, dtype=dt),
        "k": cm.dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dt),
        "v": cm.dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dt),
        "o": cm.dense_init(gen, cfg.n_heads * hd, d, dtype=dt),
    }


def init_mlp(gen: torch.Generator, cfg: ArchConfig, d_ff: int | None = None) -> Params:
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.torch_dtype
    p = {"up": cm.dense_init(gen, d, f, dtype=dt),
         "down": cm.dense_init(gen, f, d, dtype=dt)}
    if cfg.act.endswith("_glu"):
        p["gate"] = cm.dense_init(gen, d, f, dtype=dt)
    return p


def _norm_init(cfg: ArchConfig, device) -> Params:
    init = cm.rms_init if cfg.norm == "rms" else cm.ln_init
    return init(cfg.d_model, cfg.torch_dtype, device)


def init_block(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"attn_norm": _norm_init(cfg, gen.device), "attn": init_attn(gen, cfg),
            "mlp_norm": _norm_init(cfg, gen.device), "mlp": init_mlp(gen, cfg)}


def init_lm(gen: torch.Generator, cfg: ArchConfig, init_block_fn=None,
            place=cm.as_made) -> Params:
    """``place(path, part)`` takes each top-level part (the embedding, each
    block, ...) as it is made: a sharded run distributes it there, so no
    device holds the whole model at once."""
    init_block_fn = init_block_fn or init_block
    p: Params = {"embed": place(("embed",), cm.embed_init(gen, cfg.vocab, cfg.d_model,
                                                           cfg.torch_dtype)),
                 "final_norm": place(("final_norm",), _norm_init(cfg, gen.device)),
                 "blocks": [place(("blocks", i), init_block_fn(gen, cfg))
                            for i in range(cfg.layers)]}
    if not cfg.tie_embeddings:
        p["lm_head"] = place(("lm_head",), cm.dense_init(gen, cfg.d_model, cfg.vocab,
                                                          dtype=cfg.torch_dtype))
    return p


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------
def apply_norm(p, x, cfg: ArchConfig):
    return (cm.rmsnorm if cfg.norm == "rms" else cm.layernorm)(p, x)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name.startswith("silu"):
        return F.silu(x)
    if name.startswith("gelu"):
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    return F.relu(x)


def mlp_apply(p, x, cfg: ArchConfig):
    if cfg.act.endswith("_glu"):
        h = _act(cfg.act, cm.dense(p["gate"], x)) * cm.dense(p["up"], x)
    else:
        h = _act(cfg.act, cm.dense(p["up"], x))
    return cm.dense(p["down"], h)


def qkv(p, x, cfg: ArchConfig, positions):
    """q (B,S,Hq,hd), k and v (B,S,Hkv,hd), rotary applied."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = sh.split_heads(cm.dense(p["q"], x), hq)
    k = sh.split_heads(cm.dense(p["k"], x), hkv)
    v = sh.split_heads(cm.dense(p["v"], x), hkv)
    if cfg.rotary_frac > 0:
        q = cm.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_frac)
        k = cm.apply_rope(k, positions, cfg.rope_theta, cfg.rotary_frac)
    return q, k, v


def attn_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
               aaq: AAQConfig = DISABLED, causal=True, window=None, bias=None):
    """Self-attention of ``x`` (B, S, D).  Without a cache, over ``x``
    itself (causal, windowed where ``cfg.window``).  With one, decode: the
    cache takes the new K/V rows (``cache.append(k, v)`` -> the ring K/V
    (B, W, Hkv, hd) in ``k``'s dtype and ``kv_valid_len`` (B,)) and q
    attends over the ring.  ``LockstepRing`` is ``decode_step``'s cache,
    ``serving.lm``'s per-slot ring the served one; both write in place."""
    q, k, v = qkv(p, x, cfg, positions)
    k = aaq.act(k, "lm.kv_cache")
    v = aaq.act(v, "lm.kv_cache")
    if cache is None:
        window = window if window is not None else cfg.window
        o = sh.local_attention(dispatch.attention, q, k, v, bias=bias, causal=causal,
                               window=window)
    else:
        kd, vd, kvlen = cache.append(k, v)
        o = sh.local_attention(dispatch.attention, q, kd, vd, kv_valid_len=kvlen, causal=False)
    o = sh.merge_heads(o)
    return cm.dense(p["o"], o)


class LockstepRing:
    """Layer ``li`` of a decode cache (every entry but ``pos`` with a leading
    layer axis; ``li=None``: ``cache`` holds one layer's entries and
    ``pos``), for a lockstep batch: every row at position ``cache['pos']``.
    ``ring[name]`` is the layer's entry (a view: writes reach the cache);
    ``write`` puts s new rows (B, s, ...) at the ring position in place and
    returns the ring; ``append`` does so for K and V (raw, or INT8 rows and
    f32 scales through ``_quant_kv_row``) and returns them dequantized with
    ``kv_valid_len``."""

    def __init__(self, cache: Params, li: int | None = None):
        self.cache, self.li = cache, li

    def __getitem__(self, name: str) -> torch.Tensor:
        a = self.cache[name]
        return a if self.li is None else a[self.li]

    def kv_valid_len(self, b: int, w: int) -> torch.Tensor:
        return torch.clamp(self.cache["pos"] + 1, max=w).to(torch.int32).expand(b)

    def write(self, name: str, x: torch.Tensor) -> torch.Tensor:
        ring = self[name]
        x = _constrain(x, "kv_cache")
        s, w = x.shape[1], ring.shape[1]
        # dynamic_update_slice clamps the start so that the s rows fit
        start = torch.clamp(self.cache["pos"] % w, max=w - s)
        rows = start + torch.arange(s, device=x.device)
        if sh.is_dtensor(ring) and not sh.unsharded_dim(ring, 1):
            return sh.write_positions(ring, rows, x)
        if sh.is_dtensor(ring):
            # DTensor has no rule for index_copy_ in every PyTorch (2.11):
            # each rank writes its shard of the rows into its shard of the
            # ring, whose positions are all its own
            x = sh.redistribute(x.to(ring.dtype), tuple(ring.placements))
            ring.to_local().index_copy_(1, sh.to_local(rows), x.to_local())
            return ring
        ring.index_copy_(1, rows, x.to(ring.dtype))
        return ring

    def append(self, k, v):
        out = []
        for name, x in (("k", k), ("v", v)):
            if f"{name}_scale" in self.cache:
                xq, xs = _quant_kv_row(x)
                scale = self.write(f"{name}_scale", xs)
                out.append(self.write(name, xq).to(x.dtype) * scale.to(x.dtype))
            else:
                out.append(self.write(name, x).to(x.dtype))
        return out[0], out[1], self.kv_valid_len(k.shape[0], out[0].shape[1])


def _quant_kv_row(x: torch.Tensor):
    """Token-wise symmetric INT8 over the head dim: (B,S,H,hd) ->
    (int8 values, f32 scales (B,S,H,1)).  The division is by a tensor, an
    IEEE quotient as in the reference (see ``quantize.scale_for``)."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(m / torch.full((), 127.0, device=x.device), 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def block_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
                aaq: AAQConfig = DISABLED):
    h = aaq.act(x, "lm.pre_ln")           # residual stream (Group A analogue)
    x = x + attn_apply(p["attn"], apply_norm(p["attn_norm"], h, cfg), cfg,
                       positions=positions, cache=cache, aaq=aaq)
    mlp_in = apply_norm(p["mlp_norm"], aaq.act(x, "lm.pre_ln"), cfg)
    return x + mlp_apply(p["mlp"], mlp_in, cfg)


# --------------------------------------------------------------------------
# full model: forward / prefill / decode
# --------------------------------------------------------------------------
def unembed(params, x, cfg: ArchConfig):
    """Logits in float32, every product accumulated in float32 (a bf16
    ``x @ E.T`` would round the logits and flip greedy argmax)."""
    if cfg.tie_embeddings:
        return cm.matmul_f32(x, params["embed"]["e"].to(x.dtype).t())
    return cm.matmul_f32(x, params["lm_head"]["w"].to(x.dtype))


def _embed_inputs(params, batch, cfg: ArchConfig):
    """Token embedding; the VLM stub prepends precomputed patch embeddings."""
    x = cm.embed(params["embed"], batch["tokens"])
    if cfg.n_image_tokens and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    return x


def rematted(fn, remat: bool):
    """``fn`` (tensors -> tensor), recomputed in the backward instead of
    keeping its activations when ``remat`` (``jax.checkpoint``): the
    non-reentrant ``torch.utils.checkpoint``, which lets gradients reach
    the parameters ``fn`` closes over."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def lm_hidden(params, batch, cfg: ArchConfig, *, aaq: AAQConfig = DISABLED,
              block_fn=None, remat=False):
    """Full-sequence forward of ``batch['tokens']`` (B, S) (after
    ``batch['image_embeds']`` where the VLM has them) -> final hidden
    states (B, S, D).  ``remat``: each block recomputed in the backward,
    where the config scans its layers (the reference remats the scan body)."""
    block_fn = block_fn or block_apply
    x = _constrain(_embed_inputs(params, batch, cfg), "residual")
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for p in params["blocks"]:
        step = rematted(lambda y, p=p: _constrain(
            block_fn(p, y, cfg, positions=positions, aaq=aaq), "residual"),
            remat and cfg.scan_layers)
        x = step(x)
    return apply_norm(params["final_norm"], x, cfg)


def lm_forward(params, batch, cfg: ArchConfig, *, aaq: AAQConfig = DISABLED,
               block_fn=None, last_only=False):
    """Full-sequence forward -> logits (B, S, V) f32, or the last position
    only (the serving-prefill case)."""
    x = lm_hidden(params, batch, cfg, aaq=aaq, block_fn=block_fn)
    if last_only:
        x = x[:, -1:]
    return _constrain(unembed(params, x, cfg), "logits")


def chunked_xent(params, x, labels, cfg: ArchConfig, chunk: int = 1024):
    """Mean next-token cross-entropy of hidden states ``x`` (B, S, D)
    against ``labels`` (B, S) (positions with a label < 0 masked out),
    without the full (B, S, V) logits: the unembedding and the float32
    log-softmax run per sequence chunk under a checkpoint, so at most
    (B, chunk, V) logits are live and the backward recomputes each chunk.
    A sequence that ``chunk`` does not divide is one chunk.  Where a mesh
    dim of more than one rank splits the vocabulary (``sharding.
    vocab_split``: a sharded step), each chunk's loss is vocabulary-parallel
    (``sharding.vocab_parallel_xent``): no rank makes the whole logits."""
    s = x.shape[1]
    if s % chunk:
        chunk = s
    x = sh.foldable(x)            # a sharded sequence gathered before it is sliced
    w, vdim = ((params["embed"]["e"], 0) if cfg.tie_embeddings
               else (params["lm_head"]["w"], 1))

    split = sh.vocab_split(w, vdim)
    if split is not None:
        def one(xx, ll):
            return sh.vocab_parallel_xent(xx, w, ll, vdim, split)
    else:
        def one(xx, ll):
            logp = torch.log_softmax(_constrain(unembed(params, xx, cfg), "logits"), dim=-1)
            mask = (ll >= 0).float()
            nll = -torch.gather(logp, -1, ll.clamp_min(0).long()[..., None])[..., 0]
            return torch.stack([torch.sum(nll * mask), torch.sum(mask)])

    sums = [checkpoint(one, x[:, i:i + chunk], labels[:, i:i + chunk], use_reentrant=False)
            for i in range(0, s, chunk)]
    total = sums[0]
    for t in sums[1:]:
        total = total + t
    return total[0] / torch.clamp_min(total[1], 1.0)


def lm_loss(params, batch, cfg: ArchConfig, *, aaq: AAQConfig = DISABLED,
            block_fn=None, remat=True):
    """Mean cross-entropy of a decoder-only forward; the VLM's image
    positions carry no label and are dropped."""
    x = lm_hidden(params, batch, cfg, aaq=aaq, block_fn=block_fn, remat=remat)
    if cfg.n_image_tokens and "image_embeds" in batch:
        x = x[:, cfg.n_image_tokens:]                         # text positions
    return chunked_xent(params, x, batch["labels"], cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               quantized: bool = False, device=None) -> Params:
    """Ring-buffer KV cache; SWA archs allocate only ``window`` rows.
    ``quantized=True``: INT8 rows + per-token f32 scales."""
    w = min(max_len, cfg.window) if cfg.window else max_len
    dt = dtype or cfg.torch_dtype
    shape = (cfg.layers, batch, w, cfg.n_kv_heads, cfg.hd)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    if quantized:
        sshape = (cfg.layers, batch, w, cfg.n_kv_heads, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "pos": pos}
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device), "pos": pos}


def decode_step(params, batch, cache, cfg: ArchConfig, *,
                aaq: AAQConfig = DISABLED, block_fn=None):
    """One-token decode of a lockstep batch: ``batch['tokens']`` (B, 1), cache from
    ``init_cache`` (every row at position ``cache['pos']``), written in place.
    Structure-agnostic: every cache entry but ``pos`` has a leading layer
    axis, and ``block_fn`` gets its layer as a ``LockstepRing`` (the dense
    {'k','v'} cache, MLA's {'latent','k_rope'}, the SSM's {'state','conv'}).
    Returns (logits (B, 1, V) f32, the cache with ``pos`` advanced)."""
    block_fn = block_fn or block_apply
    x = cm.embed(params["embed"], batch["tokens"])            # (B,1,D)
    positions = cache["pos"].reshape(1, 1).expand(x.shape[0], 1)
    for li, p in enumerate(params["blocks"]):
        x = block_fn(p, x, cfg, positions=positions, cache=LockstepRing(cache, li), aaq=aaq)
    x = apply_norm(params["final_norm"], x, cfg)
    cache["pos"] = cache["pos"] + 1
    return unembed(params, x, cfg), cache
