"""Mixture-of-Experts layers (Mixtral top-2, DeepSeek shared+routed top-6)
and DeepSeek-V2 Multi-head Latent Attention (MLA) (port of
``repro/models/moe.py``).

Dispatch is the GShard dense-einsum formulation: one-hot dispatch/combine
tensors with static per-expert capacity, enforced per routing group of
``MOE_GROUP`` tokens.  The experts of a block are stacked on a leading
axis (``experts.up.w`` is (E, d, f)) and run as batched products.  The
group size comes from the active mesh rules (``moe_group``, else
``MOE_GROUP``), and the reference's constraints sit where its do
(``moe_tokens``, ``moe_xe``, ``moe_hidden``): a sharded train step
redistributes its DTensors there.  The routing itself (top-k, the
cumulative seat counts) runs on each rank's whole groups
(``sharding.on_local``): DTensor's ``cumsum`` over a dim that two mesh
dims shard is wrong in this PyTorch.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding as sh

Params = dict[str, Any]
MOE_GROUP = 512   # tokens per routing group (capacity enforced per group)


# --------------------------------------------------------------------------
# MoE FFN
# --------------------------------------------------------------------------
def _stacked_dense(gen: torch.Generator, n: int, d_in: int, d_out: int, dtype) -> Params:
    """``n`` dense layers of ``cm.dense_init``'s law, stacked: {'w': (n, in, out)}."""
    w = torch.randn((n, d_in, d_out), generator=gen, device=gen.device) / math.sqrt(d_in)
    return {"w": w.to(dtype)}


def init_moe_mlp(gen: torch.Generator, cfg: ArchConfig) -> Params:
    moe, d, dt = cfg.moe, cfg.d_model, cfg.torch_dtype
    experts = {"up": _stacked_dense(gen, moe.n_experts, d, moe.expert_ff, dt),
               "down": _stacked_dense(gen, moe.n_experts, moe.expert_ff, d, dt)}
    if cfg.act.endswith("_glu"):
        experts["gate"] = _stacked_dense(gen, moe.n_experts, d, moe.expert_ff, dt)
    p = {"router": cm.dense_init(gen, d, moe.n_experts, dtype=dt), "experts": experts}
    if moe.n_shared:
        p["shared"] = tf.init_mlp(gen, cfg, d_ff=moe.expert_ff * moe.n_shared)
    return p


def _expert_ffn(p, xe, cfg: ArchConfig):
    """xe (E, C, d) through stacked expert weights (E, d, f)/(E, f, d)."""
    up = torch.bmm(xe, p["up"]["w"].to(xe.dtype))
    if "gate" in p:
        h = tf._act(cfg.act, torch.bmm(xe, p["gate"]["w"].to(xe.dtype))) * up
    else:
        h = tf._act(cfg.act, up)
    h = sh.constrain(h, "moe_hidden")
    return torch.bmm(h, p["down"]["w"].to(xe.dtype))


def _top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: ties go to the lower index (a
    stable descending sort; ``torch.topk`` promises no tie order)."""
    v, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _dispatch_tensors(gates, k: int, cap: int):
    """gates (..., G, E) -> (dispatch, combine) each (..., G, E, cap), float32.

    GShard position-in-expert via cumulative sums, priority by choice rank:
    every token's first choice is seated before any second choice."""
    e = gates.shape[-1]
    topv, topi = _top_k(gates, k)                                    # (...,G,k)
    norm = topv[..., 0]
    for j in range(1, k):                       # the reference's sum, in order
        norm = norm + topv[..., j]
    topv = topv / torch.clamp_min(norm, 1e-9)[..., None]
    masks = F.one_hot(topi, e).float()                               # (...,G,k,E)
    slots = torch.arange(cap, device=gates.device)
    expert_count = torch.zeros(gates.shape[:-2] + (e,), device=gates.device)
    dispatch_t = torch.zeros(gates.shape + (cap,), device=gates.device)
    combine = torch.zeros_like(dispatch_t)
    for j in range(k):
        m = masks[..., j, :]                                         # (...,G,E)
        prio = torch.cumsum(m, dim=-2) - m + expert_count[..., None, :]
        expert_count = expert_count + m.sum(dim=-2)
        slot = (prio * m).sum(dim=-1).to(torch.int32)                # (...,G)
        # one_hot(slot, cap) is all zeros past the capacity: the token drops
        oh_slot = (slot[..., None] == slots).float()                 # (...,G,C)
        dj = m[..., :, None] * oh_slot[..., None, :]
        dispatch_t = dispatch_t + dj
        combine = combine + dj * topv[..., j][..., None, None]
    return dispatch_t, combine


def moe_apply(p, x, cfg: ArchConfig):
    """Top-k token-choice routing, static capacity enforced per group of
    ``MOE_GROUP`` tokens (fewer when the tokens do not fill one), capacity
    ``max(4, ceil(G k / E * capacity_factor))``; a token past it in an
    expert drops that expert's share."""
    moe = cfg.moe
    b, s, d = x.shape
    t, e, k = b * s, moe.n_experts, moe.top_k
    grp = min(int(sh.rule_value("moe_group", MOE_GROUP)), t)
    while t % grp:
        grp //= 2
    ng = t // grp
    cap = max(4, int(math.ceil(grp * k / e * moe.capacity_factor)))
    xt = sh.constrain(x.reshape(ng, grp, d), "moe_tokens")
    gates = torch.softmax(cm.dense(p["router"], xt).float(), dim=-1)   # (ng,G,E)
    disp, combine = sh.on_local("moe_dispatch", lambda g: _dispatch_tensors(g, k, cap),
                                gates, keep=(0,), n_out=2)
    xe = torch.einsum("ngec,ngd->necd", disp.to(x.dtype), xt)          # (ng,E,C,d)
    xe = sh.constrain(xe, "moe_xe")
    ye = _expert_ffn(p["experts"], xe.transpose(0, 1).reshape(e, ng * cap, d), cfg)
    ye = sh.constrain(ye.reshape(e, ng, cap, d).transpose(0, 1), "moe_xe")
    # each group combines its own tokens: on each rank's groups (DTensor in
    # PyTorch 2.11 cannot fold the einsum's sharded group dim)
    y = sh.on_local("moe_combine", lambda c, v: torch.einsum("ngec,necd->ngd", c, v),
                    combine.to(x.dtype), ye, keep=(0,)).reshape(t, d)
    if moe.n_shared:
        y = y + tf.mlp_apply(p["shared"], x.reshape(t, d), cfg)
    return y.reshape(b, s, d)


def moe_block_init(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dev = gen.device
    return {"attn_norm": tf._norm_init(cfg, dev),
            "attn": init_mla(gen, cfg) if cfg.mla else tf.init_attn(gen, cfg),
            "mlp_norm": tf._norm_init(cfg, dev),
            "mlp": init_moe_mlp(gen, cfg)}


def moe_block_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
                    aaq: AAQConfig = DISABLED):
    h = aaq.act(x, "lm.pre_ln")
    hn = tf.apply_norm(p["attn_norm"], h, cfg)
    if cfg.mla:
        a = mla_apply(p["attn"], hn, cfg, positions=positions, cache=cache, aaq=aaq)
    else:
        a = tf.attn_apply(p["attn"], hn, cfg, positions=positions, cache=cache, aaq=aaq)
    x = x + a
    mlp_in = tf.apply_norm(p["mlp_norm"], aaq.act(x, "lm.pre_ln"), cfg)
    return x + moe_apply(p["mlp"], mlp_in, cfg)


# --------------------------------------------------------------------------
# DeepSeek-V2 Multi-head Latent Attention
# --------------------------------------------------------------------------
def init_mla(gen: torch.Generator, cfg: ArchConfig) -> Params:
    m, d, h, dt = cfg.mla, cfg.d_model, cfg.n_heads, cfg.torch_dtype
    return {
        "kv_down": cm.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype=dt),
        "latent_norm": cm.rms_init(m.kv_lora_rank, dt, gen.device),
        "k_up": cm.dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim, dtype=dt),
        "v_up": cm.dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dtype=dt),
        "q": cm.dense_init(gen, d, h * (m.qk_nope_head_dim + m.qk_rope_head_dim), dtype=dt),
        "o": cm.dense_init(gen, h * m.v_head_dim, d, dtype=dt),
    }


def _mla_qkv_from_latent(p, latent, k_rope, cfg: ArchConfig):
    """Expand the compressed KV latent (B, Skv, r) and the shared rope key
    (B, Skv, dr) into per-head K (B, Skv, H, dn + dr) and V (B, Skv, H, dv)."""
    m, h = cfg.mla, cfg.n_heads
    b, skv, _ = latent.shape
    k_nope = cm.dense(p["k_up"], latent).reshape(b, skv, h, m.qk_nope_head_dim)
    v = cm.dense(p["v_up"], latent).reshape(b, skv, h, m.v_head_dim)
    k_rope_b = k_rope[:, :, None, :].expand(b, skv, h, m.qk_rope_head_dim)
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def mla_apply(p, x, cfg: ArchConfig, *, positions, cache=None, aaq: AAQConfig = DISABLED):
    """MLA attention.  The decode cache is the compressed latent and the
    rope key ({'latent': (B, W, r), 'k_rope': (B, W, dr)}, a
    ``LockstepRing``): AAQ quantizes *the latent*, the token here being the
    512-dim latent vector.  q/k have head dim dn + dr, v has dv: the kernel
    route pads v (``dispatch.attention``); the softmax scale is
    1/sqrt(dn + dr), passed explicitly."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    down = cm.dense(p["kv_down"], x)
    latent, k_rope = down[..., :m.kv_lora_rank], down[..., m.kv_lora_rank:]
    latent = cm.rmsnorm(p["latent_norm"], latent)
    q = cm.dense(p["q"], x).reshape(b, s, h, dn + dr)
    q_rope = cm.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    k_rope = cm.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    q = torch.cat([q[..., :dn], q_rope], dim=-1)
    latent = aaq.act(latent, "lm.mla_latent")          # AAQ on the latent
    k_rope = aaq.act(k_rope, "lm.mla_latent")
    scale = 1.0 / math.sqrt(dn + dr)
    if cache is None:
        k, v = _mla_qkv_from_latent(p, latent, k_rope, cfg)
        o = sh.local_attention(dispatch.attention, q, k, v, causal=True,
                               softmax_scale=scale)
    else:
        cl = cache.write("latent", latent)
        cr = cache.write("k_rope", k_rope)
        k, v = _mla_qkv_from_latent(p, cl.to(x.dtype), cr.to(x.dtype), cfg)
        o = sh.local_attention(dispatch.attention, q, k, v,
                               kv_valid_len=cache.kv_valid_len(b, cl.shape[1]),
                               causal=False, softmax_scale=scale)
    return cm.dense(p["o"], sh.merge_heads(o))


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None):
    m, dt = cfg.mla, dtype or cfg.torch_dtype
    return {
        "latent": torch.zeros((cfg.layers, batch, max_len, m.kv_lora_rank), dtype=dt,
                              device=device),
        "k_rope": torch.zeros((cfg.layers, batch, max_len, m.qk_rope_head_dim), dtype=dt,
                              device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
