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
cumulative seat counts), the dispatch into the experts' seats and the
combine run on each rank's local tensors (``local_map``: DTensor's
``cumsum`` over a dim that two mesh dims shard is wrong in this PyTorch),
each rank's groups whole and its experts' (or d_model's) shard kept.
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
    """xe (E, C, d) through stacked expert weights (E, d, f)/(E, f, d).  On
    DTensors the products contract whole dims, as GSPMD partitions them:
    xe's d and the weights' FSDP shards of d are gathered, so the hidden
    keeps f sharded where the weights shard it (TP inside the experts)."""
    xe = sh.whole_dim(xe, -1)
    up = torch.bmm(xe, sh.whole_dim(p["up"]["w"], 1).to(xe.dtype))
    if "gate" in p:
        h = tf._act(cfg.act, torch.bmm(xe, sh.whole_dim(p["gate"]["w"], 1).to(xe.dtype))) * up
    else:
        h = tf._act(cfg.act, up)
    h = sh.constrain(h, "moe_hidden")
    return torch.bmm(h, sh.whole_dim(p["down"]["w"], 2).to(xe.dtype))


def _top_k(gates: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: ties go to the lower index (a
    stable descending sort; ``torch.topk`` promises no tie order)."""
    v, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _dispatch_tensors(gates, k: int, cap: int, experts: slice = slice(None)):
    """gates (..., G, E) -> (dispatch, combine) each (..., G, E, cap), float32,
    for the experts ``experts`` (all by default): every expert's seats are
    its own (the top-k reads every gate; the seat counts run per expert).

    GShard position-in-expert via cumulative sums, priority by choice rank:
    every token's first choice is seated before any second choice."""
    e = gates.shape[-1]
    topv, topi = _top_k(gates, k)                                    # (...,G,k)
    norm = topv[..., 0]
    for j in range(1, k):                       # the reference's sum, in order
        norm = norm + topv[..., j]
    topv = topv / torch.clamp_min(norm, 1e-9)[..., None]
    masks = F.one_hot(topi, e).float()[..., experts]                 # (...,G,k,E)
    e = masks.shape[-1]
    slots = torch.arange(cap, device=gates.device)
    expert_count = torch.zeros(gates.shape[:-2] + (e,), device=gates.device)
    dispatch_t = torch.zeros(masks.shape[:-2] + (e, cap), device=gates.device)
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
    # the groups are cut from each rank's own rows, whole sequences, the
    # rows sharded as the groups are (``moe_tokens``' first entry; all of
    # them on every rank where there are fewer groups than its ranks):
    # DTensor cannot fold a dim that two mesh dims shard into groups, nor
    # unfold it back, and the folds' gradients come back on their own
    # placements
    whole = False
    if sh.is_dtensor(x) and sh.rule_value("moe_tokens") is not None:
        rows = sh.rule_value("moe_tokens")[0]
        whole = ng % sh._axis_size(x.device_mesh, rows) != 0
        x = sh.pin(x, sh.P(None if whole else rows, None, None))
    xt = sh.constrain(sh.grad_on_placements(x.reshape(ng, grp, d)), "moe_tokens")
    gates = torch.softmax(cm.dense(p["router"], xt).float(), dim=-1)   # (ng,G,E)
    disp, combine = _routing(gates, k, cap)
    xe = sh.constrain(_dispatch(disp.to(x.dtype), xt), "moe_xe")      # (ng,E,C,d)
    ye = _expert_ffn(p["experts"], xe.transpose(0, 1).reshape(e, ng * cap, d), cfg)
    if whole:                   # (the hidden's rule shards its seats on the rows' ranks)
        ye = sh.whole_dim(ye, 1)
    # (the unfold's gradient made contiguous: DTensor views a local shard
    # for the fold back, which the transpose's gradient leaves strided)
    ye = sh.constrain(sh.grad_on_placements(ye.reshape(e, ng, cap, d)).transpose(0, 1),
                      "moe_xe")
    y = _combine(combine.to(x.dtype), ye)
    y = sh.grad_on_placements(y.reshape(b, s, d))
    if moe.n_shared:
        y = y + tf.mlp_apply(p["shared"], x, cfg)      # token-wise: on (B, S, D) as it is
    return y


def _routing(gates, k: int, cap: int):
    """``_dispatch_tensors`` of ``gates`` (ng, G, E).  On DTensors, on each
    rank's whole groups (DTensor's ``cumsum`` over a dim that two mesh dims
    shard is wrong), and, where the ``moe_xe`` rule puts the experts on
    mesh dims (EP), each rank's seats for its own experts only: the
    (ng, G, E, C) tensors made sharded on E, never whole."""
    if not sh.is_dtensor(gates):
        return _dispatch_tensors(gates, k, cap)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = gates.device_mesh
    ng, _, e = gates.shape
    rule = sh.rule_value("moe_xe")
    on = {}
    if rule is not None:
        to = sh.placements(sh.guarded(rule, (ng, e, cap, 1), mesh), mesh)
        on = {i: p.dim for i, p in enumerate(to) if isinstance(p, Shard)}
    rows = [i for i, t in on.items() if t == 0]
    experts = [i for i, t in on.items() if t == 1]
    g_to = [Shard(0) if i in rows else Replicate() for i in range(mesh.ndim)]
    out = [Shard(0) if i in rows else Shard(2) if i in experts else Replicate()
           for i in range(mesh.ndim)]
    g_grad = [Partial() if i in experts else p for i, p in enumerate(g_to)]
    n = e // math.prod(mesh.size(i) for i in experts)
    lo = sh._block_index(mesh, experts) * n
    if tuple(gates.placements) != tuple(g_to):
        sh._note("local:moe_dispatch")
    gates = sh.redistribute(gates, tuple(g_to))
    return local_map(sh._waited(lambda g: _dispatch_tensors(g, k, cap, slice(lo, lo + n))),
                     out_placements=(out, out), in_placements=(g_to,),
                     in_grad_placements=(g_grad,), device_mesh=mesh)(gates)


def _dispatch(disp, xt):
    """``einsum("ngec,ngd->necd", disp, xt)``: each group's tokens into its
    experts' seats.  On DTensors under the ``moe_xe`` rule, on each rank's
    local tensors, made on the rule's placements directly (the dispatch
    weights cut to the rank's experts, or the tokens' d_model kept sharded)
    rather than made whole and cut after."""
    rule = sh.rule_value("moe_xe")
    if not sh.is_dtensor(xt) or rule is None:
        return torch.einsum("ngec,ngd->necd", disp, xt)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xt.device_mesh
    ng, _, e, cap = disp.shape
    to = sh.placements(sh.guarded(rule, (ng, e, cap, xt.shape[-1]), mesh), mesh)
    on = {i: p.dim for i, p in enumerate(to) if isinstance(p, Shard)}
    d_to = [Shard({0: 0, 1: 2}[on[i]]) if on.get(i) in (0, 1) else Replicate()
            for i in range(mesh.ndim)]
    x_to = [Shard({0: 0, 3: 2}[on[i]]) if on.get(i) in (0, 3) else Replicate()
            for i in range(mesh.ndim)]
    # a rank's share of the contraction-free einsum: its experts' seats use
    # all its tokens (their gradient a partial sum), its d columns use all
    # the dispatch weights (theirs too)
    d_grad = [Partial() if on.get(i) == 3 else p for i, p in enumerate(d_to)]
    x_grad = [Partial() if on.get(i) == 1 else p for i, p in enumerate(x_to)]
    disp, xt = sh.redistribute(disp, tuple(d_to)), sh.redistribute(xt, tuple(x_to))
    return local_map(sh._waited(lambda c, v: torch.einsum("ngec,ngd->necd", c, v)),
                     out_placements=list(to), in_placements=(d_to, x_to),
                     in_grad_placements=(d_grad, x_grad), device_mesh=mesh)(disp, xt)


def _combine(c, ye):
    """``einsum("ngec,necd->ngd", c, ye)``: each group combines its own
    tokens.  On DTensors, on each rank's local tensors (DTensor in PyTorch
    2.11 cannot fold the einsum's sharded group dim) as GSPMD partitions
    it: the groups keep their rows' shards, and ``ye``'s experts (EP) or
    d_model (TP inside the experts) stay sharded where they are, the
    combine weights cut to the rank's experts and the sum over them a
    partial sum, so no rank gathers every expert's output."""
    if not sh.is_dtensor(ye):
        return torch.einsum("ngec,necd->ngd", c, ye)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ye.device_mesh
    dims = sh._dims_by_tensor_dim(ye)
    rows = [i for i in dims.get(0, []) if ye.shape[0] % mesh.size(i) == 0]
    experts, cols = dims.get(1, []), dims.get(3, [])
    y_to = [Shard(0) if i in rows else Shard(1) if i in experts else Shard(3) if i in cols
            else Replicate() for i in range(mesh.ndim)]
    c_to = [Shard(0) if i in rows else Shard(2) if i in experts else Replicate()
            for i in range(mesh.ndim)]
    out = [Shard(0) if i in rows else Partial() if i in experts else Shard(2) if i in cols
           else Replicate() for i in range(mesh.ndim)]
    c_grad = [Partial() if i in cols else p for i, p in enumerate(c_to)]
    c, ye = sh.redistribute(c, tuple(c_to)), sh.redistribute(ye, tuple(y_to))
    return local_map(sh._waited(lambda c, v: torch.einsum("ngec,necd->ngd", c, v)),
                     out_placements=out, in_placements=(c_to, y_to),
                     in_grad_placements=(c_grad, y_to), device_mesh=mesh)(c, ye)


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
    # a decode ring's latent is sharded on r, the contraction: made whole on
    # those mesh dims first, so that the column-parallel products keep
    # their heads sharded (as GSPMD gathers a contraction dim's shard)
    latent = sh.whole_dim(latent, -1)
    k_nope = cm.dense(p["k_up"], latent).reshape(b, skv, h, m.qk_nope_head_dim)
    v = cm.dense(p["v_up"], latent).reshape(b, skv, h, m.v_head_dim)
    k_rope_b = k_rope[:, :, None, :].expand(b, skv, h, m.qk_rope_head_dim)
    if sh.is_dtensor(k_nope):          # cut to k_nope's heads: no collective
        k_rope_b = sh.redistribute(k_rope_b, tuple(k_nope.placements))
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
