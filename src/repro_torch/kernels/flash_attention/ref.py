"""Plain PyTorch reference for token-wise MHA (port of
``repro/kernels/flash_attention/ref.py``).  This is what the ``ref``
backend runs; the kernel's own plain version, which follows the kernel on
fully masked rows, is ``flash_attention.flash_mha_plain``."""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _block_broadcast_bias(bias: torch.Tensor, b: int) -> torch.Tensor:
    """(Bb, ...) bias -> (b, ...): entry t covers rows [t*rep, (t+1)*rep).

    Block (not modulo-tile) semantics: matches the kernel's ``b // (B/Bb)``
    bias row and triangular attention's protein-major row flattening."""
    rep = b // bias.shape[0]
    if rep <= 1:
        return bias
    return bias[:, None].expand(bias.shape[0], rep, *bias.shape[1:]).reshape(
        b, *bias.shape[1:])


def _scale(d: int, softmax_scale):
    return softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)


def _scores(q, kx, bias, b, scale, qpos, kpos, causal, window, kv_valid_len):
    """Masked f32 logits (B, Hq, Sq, Skv) exactly as the reference builds them."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) * scale
    if bias is not None:
        s = s + _block_broadcast_bias(bias, b).float()
    ok = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    # torch.full fills on the device: no host copy, so a CUDA graph can
    # capture the plain version too
    s = torch.where(ok[None, None], s, torch.full((), NEG, device=q.device))
    if kv_valid_len is not None:
        valid = kpos[None] < kv_valid_len[:, None, None]     # (B,1,Skv)
        s = torch.where(valid[:, None], s, torch.full((), NEG, device=q.device))
    return s


def _expand_kv(k, v, group):
    if group > 1:
        return k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    return k, v


def mha_ref(q, k, v, *, bias=None, causal=False, window=None,
            kv_valid_len=None, softmax_scale=None, q_offset=0):
    """Masked multi-head attention, materializing the score tensor.

    q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D) with Hq % Hkv == 0 (GQA);
    bias (Bb,Hq,Sq,Skv) with B % Bb == 0 (block broadcast);
    kv_valid_len (B,) int32.  A fully masked row returns mean(v).
    ``q_offset``: the position of q's first row among the keys' (the
    causal and window masks of a block of query rows).
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kx, vx = _expand_kv(k, v, hq // hkv)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    s = _scores(q, kx, bias, b, _scale(d, softmax_scale), qpos, kpos, causal,
                window, kv_valid_len)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vx.float())
    return o.to(q.dtype)


def mha_chunked(q, k, v, *, bias=None, causal=False, window=None,
                kv_valid_len=None, softmax_scale=None, q_chunk=512, q_offset=0):
    """Query-chunked attention: :func:`mha_ref`'s semantics with a score
    tensor of only (B, H, q_chunk, Skv) at a time."""
    b, sq, hq, d = q.shape
    if sq <= q_chunk or sq % q_chunk:
        return mha_ref(q, k, v, bias=bias, causal=causal, window=window,
                       kv_valid_len=kv_valid_len, softmax_scale=softmax_scale,
                       q_offset=q_offset)
    skv, hkv = k.shape[1], k.shape[2]
    kx, vx = _expand_kv(k, v, hq // hkv)
    kpos = torch.arange(skv, device=q.device)[None, :]
    outs = []
    for c0 in range(0, sq, q_chunk):
        bb = None if bias is None else bias[:, :, c0:c0 + q_chunk]
        qpos = q_offset + c0 + torch.arange(q_chunk, device=q.device)[:, None]
        s = _scores(q[:, c0:c0 + q_chunk], kx, bb, b, _scale(d, softmax_scale),
                    qpos, kpos, causal, window, kv_valid_len)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, vx.float()))
    return torch.cat(outs, dim=1).to(q.dtype)
