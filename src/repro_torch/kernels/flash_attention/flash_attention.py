"""CUDA kernel wrapper: token-wise MHA with online softmax.

Replaces ``repro/kernels/flash_attention/flash_attention.py:flash_mha_pallas``.
The kernel (``csrc/flash_attention.cu``) gives each block one (batch row,
head, 64-query tile) and loops over 64-key tiles inside the block, keeping
the float32 (m, l, o) state in registers; the TPU kernel's sequential KV
grid axis has no CUDA counterpart.  At the main-path shapes it is bound by
bytes on the H100; this first version runs both products on the CUDA cores
in float32 and is far from that bound.
Additive bias (f32 or bf16, any strides) is broadcast by block, GQA, causal,
sliding window and ``kv_valid_len`` are one predicate each.

On a CUDA tensor the wrapper launches the kernel or raises.  On a CPU
tensor it computes :func:`flash_mha_plain`, the kernel's plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import _block_broadcast_bias

NEG = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)
launches = 0        # kernel launches (CUDA tensors only)
plain_calls = 0     # calls that computed the plain version (CPU tensors)


def _scale(d: int, softmax_scale) -> float:
    return float(softmax_scale) if softmax_scale is not None else 1.0 / (d ** 0.5)


def flash_mha_plain(q, k, v, bias=None, kv_valid_len=None, *, causal=False,
                    window=None, softmax_scale=None):
    """The kernel's function in plain PyTorch: masked logits are NEG and get
    probability exactly 0, and a fully masked row returns 0 (``mha_ref``
    returns mean(v) there)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    kx = k.repeat_interleave(group, dim=2) if group > 1 else k
    vx = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) * _scale(d, softmax_scale)
    if bias is not None:
        s = s + _block_broadcast_bias(bias, b).float()
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    ok = ok[None, None].expand(b, 1, sq, skv)
    if kv_valid_len is not None:
        ok = ok & (kpos < kv_valid_len.to(q.device)[:, None, None, None])
    s = torch.where(ok, s, torch.tensor(NEG, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vx.float())
    o = o / torch.clamp_min(l, 1e-30).permute(0, 2, 1, 3)
    return o.to(q.dtype)


def flash_mha_kernel(q, k, v, bias=None, kv_valid_len=None, *, causal=False,
                     window=None, softmax_scale=None):
    """q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D); bias (Bb,Hq,Sq,Skv); -> (B,Sq,Hq,D)."""
    global launches, plain_calls
    if q.device.type == "cpu":
        plain_calls += 1
        return flash_mha_plain(q, k, v, bias, kv_valid_len, causal=causal,
                               window=window, softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_kernel: unsupported device {q.device}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_mha_kernel: head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_mha_kernel: dtype {q.dtype} not bf16/f32")
    for name, a in (("k", k), ("v", v)):
        if a.shape != (b, skv, hkv, d) or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"flash_mha_kernel: {name} {tuple(a.shape)} {a.dtype} does "
                             f"not match q {tuple(q.shape)} {q.dtype}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_mha_kernel: Hq={hq} not a multiple of Hkv={hkv}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.stride(-1) != 1:
            raise ValueError(f"flash_mha_kernel: {name} head dim must have unit stride")
    bias_kind, bb, bstr = 0, 1, (0, 0, 0, 0)
    if bias is not None:
        bias_kind = {torch.float32: 1, torch.bfloat16: 2}.get(bias.dtype)
        if bias_kind is None:
            raise ValueError(f"flash_mha_kernel: bias dtype {bias.dtype} not f32/bf16")
        bb = bias.shape[0]
        if bias.device != q.device or tuple(bias.shape[1:]) != (hq, sq, skv) or b % bb:
            raise ValueError(f"flash_mha_kernel: bias {tuple(bias.shape)} does not "
                             f"broadcast to ({b}, {hq}, {sq}, {skv})")
        bstr = bias.stride()
    if kv_valid_len is not None:
        kv_valid_len = kv_valid_len.to(device=q.device, dtype=torch.int32).contiguous()
        if kv_valid_len.shape != (b,):
            raise ValueError(f"flash_mha_kernel: kv_valid_len {tuple(kv_valid_len.shape)}"
                             f" is not ({b},)")
    for a in (q, k, v, bias):
        if a is not None and max(a.stride()) * max(a.shape) >= 2 ** 31:
            raise ValueError("flash_mha_kernel: tensor too large for 32-bit strides")
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_mha_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            kv_valid_len.data_ptr() if kv_valid_len is not None else None,
            o.data_ptr(), int(q.dtype == torch.bfloat16), bias_kind,
            b, sq, skv, hq, hkv, d, bb, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *bstr, int(causal), -1 if window is None else int(window),
            _scale(d, softmax_scale), stream)
    build.check(err, "flash_mha")
    launches += 1
    return o

