"""CUDA kernel wrapper: token-wise MHA with online softmax.

Replaces ``repro/kernels/flash_attention/flash_attention.py:flash_mha_pallas``.
A block of a kernel (``csrc/flash_attention.cu``, ``csrc/flash_decode.cu``,
``csrc/flash_prefill.cu``) owns its query rows and loops over key tiles
inside the block, keeping the float32 (m, l, o) state in registers; the TPU
kernel's sequential KV grid axis has no CUDA counterpart.  Five variants,
chosen by a fixed rule on the operands (:func:`variant_for`) and counted
apart:

* the fold's attention (bf16 q/k/v with D in {32, 64}, Hq == Hkv a multiple
  of 4, an additive bias, more than one query row, no causal or window
  mask): the Hopper kernel, ``wgmma`` for QK^T and PV, TMA with
  ``mbarrier``s and a producer warpgroup for the Q, K, V and bias tiles,
  one bias tile for every row of a bias block that a block owns
  (:func:`wg_plan`).  TMA reads whole tiles, so the tensors' base pointers
  and the strides its maps use must be multiples of 16 bytes; q, k or v
  off that raises.  A bias that no TMA box takes (neither its heads nor
  its keys innermost, or rows off 16 bytes), or a softmax scale that is
  not positive, sends the call to the tensor-core kernel instead, counted
  as ``flash_mha``.
* one query row a slot, no bias, causal or window mask, D in {64, 96, 128,
  192, 256} (the LM tenant's served step, every zoo decode step): the
  decode kernel, counted as ``flash_mha_dec``.  A block holds the query
  heads of one KV head (GQA read once) and one split of a fixed number of
  keys (:func:`dec_plan`: from the ring length and head counts alone,
  never from the batch or the other slots' lengths); a slot's splits are
  one thread-block cluster and merge their (m, l, o) in a fixed order
  through each other's shared memory.  16-byte ``cp.async`` loads, as the
  tensor-core kernel.
* more than one query row, no bias, D in {64, 96, 128, 192, 256}, a
  positive softmax scale (the zoo's prefills, causal, window, GQA/MQA): the
  Hopper prefill kernel, counted as ``flash_mha_pf``: ``wgmma``, TMA with
  an ``mbarrier`` ring and a producer warpgroup, two consumer warpgroups
  of 64 query rows (three at D = 64) sharing each K/V tile
  (:func:`pf_plan`), key tiles a mask hides skipped.  TMA reads whole tiles: q, k, v off 16 bytes raise.
* every other bf16 call with D in {16, 32, 64, 96, 128, 192, 256} (a bias
  off the fold, D = 16 or 32 without one, a causal or window mask at one
  query row, a prefill scale <= 0): the tensor-core kernel,
  FlashAttention-2 with ``mma.sync`` (QK^T and a PV product split into
  P_hi + P_lo, so P is not rounded to bf16), K/V/bias tiles through a
  two-stage ``cp.async`` ring.  It reads q, k and v 16 bytes at a time, so
  it needs 16-byte aligned base pointers and strides.
* f32 q/k/v with D in {8, 16, 32, 64, 96, 128, 192, 256}, or bf16 at
  D = 8: the SIMT kernel, float32 on the CUDA cores.

Any other head dim up to 256 (the reduced MLA's 24, say) is padded: q, k
and v gain zero columns up to the smallest head dim whose variant takes the
call (:func:`launch_head_dim`), the softmax scale stays the true head
dim's, and the output is sliced back.  The padded columns add exact zeros
to every logit and are zero in the output.  A head dim above 256 raises.

Additive bias (f32 or bf16) is broadcast by block, GQA, causal, sliding
window and ``kv_valid_len`` are one predicate each.  Strides are passed as
64-bit integers and every offset in the kernels is 64-bit, so the trunk's
operands at any length it folds are taken as they are.

On a CUDA tensor the wrapper launches the kernel or raises.  On a CPU
tensor it computes :func:`flash_mha_plain`, the kernel's plain version.
The kernel has no backward: an operand that requires grad under grad mode
is refused (``build.refuse_grad``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import _block_broadcast_bias

NEG = -1e30
TC_HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)
SIMT_HEAD_DIMS = (8, 16, 32, 64, 96, 128, 192, 256)
HEAD_DIMS = tuple(sorted(set(TC_HEAD_DIMS) | set(SIMT_HEAD_DIMS)))
WG_HEAD_DIMS = (32, 64)
DEC_HEAD_DIMS = PF_HEAD_DIMS = (64, 96, 128, 192, 256)
TC, SIMT, WG, DEC, PF = "tc", "simt", "wg", "dec", "pf"
INT32_MAX = 2 ** 31 - 1
# the Hopper variant (csrc: namespace wg): heads a block (one a consumer
# warpgroup), query rows a tile, batch rows a block at D = 32 (all sharing
# one bias tile), and the bias's TMA boxes
WG_HEADS, WG_BQ, WG_ROWS = 4, 64, 2
WG_FUSED, WG_HEADS_INNER, WG_KEYS_INNER, WG_FUSED_Q = 0, 1, 2, 3
# the decode variant (csrc/flash_decode.cu): query heads a block, keys a
# tile, and the most splits (blocks of one cluster) a slot takes
DEC_ROWS, DEC_TILE, DEC_MAX_SPLITS = 16, 64, 8
# the prefill variant (csrc/flash_prefill.cu: consumers<D>()): consumer
# warpgroups of 64 query rows a block, by head dim
PF_CONSUMERS = {64: 3, 96: 2, 128: 2, 192: 2, 256: 2}
# variant -> its name in ``dispatch.launch_counts`` and its C entry point's stem
VARIANT_NAMES = {TC: "flash_mha", SIMT: "flash_mha_simt", WG: "flash_mha_wg",
                 DEC: "flash_mha_dec", PF: "flash_mha_pf"}
launches = 0        # tensor-core kernel launches (bf16, D in TC_HEAD_DIMS)
simt_launches = 0   # SIMT kernel launches (f32, or bf16 at D = 8)
wg_launches = 0     # Hopper kernel launches (the fold's attention)
dec_launches = 0    # decode kernel launches (one query row, no bias or mask)
pf_launches = 0     # Hopper prefill kernel launches (no bias)
plain_calls = 0     # calls that computed the plain version (CPU tensors)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    s = torch.where(ok, s, torch.full((), NEG, device=q.device))   # no host copy
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vx.float())
    o = o / torch.clamp_min(l, 1e-30).permute(0, 2, 1, 3)
    return o.to(q.dtype)


def variant_for(dtype: torch.dtype, d: int, *, sq: int = 1, hq: int = 1, hkv: int = 1,
                has_bias: bool = False, causal: bool = False, window=None) -> str:
    """The kernel a launch takes: a fixed rule on the inputs' type, head dim,
    query rows, heads, bias and masks.  The fold's attention (bf16, D 32 or
    64, Hq == Hkv a multiple of 4, a bias, more than one query row, no
    causal or window mask) takes the Hopper kernel, unless its bias suits no
    TMA box or its scale is not positive (:func:`_flash_launch_args` then
    gives it the tensor-core kernel); a bf16 call without a bias at D in
    {64, 96, 128, 192, 256} the decode kernel at one query row without a
    causal or window mask, the prefill kernel at more rows (a scale that is
    not positive: the tensor-core kernel); any other bf16 call the
    tensor-core kernel; f32 and D = 8 the SIMT kernel (float32 at D in
    ``SIMT_HEAD_DIMS``: 8 to 256, the zoo's 96, 192 and 256 among them).
    A head dim the chosen kernel does not take is padded
    (:func:`launch_head_dim`)."""
    if dtype != torch.bfloat16:
        return SIMT
    if (d in WG_HEAD_DIMS and sq > 1 and hq == hkv and hq % WG_HEADS == 0 and has_bias
            and not causal and window is None):
        return WG
    if not has_bias and sq == 1 and not causal and window is None and d in DEC_HEAD_DIMS:
        return DEC
    if not has_bias and sq > 1 and d in PF_HEAD_DIMS:
        return PF
    return TC if d in TC_HEAD_DIMS else SIMT


#: variant -> the head dims its kernel takes
VARIANT_HEAD_DIMS = {TC: TC_HEAD_DIMS, SIMT: SIMT_HEAD_DIMS, WG: WG_HEAD_DIMS,
                     DEC: DEC_HEAD_DIMS, PF: PF_HEAD_DIMS}


def launch_head_dim(dtype: torch.dtype, d: int, **kw) -> int:
    """The head dim a launch of head dim ``d`` runs at: ``d`` where
    :func:`variant_for` (with ``kw``) gives the call a kernel that takes
    it, else the smallest head dim above ``d`` for which it does (q, k and v
    are then padded with zero columns).  Raises above 256."""
    for dp in (d, *(x for x in HEAD_DIMS if x > d)):
        if dp in VARIANT_HEAD_DIMS[variant_for(dtype, dp, **kw)]:
            return dp
    raise ValueError(f"flash_mha_kernel: head dim {d}: no variant takes a head dim above "
                     f"{HEAD_DIMS[-1]}")


@dataclasses.dataclass(frozen=True)
class DecPlan:
    """How the decode kernel cuts a launch: each slot's keys into ``splits``
    blocks of ``split`` keys (one thread-block cluster), its query heads
    into groups of 16 a KV head."""
    split: int       # keys a block: a multiple of DEC_TILE
    splits: int      # blocks (cluster size) a slot and head group: 1..DEC_MAX_SPLITS
    blocks: int      # splits x KV heads x head groups x B


def dec_plan(b: int, skv: int, hq: int, hkv: int) -> DecPlan:
    """The decode kernel's blocks for q (b, 1, hq, D) against a ring (b,
    skv, hkv, D): the split is the smallest multiple of 64 keys that cuts
    the ring into at most 8 splits, and at least 128 keys where a slot has 8
    or more blocks of heads (KV heads x groups of 16 query heads) to spread
    over the card already: a cluster's blocks cost time even where the
    slot's keys leave them nothing to do.  Chosen from the ring length and
    the head counts alone, so a slot's splits, their order and its output
    do not depend on ``b`` or on the other slots' key lengths.  Runs without
    tensors."""
    groups = _cdiv(hq // hkv, DEC_ROWS)
    least = 2 * DEC_TILE if hkv * groups >= 8 else DEC_TILE
    split = max(least, _cdiv(_cdiv(skv, DEC_MAX_SPLITS), DEC_TILE) * DEC_TILE)
    splits = max(1, _cdiv(skv, split))
    return DecPlan(split=split, splits=splits, blocks=splits * hkv * groups * b)


@dataclasses.dataclass(frozen=True)
class PfPlan:
    """How the prefill kernel cuts a launch into blocks."""
    rows: int        # query rows a block: 64 a consumer warpgroup
    blocks: int      # query tiles x Hq x B, the last tile's first


def pf_plan(b: int, sq: int, hq: int, d: int) -> PfPlan:
    """The prefill kernel's blocks for q (b, sq, hq, d): one block a query
    tile and head, the tile 64 rows a consumer warpgroup (two, three at
    D = 64).  Runs without tensors."""
    rows = 64 * PF_CONSUMERS[d]
    return PfPlan(rows=rows, blocks=_cdiv(sq, rows) * hq * b)


@dataclasses.dataclass(frozen=True)
class WgPlan:
    """How the Hopper kernel cuts a launch into blocks."""
    rows: int        # batch rows a block: divides each bias block's B // Bb rows
    bias_map: int    # the bias's TMA box: WG_FUSED, WG_HEADS_INNER, WG_KEYS_INNER, WG_FUSED_Q
    blocks: int      # query tiles x head groups x row groups


def _aligned(*byte_values) -> bool:
    return all(x % 16 == 0 for x in byte_values)


def _wg_plan(b: int, sq: int, hq: int, d: int, bias: torch.Tensor,
             scale: float) -> WgPlan | str:
    """:func:`wg_plan`'s plan, or the reason the Hopper kernel refuses the
    call."""
    if not scale > 0:
        return (f"flash_mha_kernel: the Hopper kernel takes a positive softmax scale, "
                f"not {scale}")
    bb = bias.shape[0]
    esize = bias.element_size()
    sb, sh, sqs, sk = bias.stride()
    if sh == 1 and sk == hq == WG_HEADS:
        bias_map, stepped = WG_FUSED, ((sqs, sq), (sb, bb))
    elif sh == 1 and sqs == hq == WG_HEADS:
        bias_map, stepped = WG_FUSED_Q, ((sk, bias.shape[3]), (sb, bb))
    elif sh == 1 and bias.dtype == torch.float32:
        bias_map, stepped = WG_HEADS_INNER, ((sk, bias.shape[3]), (sqs, sq), (sb, bb))
    elif sk == 1:
        bias_map, stepped = WG_KEYS_INNER, ((sqs, sq), (sh, hq), (sb, bb))
    else:
        return (f"flash_mha_kernel: the Hopper kernel reads the bias by TMA, and a "
                f"{bias.dtype} bias with strides {bias.stride()} suits no TMA box "
                "(keys innermost, heads innermost in f32, or 4 dense heads a key or a query)")
    if not _aligned(bias.data_ptr(), *(st * esize for st, n in stepped if n > 1)):
        return (f"flash_mha_kernel: the bias is read by TMA; its base pointer or strides "
                f"{bias.stride()} are not 16-byte aligned")
    rows = WG_ROWS if d == 32 and (b // bb) % WG_ROWS == 0 else 1
    return WgPlan(rows=rows, bias_map=bias_map,
                  blocks=-(-sq // WG_BQ) * (hq // WG_HEADS) * (b // rows))


def wg_plan(b: int, sq: int, hq: int, d: int, bias: torch.Tensor, *,
            scale: float = 1.0) -> WgPlan:
    """The Hopper kernel's blocks for q (b, sq, hq, d) and ``bias`` (Bb, hq,
    sq, skv), block-broadcast over b.  A block takes 4 heads of one 64-row
    query tile and, at D = 32, two batch rows of one bias block (else one),
    so the rows it shares a bias tile with never cross a bias block.  The
    bias's TMA box: heads and keys fused into one dense dimension (heads
    innermost, 4 a key: triangular attention's permuted projection),
    heads and queries fused (4 heads a query: the same bias gathered on a
    mesh rank, keys outermost), heads innermost (f32: 4 heads make the 16
    bytes a box row needs), or keys innermost.  Raises on what the kernel
    does not take: a bias layout with neither heads nor keys innermost, a
    bf16 one with heads innermost and neither keys nor queries next to 4
    dense heads, a base pointer or a stride that the box steps not a
    multiple of 16 bytes, or a softmax ``scale`` that is not positive.
    Runs on ``meta`` tensors."""
    plan = _wg_plan(b, sq, hq, d, bias, scale)
    if isinstance(plan, str):
        raise ValueError(plan)
    return plan


def wg_plan_or_none(b: int, sq: int, hq: int, d: int, bias: torch.Tensor, *,
                    scale: float = 1.0) -> WgPlan | None:
    """:func:`wg_plan`, or None where it would raise: the launch then takes
    the tensor-core kernel."""
    plan = _wg_plan(b, sq, hq, d, bias, scale)
    return None if isinstance(plan, str) else plan


@dataclasses.dataclass(frozen=True)
class FlashLaunchArgs:
    """Everything ``flash_mha_launch`` takes besides pointers and stream."""
    variant: str
    qkv_is_bf16: int
    bias_kind: int                 # 0 none, 1 f32, 2 bf16
    sizes: tuple                   # B, Sq, Skv, Hq, Hkv, D, Bb
    q_strides: tuple               # (b, s, h), elements
    k_strides: tuple
    v_strides: tuple
    bias_strides: tuple            # (b, h, q, k), elements; zeros without a bias
    causal: int
    window: int                    # -1: no sliding window
    scale: float
    plan: WgPlan | DecPlan | PfPlan | None = None   # the Hopper and decode variants' blocks
    head_dim: int = 0              # the operands' own D (sizes hold the padded one)

    def c_args(self) -> tuple:
        return (self.qkv_is_bf16, self.bias_kind, *self.sizes, *self.q_strides,
                *self.k_strides, *self.v_strides, *self.bias_strides, self.causal,
                self.window, self.scale)


def _flash_launch_args(q, k, v, bias=None, kv_valid_len=None, *, causal=False,
                       window=None, softmax_scale=None) -> FlashLaunchArgs:
    """Validate the operands of a launch and pack its scalar arguments
    (:func:`_flash_launch`'s arguments alone)."""
    return _flash_launch(q, k, v, bias, kv_valid_len, causal=causal, window=window,
                         softmax_scale=softmax_scale)[0]


def _flash_launch(q, k, v, bias=None, kv_valid_len=None, *, causal=False,
                  window=None, softmax_scale=None):
    """Validate the operands of a launch and pack its scalar arguments;
    -> (arguments, q, k, v as launched: zero-padded to
    :func:`launch_head_dim` where the head dim needs it).

    Launches nothing, so it runs on ``meta`` tensors.  Raises
    on what the kernels do not take: a head dim without unit stride, shapes
    that do not match, a bias that does not broadcast, a size beyond 32 bits,
    and, for the tensor-core variant, a q/k/v base pointer or (b, s, h)
    stride that is not a multiple of 16 bytes (also for the Hopper, decode
    and prefill variants).  A call :func:`variant_for` gives the Hopper
    kernel whose bias no TMA box takes, or whose softmax scale is not
    positive (:func:`wg_plan_or_none`), takes the tensor-core variant, and
    so does a prefill call whose scale is not positive.  Strides are the tensors'
    own: the kernels index in 64 bits, so no stride or offset bound
    remains."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_mha_kernel: q, k, v must be (B, S, H, D)")
    b, sq, hq, d0 = q.shape
    _, skv, hkv, _ = k.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_mha_kernel: dtype {q.dtype} not bf16/f32")
    for name, a in (("k", k), ("v", v)):
        if a.shape != (b, skv, hkv, d0) or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"flash_mha_kernel: {name} {tuple(a.shape)} {a.dtype} does "
                             f"not match q {tuple(q.shape)} {q.dtype}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_mha_kernel: Hq={hq} not a multiple of Hkv={hkv}")
    kw = dict(sq=sq, hq=hq, hkv=hkv, has_bias=bias is not None, causal=causal, window=window)
    d = launch_head_dim(q.dtype, d0, **kw)
    if d != d0:
        # zero columns: every logit and output column as at d0 (the scale d0's)
        softmax_scale = _scale(d0, softmax_scale)
        q, k, v = (F.pad(t, (0, d - d0)) for t in (q, k, v))
    variant = variant_for(q.dtype, d, **kw)
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.stride(-1) != 1:
            raise ValueError(f"flash_mha_kernel: {name} head dim must have unit stride")
        if variant in (TC, WG, DEC, PF) and not _aligned(
                a.data_ptr(), *(st * a.element_size() for st in a.stride()[:3])):
            how = ("by the Hopper kernel's TMA" if variant in (WG, PF)
                   else "16 bytes at a time")
            raise ValueError(f"flash_mha_kernel: {name} is read {how}; its "
                             f"base pointer or strides {a.stride()} are not 16-byte aligned")
    bias_kind, bb, bstr = 0, 1, (0, 0, 0, 0)
    if bias is not None:
        bias_kind = {torch.float32: 1, torch.bfloat16: 2}.get(bias.dtype)
        if bias_kind is None:
            raise ValueError(f"flash_mha_kernel: bias dtype {bias.dtype} not f32/bf16")
        bb = bias.shape[0] if bias.dim() == 4 else 0
        if bias.device != q.device or bias.dim() != 4 or \
                tuple(bias.shape[1:]) != (hq, sq, skv) or bb == 0 or b % bb:
            raise ValueError(f"flash_mha_kernel: bias {tuple(bias.shape)} does not "
                             f"broadcast to ({b}, {hq}, {sq}, {skv})")
        bstr = tuple(bias.stride())
    if kv_valid_len is not None and tuple(kv_valid_len.shape) != (b,):
        raise ValueError(f"flash_mha_kernel: kv_valid_len {tuple(kv_valid_len.shape)} "
                         f"is not ({b},)")
    if max(b, sq, skv, hq) > INT32_MAX or -(-sq // 64) * hq * b > INT32_MAX:
        raise ValueError(f"flash_mha_kernel: B={b}, Sq={sq}, Skv={skv}, Hq={hq} exceed the "
                         "kernel's 32-bit sizes or grid")
    plan = None
    if variant == WG:
        plan = wg_plan_or_none(b, sq, hq, d, bias, scale=_scale(d, softmax_scale))
        variant = WG if plan is not None else TC
    elif variant == PF:
        if _scale(d, softmax_scale) > 0:
            plan = pf_plan(b, sq, hq, d)
        else:
            variant = TC
    elif variant == DEC:
        plan = dec_plan(b, skv, hq, hkv)
    return FlashLaunchArgs(
        variant=variant, qkv_is_bf16=int(q.dtype == torch.bfloat16), bias_kind=bias_kind,
        sizes=(b, sq, skv, hq, hkv, d, bb), q_strides=tuple(q.stride()[:3]),
        k_strides=tuple(k.stride()[:3]), v_strides=tuple(v.stride()[:3]),
        bias_strides=bstr, causal=int(causal), window=-1 if window is None else int(window),
        scale=_scale(d, softmax_scale), plan=plan, head_dim=d0), q, k, v


def flash_mha_kernel(q, k, v, bias=None, kv_valid_len=None, *, causal=False,
                     window=None, softmax_scale=None):
    """q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D); bias (Bb,Hq,Sq,Skv); -> (B,Sq,Hq,D)."""
    global launches, simt_launches, wg_launches, dec_launches, pf_launches, plain_calls
    build.refuse_dtensor("flash_mha_kernel", q, k, v, bias, kv_valid_len)
    if q.device.type == "cpu":
        plain_calls += 1
        return flash_mha_plain(q, k, v, bias, kv_valid_len, causal=causal,
                               window=window, softmax_scale=softmax_scale)
    build.refuse_grad("flash_mha_kernel", q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_kernel: unsupported device {q.device}")
    args, q, k, v = _flash_launch(q, k, v, bias, kv_valid_len, causal=causal, window=window,
                                  softmax_scale=softmax_scale)
    if kv_valid_len is not None:
        kv_valid_len = kv_valid_len.to(device=q.device, dtype=torch.int32).contiguous()
    b, sq, _, hq, _, d, _ = args.sizes
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lib = build.library()
    name = VARIANT_NAMES[args.variant]
    extra = ((args.plan.rows, args.plan.bias_map) if args.variant == WG else
             (args.plan.split, args.plan.splits) if args.variant == DEC else ())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            kv_valid_len.data_ptr() if kv_valid_len is not None else None,
            o.data_ptr(), *args.c_args(), *extra, stream)
    build.check(err, name)
    if args.variant == TC:
        launches += 1
    elif args.variant == WG:
        wg_launches += 1
    elif args.variant == DEC:
        dec_launches += 1
    elif args.variant == PF:
        pf_launches += 1
    else:
        simt_launches += 1
    return o if d == args.head_dim else o[..., :args.head_dim]
