"""CUDA kernel wrapper: token-wise MHA with online softmax.

Replaces ``repro/kernels/flash_attention/flash_attention.py:flash_mha_pallas``.
A block of a kernel (``csrc/flash_attention.cu``, ``csrc/flash_decode.cu``,
``csrc/flash_prefill.cu``, ``csrc/flash_f32.cu``) owns its query rows and
loops over key tiles inside the block, keeping the float32 (m, l, o) state
in registers; the TPU kernel's sequential KV grid axis has no CUDA
counterpart.  Six variants, chosen by a fixed rule on the operands
(:func:`variant_for`) and counted apart:

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
* f32 q/k/v at one query row, no bias, causal or window mask, D <= 320
  (every float32 decode step): the float32 decode kernel, counted as
  ``flash_mha_f32_dec``: the decode kernel's blocks, splits and cluster
  merge (:func:`dec_plan`), both products on the TF32 tensor cores with
  each operand split into hi + lo (three products: float32's precision).
* every other f32 call (a bias, a mask, more query rows) and every head
  dim above 256: the float32 kernel, counted as ``flash_mha_f32``: 64 or
  128 query rows a block, the same split products, key tiles a mask hides
  skipped; one panel of output columns up to head dim 320 (at 320 columns
  the block's warps work in pairs, each half of a key tile's logits and
  half of the columns), above it QK^T over the whole head dim and the
  output columns in panels of at most 256 (:func:`f32_plan`, which names
  the kernel's instance and layout; the C entry point launches it).  A
  bf16 call above 256 is widened exactly to float32 and its output rounded
  once to bf16.
  Neither float32 kernel has an alignment rule: q, k and v are read 16
  bytes at a time where they are 16-byte aligned, else 4.

The float32 kernels take any head dim that is a multiple of 8; the bf16
ones theirs.  Any other head dim (the reduced MLA's 24 in bf16, say, or 20
in f32) is padded: q, k and v gain zero columns up to the smallest head dim
whose variant takes the call (:func:`launch_head_dim`), the softmax scale
stays the true head dim's, and the output is sliced back.  The padded
columns add exact zeros to every logit and are zero in the output.

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
TC_HEAD_DIMS = HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)   # the bf16 kernels'
WG_HEAD_DIMS = (32, 64)
DEC_HEAD_DIMS = PF_HEAD_DIMS = (64, 96, 128, 192, 256)
MAX_BF16_D = 256     # above it a bf16 call is widened to float32
TC, WG, DEC, PF, F32, F32_DEC = "tc", "wg", "dec", "pf", "f32", "f32_dec"
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
# the float32 kernels (csrc/flash_f32.cu): query rows a block, the widest
# output panel above the widest head dim taken in one panel, the shared
# memory a block may take
F32_ROWS, F32_PANEL, F32_ONE_PANEL, F32_SMEM_LIMIT = 64, 256, 320, 232448
F32_DEC_MAX_D = 320  # the float32 decode kernel's widest head dim (one 320-column instance)
# variant -> its name in ``dispatch.launch_counts`` and its C entry point's stem
VARIANT_NAMES = {TC: "flash_mha", WG: "flash_mha_wg", DEC: "flash_mha_dec",
                 PF: "flash_mha_pf", F32: "flash_mha_f32", F32_DEC: "flash_mha_f32_dec"}
launches = 0          # tensor-core kernel launches (bf16, D in TC_HEAD_DIMS)
wg_launches = 0       # Hopper kernel launches (the fold's attention)
dec_launches = 0      # decode kernel launches (one query row, no bias or mask)
pf_launches = 0       # Hopper prefill kernel launches (no bias)
f32_launches = 0      # float32 kernel launches (and bf16 above head dim 256)
f32_dec_launches = 0  # float32 decode kernel launches (one query row, no bias or mask)
plain_calls = 0       # calls that computed the plain version (CPU tensors)


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
    tensor-core kernel.  A float32 call at one query row without a bias,
    a causal or window mask and at D <= 320 takes the float32 decode
    kernel, every other float32 call the float32 kernel; a bf16 call above
    D = 256 the same as in float32 (widened).  A head dim the chosen kernel does not take is padded
    (:func:`launch_head_dim`)."""
    if dtype != torch.bfloat16 or d > MAX_BF16_D:
        if (not has_bias and sq == 1 and not causal and window is None
                and d <= F32_DEC_MAX_D):
            return F32_DEC
        return F32
    if (d in WG_HEAD_DIMS and sq > 1 and hq == hkv and hq % WG_HEADS == 0 and has_bias
            and not causal and window is None):
        return WG
    if not has_bias and sq == 1 and not causal and window is None and d in DEC_HEAD_DIMS:
        return DEC
    if not has_bias and sq > 1 and d in PF_HEAD_DIMS:
        return PF
    return TC


#: variant -> the head dims its kernel takes (the float32 kernels: every
#: multiple of 8)
VARIANT_HEAD_DIMS = {TC: TC_HEAD_DIMS, WG: WG_HEAD_DIMS, DEC: DEC_HEAD_DIMS,
                     PF: PF_HEAD_DIMS}


def launch_head_dim(dtype: torch.dtype, d: int, **kw) -> int:
    """The head dim a launch of head dim ``d`` runs at: ``d`` where
    :func:`variant_for` (with ``kw``) gives the call a kernel that takes
    it, else the smallest head dim above ``d`` for which it does (q, k and v
    are then padded with zero columns): the next multiple of 8 on the
    float32 kernels (every f32 call, and bf16 above 256), the next head dim
    in ``TC_HEAD_DIMS`` that the chosen bf16 kernel takes otherwise."""
    if dtype != torch.bfloat16 or d > MAX_BF16_D:
        return _cdiv(d, 8) * 8
    for dp in (d, *(x for x in HEAD_DIMS if x > d)):
        if dp in VARIANT_HEAD_DIMS[variant_for(dtype, dp, **kw)]:
            return dp
    raise AssertionError("unreachable: the tensor-core kernel takes D = 256")


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
class F32Plan:
    """How the float32 kernel cuts a launch: ``rows`` query rows of one head
    a block, the output columns in ``panels`` panels of ``dv``, on the
    instance of ``cols`` columns and ``bk`` keys a tile, Q staged in shared
    memory where ``q_smem``.  The C entry point takes it as it is."""
    dv: int          # output columns a panel: D itself in one panel
    cols: int        # the instance's columns (at least dv)
    rows: int        # query rows a block: 16 a warp, 4 or 8 warps
    bk: int          # keys a tile
    q_smem: bool     # Q in shared memory (else read from device memory)
    smem: int        # the block's shared memory, bytes
    panels: int      # blocks along the columns, each recomputing the logits
    blocks: int      # query tiles x Hq x B x panels

    def c_args(self) -> tuple:
        return self.dv, self.cols, self.rows, self.bk, int(self.q_smem)


#: the float32 kernel's instances (csrc/flash_f32.cu: flash_mha_f32_launch)
#: as (output columns, keys a tile, query rows a block), the most keys first;
#: above 256 columns a block's warps work in pairs (twice the warps a row)
F32_INSTANCES = ((16, 64, 64), (32, 64, 64), (64, 64, 64), (96, 32, 128), (128, 32, 128),
                 (192, 32, 128), (192, 32, 64), (192, 16, 64), (256, 16, 128), (256, 32, 64),
                 (256, 16, 64), (320, 16, 64))
F32_COLS = tuple(sorted({c for c, _, _ in F32_INSTANCES}))


def _f32_smem(d: int, cols: int, bk: int, rows: int, q_smem: bool) -> int:
    """A block's shared memory (csrc: smem_bytes): Q's rows where staged,
    then two stages of a K and a V tile, rows padded to 8 (Q, K) or 4 (V)
    mod 16 floats, V's as wide as the instance, then above 256 columns the
    logits a pair of warps swaps (a key tile's for each row)."""
    qk = d if d % 16 else d + 8
    return ((rows * qk if q_smem else 0) + 2 * bk * (qk + cols + 4)
            + (rows * bk if cols > F32_PANEL else 0)) * 4


def _f32_layout(d: int, cols: int, rows: int) -> tuple[int, bool, int] | None:
    """(keys a tile, Q staged, bytes) of the instances of ``cols`` columns
    and ``rows`` rows: the most keys whose tiles fit beside Q in shared
    memory, else the most keys with Q read from device memory; None where
    nothing fits."""
    for q_smem in (True, False):
        for c, bk, r in F32_INSTANCES:
            if (c, r) == (cols, rows):
                smem = _f32_smem(d, cols, bk, rows, q_smem)
                if smem <= F32_SMEM_LIMIT:
                    return bk, q_smem, smem
    return None


def f32_plan(b: int, sq: int, hq: int, d: int) -> F32Plan:
    """The float32 kernel's blocks for q (b, sq, hq, d), d a multiple of 8:
    one panel of d columns up to ``F32_ONE_PANEL``, else the fewest panels
    of at most 256 columns (a multiple of 8 each, the last one narrower
    where they do not divide d) whose K and V tiles fit a block, each above
    128 columns.  The instance: the fewest columns that hold a panel; 128
    query rows a block (8 warps) at 65 to 128 columns (its only instances
    there), and at 129 to 256 columns in one panel where there are more
    than 64 query rows and they fit; else 64 (4 warps, or at 320 columns 8
    in pairs).  Raises where a K
    and a V tile of 16 keys outgrow a block's shared memory (d above about
    1,600).  Runs without tensors."""
    def cols_of(dv):
        return next(c for c in F32_COLS if c >= dv)
    panels, dv = 1, d
    if d > F32_ONE_PANEL:
        panels = _cdiv(d, F32_PANEL)
        dv = _cdiv(_cdiv(d, panels), 8) * 8
        # narrower panels (but above 128 columns) where a K and a V tile do
        # not fit
        while not _f32_layout(d, cols_of(dv), F32_ROWS):
            dv_next = _cdiv(_cdiv(d, panels + 1), 8) * 8
            if dv_next <= 128:
                break
            panels, dv = panels + 1, dv_next
    cols, rows = cols_of(dv), F32_ROWS
    if 64 < cols <= 128:
        rows = 2 * F32_ROWS
    elif 128 < cols <= 256 and panels == 1 and sq > F32_ROWS and \
            _f32_layout(d, cols, 2 * F32_ROWS):
        rows = 2 * F32_ROWS
    layout = _f32_layout(d, cols, rows)
    if layout is None:
        raise ValueError(f"flash_mha_kernel: head dim {d}: the float32 kernel's K and V "
                         f"tiles do not fit a block's {F32_SMEM_LIMIT} bytes")
    bk, q_smem, smem = layout
    return F32Plan(dv=dv, cols=cols, rows=rows, bk=bk, q_smem=q_smem, smem=smem,
                   panels=panels, blocks=_cdiv(sq, rows) * hq * b * panels)


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
    plan: WgPlan | DecPlan | PfPlan | F32Plan | None = None   # the variant's blocks
    head_dim: int = 0              # the operands' own D (sizes hold the padded one)
    widened: bool = False          # bf16 operands widened to f32 (D above 256)

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
    and prefill variants; the float32 ones have no alignment rule).  A bf16
    call above D = 256 is widened to float32 (``widened``).  A call
    :func:`variant_for` gives the Hopper
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
    variant = variant_for(q.dtype, d, **kw)
    widened = q.dtype == torch.bfloat16 and variant in (F32, F32_DEC)
    if widened:
        q, k, v = (t.float() for t in (q, k, v))      # exact
    if d != d0:
        # zero columns: every logit and output column as at d0 (the scale d0's)
        softmax_scale = _scale(d0, softmax_scale)
        q, k, v = (F.pad(t, (0, d - d0)) for t in (q, k, v))
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
    elif variant in (DEC, F32_DEC):
        plan = dec_plan(b, skv, hq, hkv)
    elif variant == F32:
        plan = f32_plan(b, sq, hq, d)
        if plan.blocks // plan.panels > INT32_MAX or plan.panels > 65535:
            raise ValueError(f"flash_mha_kernel: B={b}, Sq={sq}, Hq={hq}, D={d} exceed the "
                             "float32 kernel's grid")
    return FlashLaunchArgs(
        variant=variant, qkv_is_bf16=int(q.dtype == torch.bfloat16), bias_kind=bias_kind,
        sizes=(b, sq, skv, hq, hkv, d, bb), q_strides=tuple(q.stride()[:3]),
        k_strides=tuple(k.stride()[:3]), v_strides=tuple(v.stride()[:3]),
        bias_strides=bstr, causal=int(causal), window=-1 if window is None else int(window),
        scale=_scale(d, softmax_scale), plan=plan, head_dim=d0, widened=widened), q, k, v


def flash_mha_kernel(q, k, v, bias=None, kv_valid_len=None, *, causal=False,
                     window=None, softmax_scale=None):
    """q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D); bias (Bb,Hq,Sq,Skv); -> (B,Sq,Hq,D)."""
    global launches, wg_launches, dec_launches, pf_launches, f32_launches, f32_dec_launches
    global plain_calls
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
             (args.plan.split, args.plan.splits) if args.variant in (DEC, F32_DEC) else
             args.plan.c_args() if args.variant == F32 else ())
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
    elif args.variant == F32:
        f32_launches += 1
    else:
        f32_dec_launches += 1
    o = o if d == args.head_dim else o[..., :args.head_dim]
    return o.to(torch.bfloat16) if args.widened else o
