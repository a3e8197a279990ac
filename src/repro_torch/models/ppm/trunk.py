"""Protein Folding Block (ESMFold folding trunk / AF2 Evoformer style).

Port of ``repro/models/ppm/trunk.py``: a sequence track (B, Ns, Hm) and
the pair track (B, Ns, Ns, Hz) with

  * sequence attention with pair bias  + transition
  * outer-product-mean seq->pair update
  * triangular multiplication (outgoing + incoming)
  * triangular attention (starting + ending node)
  * pair transition

Every pair-dataflow activation passes through the active quantization
scheme at a named site; the sequence track is not quantized.  The trunk is
a Python loop over per-block parameter dicts (the reference stacks them for
``scan``); ``trunk_apply(..., chunk_size=)`` runs the row-chunked pair
stack (``chunking.py``).

Every op takes ``shard``: a ``repro_torch.parallel.sharding.PairShard``
(the serving tier: this rank's columns J of z, (B, N, N/W, Hz), ``s``
replicated) or a ``PairGrid`` (the reference's production layout: the
block z[:, I, J], (B, N/D, N/M, Hz), rows over the data axes and columns
over ``model``, and the sequence track's rows I).  A ``PairShard`` is the
grid of one row strip, and both speak the grid's vocabulary, so each op
below is written once; each fetches what its contraction needs (the
reference's GSPMD partitioning of the same ops, made explicit):

  * pair transition and every AAQ site: nothing (AAQ is token-wise, so
    each pair position is local);
  * the OPM update: ``s``'s rows I against its rows J (``seq_cols``);
  * tri-mul outgoing (x_ij = sum_k a_ik b_jk): ``a``'s rows I over every k
    (``row_strip``) and ``b``'s rows J over every k (``swap_rows``: the
    transpose's block, then gathered; an all-to-all on one row strip);
  * tri-mul incoming (x_ij = sum_k a_ki b_kj): ``a``'s columns I over
    every k (``swap_cols``) and ``b``'s columns J (``col_strip``);
  * tri-attention, starting node (attends over k along row i): an
    all-to-all to the rank's N/(DM) fine rows with every column and back,
    the (B, N, N, heads) bias gathered whole; ending node (attends over i
    at a fixed j): the same on the transposed block's fine columns;
  * sequence attention: queries on the rows I, keys and values gathered
    (``seq_whole``), the pair bias projected on the block and gathered to
    rows I over every j.

No rank holds an N x N operand of more than ``heads`` channels.  A gather
or a transpose concatenates and changes no sum, so with ``shard`` of one
rank the ops compute what the unsharded ops do.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.schemes import QuantScheme
from repro_torch.device import per_row
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.parallel import sharding as sh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class PPMConfig:
    blocks: int = 48
    hm: int = 1024          # sequence-representation hidden (ESMFold)
    hz: int = 128           # pair-representation hidden (paper: 128)
    seq_heads: int = 16
    pair_heads: int = 4     # head dim 32
    tri_hidden: int = 128
    transition_factor: int = 4
    vocab: int = 23         # 20 aa + X + gap + mask
    relpos_bins: int = 65
    recycles: int = 1
    distogram_bins: int = 64
    ipa_iters: int = 4
    dtype: str = "float32"

    @property
    def pair_head_dim(self) -> int:
        return self.hz // self.pair_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: PPMConfig) -> cm.Params:
    hm, hz, th = cfg.hm, cfg.hz, cfg.tri_hidden
    f = cfg.transition_factor
    dt, dev = cfg.torch_dtype, gen.device

    def d(i, o, bias=False):
        return cm.dense_init(gen, i, o, bias=bias, dtype=dt)

    def ln(dim):
        return cm.ln_init(dim, dt, dev)

    def tri_mul():
        return {
            "ln_in": ln(hz),
            "a_proj": d(hz, th), "a_gate": d(hz, th),
            "b_proj": d(hz, th), "b_gate": d(hz, th),
            "ln_out": ln(th),
            "out": d(th, hz), "out_gate": d(hz, hz),
        }

    def tri_attn():
        return {
            "ln": ln(hz),
            "qkv": d(hz, 3 * hz),
            "bias": d(hz, cfg.pair_heads),
            "gate": d(hz, hz),
            "out": d(hz, hz),
        }

    return {
        "seq_attn": {
            "ln": ln(hm),
            "qkv": d(hm, 3 * hm, bias=True),
            "pair_bias_ln": ln(hz),
            "pair_bias": d(hz, cfg.seq_heads),
            "gate": d(hm, hm),
            "out": d(hm, hm),
        },
        "seq_trans": {
            "ln": ln(hm),
            "up": d(hm, f * hm, bias=True), "down": d(f * hm, hm, bias=True),
        },
        "opm": {  # outer-product-mean seq -> pair
            "ln": ln(hm),
            "a": d(hm, 32), "b": d(hm, 32),
            "out": d(32 * 32, hz, bias=True),
        },
        "tri_mul_out": tri_mul(),
        "tri_mul_in": tri_mul(),
        "tri_attn_start": tri_attn(),
        "tri_attn_end": tri_attn(),
        "pair_trans": {
            "ln": ln(hz),
            "up": d(hz, f * hz, bias=True), "down": d(f * hz, hz, bias=True),
        },
    }


def init_trunk(gen: torch.Generator, cfg: PPMConfig) -> list[cm.Params]:
    """One parameter dict per block: ``trunk[i]`` (names ``trunk.<i>.*``)."""
    return [init_block(gen, cfg) for _ in range(cfg.blocks)]


# --------------------------------------------------------------------------
# padding-mask helpers
#
# ``mask`` is (B, N) bool — True at real tokens; ``None`` is the unmasked
# path.  Real-token values are only ever multiplied by exactly 1.0 or
# summed with exact-zero padded contributions, never rescaled (key masking
# goes through cm.key_padding_bias for the same reason).
# --------------------------------------------------------------------------

# Sequence length at/above which triangular attention takes the token-wise
# MHA path (rows as batch; the cubic score tensor is never materialized).
CHUNKED_ATTN_LEN = 256


def rows_valid_len(lens: torch.Tensor, rows: int) -> torch.Tensor:
    """(B,) key lengths -> (B*rows,): each protein's length repeated over
    its ``rows`` flattened rows: ``lens.repeat_interleave(rows)``, written
    as a broadcast so that no output size is read back from the card (a
    CUDA graph capture allows no such read)."""
    return lens[:, None].expand(lens.shape[0], rows).reshape(-1)


def _pair_mask(mask, shard=None):
    """(B, N) bool -> (B, N, N, 1) bool: True where both tokens are real
    (the rank's rows and columns only under ``shard``)."""
    rows, cols = mask, mask
    if shard is not None:
        n = mask.shape[1]
        rows, cols = mask[:, shard.rows(n)], mask[:, shard.cols(n)]
    return (rows[:, :, None] & cols[:, None, :])[..., None]


# --------------------------------------------------------------------------
# pair ops (with AAQ sites)
# --------------------------------------------------------------------------
def tri_mul_apply(p, z, scheme: QuantScheme, outgoing: bool, sc: str,
                  mask=None, shard=None):
    """Triangular multiplication. sc = site prefix ('tri_mul_out' etc.)."""
    z = scheme.act(z, f"{sc}.pre_ln")                       # Group A
    zl = cm.layernorm(p["ln_in"], z)
    zl = scheme.act(zl, f"{sc}.post_ln")                    # Group B
    a = (torch.sigmoid(cm.dense(p["a_gate"], zl, scheme, f"{sc}.gate"))
         * cm.dense(p["a_proj"], zl, scheme, f"{sc}.post_ln"))
    b = (torch.sigmoid(cm.dense(p["b_gate"], zl, scheme, f"{sc}.gate"))
         * cm.dense(p["b_proj"], zl, scheme, f"{sc}.post_ln"))
    a = scheme.act(a, f"{sc}.ab")                           # Group C
    b = scheme.act(b, f"{sc}.ab")
    if mask is not None:
        # zero padded pair rows so the k-contraction only adds exact zeros
        pm = _pair_mask(mask, shard).to(a.dtype)
        a = a * pm
        b = b * pm
    if shard is not None and outgoing:
        a = shard.row_strip(a)                  # rows I, every k
        b = shard.swap_rows(b)                  # rows J, every k
    elif shard is not None:
        a = shard.swap_cols(a)                  # every k, columns I
        b = shard.col_strip(b)                  # every k, columns J
    eq = "bikc,bjkc->bijc" if outgoing else "bkic,bkjc->bijc"
    x = per_row(lambda a, b: torch.einsum(eq, a.float(), b.float()), a, b).to(z.dtype)
    x = scheme.act(x, f"{sc}.prod_pre_ln")                  # Group A (large)
    xl = cm.layernorm(p["ln_out"], x)
    xl = scheme.act(xl, f"{sc}.post_ln")                    # Group B
    g = torch.sigmoid(cm.dense(p["out_gate"], zl, scheme, f"{sc}.gate"))
    out = g * cm.dense(p["out"], xl, scheme, f"{sc}.post_ln")
    return scheme.act(out, f"{sc}.out")                     # Group C


def tri_attn_apply(p, z, scheme: QuantScheme, starting: bool, sc: str,
                   heads: int, mask=None, shard=None):
    """Triangular attention; ending-node = starting-node on transposed pair.

    It runs on rows: (B, R, N, Hz) with R = N, or under ``shard`` the
    rank's fine rows (starting) or the transposed block's fine columns
    (ending), R = N/(DM), fetched by an all-to-all (none for the ending
    node on one row strip).  Where N/(DM) is not whole (a grid larger than
    N/D, as the multi-pod mesh at N = 256), it runs on the block itself:
    the block's positions are the queries, keys and values are gathered
    over the block's rows (starting) or columns (ending), and the bias to
    the queries' rows (``shard.swap_rows``/``swap_cols``)."""
    blocks = shard is not None and (z.shape[1] * shard.d) % shard.size != 0
    if not starting:
        z = z.transpose(1, 2)
        if shard is not None and not blocks:
            z = shard.to_fine_cols(z)
    elif shard is not None and not blocks:
        z = shard.to_fine_rows(z)
    z = scheme.act(z, f"{sc}.pre_ln")                       # Group A
    zl = cm.layernorm(p["ln"], z)
    zl = scheme.act(zl, f"{sc}.post_ln")                    # Group B
    b_, r, nq, hz = zl.shape
    dh = hz // heads
    qkv = cm.dense(p["qkv"], zl, scheme, f"{sc}.qkv_in")
    q, k, v = torch.split(qkv, hz, dim=-1)
    bias = cm.dense(p["bias"], zl, scheme, f"{sc}.post_ln")  # (B,R,Nq,H)
    if blocks:
        # every key of the block's rows; the bias rows of its queries
        k, v = (shard.row_strip(t) if starting else shard.row_strip_t(t) for t in (k, v))
        bias = (shard.swap_rows(bias) if starting
                else shard.swap_cols(bias.transpose(1, 2)).transpose(1, 2))
    elif shard is not None:
        bias = (shard.fine_rows_whole(bias) if starting
                else shard.fine_cols_whole(bias))            # (B,N,N,H)
    n = k.shape[2]
    q = q.reshape(b_, r, nq, heads, dh)
    k = k.reshape(b_, r, n, heads, dh)
    v = v.reshape(b_, r, n, heads, dh)
    if mask is not None:
        # padded keys: zero v so that 0 * garbage never becomes NaN
        v = v * mask[:, None, :, None, None].to(v.dtype)
    # starting node: logits[b,h,i,j,k] = q_ij . k_ik + bias_jk
    if n >= CHUNKED_ATTN_LEN or dispatch.attention_is_kernel(z.device):
        # token-wise MHA: rows are batch; the (B,H,N,N) bias is broadcast
        # by block over the B*N protein-major rows (a strided view, never
        # repeated).  Padding is a contiguous suffix, so the key mask folds
        # into kv_valid_len.
        kv_valid = None
        if mask is not None:
            lens = mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)   # (B,)
            kv_valid = rows_valid_len(lens, r)                            # (B*r,)
        o = dispatch.attention(q.reshape(b_ * r, nq, heads, dh),
                               k.reshape(b_ * r, n, heads, dh),
                               v.reshape(b_ * r, n, heads, dh),
                               bias=bias.permute(0, 3, 1, 2),
                               kv_valid_len=kv_valid,
                               causal=False, q_chunk=512)
        o = o.reshape(b_, r, nq, heads, dh).to(z.dtype)
    else:
        logits = per_row(lambda q, k: torch.einsum("bijhd,bikhd->bhijk", q.float(), k.float()),
                         q, k) / torch.sqrt(torch.tensor(float(dh)))
        logits = logits + bias.permute(0, 3, 1, 2)[:, :, None].float()
        if mask is not None:
            logits = logits + cm.key_padding_bias(mask)[:, None, None, None, :]
        probs = torch.softmax(logits, dim=-1).to(z.dtype)
        probs = scheme.act(probs, f"{sc}.probs")            # Group C
        o = per_row(lambda p, v: torch.einsum("bhijk,bikhd->bijhd", p.float(), v.float()),
                    probs, v).to(z.dtype)
    o = scheme.act(o.reshape(b_, r, nq, hz), f"{sc}.av")    # Group C
    g = torch.sigmoid(cm.dense(p["gate"], zl, scheme, f"{sc}.gate"))
    out = cm.dense(p["out"], g * o, scheme, f"{sc}.proj_in")
    if not starting:
        if shard is not None and not blocks:
            out = shard.from_fine_cols(out)
        out = out.transpose(1, 2)
    elif shard is not None and not blocks:
        out = shard.from_fine_rows(out)
    return out


def pair_transition_apply(p, z, scheme: QuantScheme, sc: str = "pair_trans"):
    z = scheme.act(z, f"{sc}.pre_ln")                       # Group A
    zl = cm.layernorm(p["ln"], z)
    zl = scheme.act(zl, f"{sc}.post_ln")                    # Group B
    h = torch.relu(cm.dense(p["up"], zl, scheme, f"{sc}.post_ln"))
    h = scheme.act(h, f"{sc}.proj_in")                      # Group C
    return cm.dense(p["down"], h, scheme, f"{sc}.proj_in")


# --------------------------------------------------------------------------
# sequence ops (not quantized — the paper quantizes only the pair dataflow)
# --------------------------------------------------------------------------
def seq_attn_apply(p, s, z, heads: int, mask=None, pair_bias=None,
                   shard=None):
    """``pair_bias`` lets the chunked path supply a pre-built (B,N,N,H)
    bias table (``chunking.seq_pair_bias_chunked``); without it the bias is
    projected here, on ``shard``'s block and then gathered to the rank's
    rows over every column.  Under ``shard`` ``s`` is the rank's rows
    (every row on one row strip): they are the queries, and the keys and
    values are gathered over the rows."""
    b_, n, hm = s.shape
    dh = hm // heads
    sl = cm.layernorm(p["ln"], s)
    qkv = cm.dense(p["qkv"], sl)
    q, k, v = torch.split(qkv, hm, dim=-1)
    if shard is not None:
        k, v = shard.seq_whole(k), shard.seq_whole(v)
    q = q.reshape(b_, n, heads, dh)
    k = k.reshape(b_, -1, heads, dh)
    v = v.reshape(b_, -1, heads, dh)
    if mask is not None:
        v = v * mask[:, :, None, None].to(v.dtype)
    bias = pair_bias
    if bias is None:
        bias = cm.dense(p["pair_bias"], cm.layernorm(p["pair_bias_ln"], z))
        if shard is not None:
            bias = shard.row_strip(bias)
    bias = bias.permute(0, 3, 1, 2).to(torch.float32, copy=True)   # (B,H,N,N)
    if mask is not None:
        # additive key-padding fold: real keys get literal +0.0; in place,
        # so that one (B,H,N,N) float32 table exists, not two
        bias.add_(cm.key_padding_bias(mask)[:, None, None, :])
    o = dispatch.attention(q, k, v, bias=bias)
    o = o.reshape(b_, n, hm).to(s.dtype)
    g = torch.sigmoid(cm.dense(p["gate"], sl))
    return cm.dense(p["out"], g * o)


def seq_transition_apply(p, s):
    return cm.dense(p["down"], torch.relu(cm.dense(p["up"], cm.layernorm(p["ln"], s))))


def opm_apply(p, s, shard=None):
    sl = cm.layernorm(p["ln"], s)
    a, b = cm.dense(p["a"], sl), cm.dense(p["b"], sl)       # (B,N,32)
    if shard is not None:
        b = shard.seq_cols(b)                               # rows J of s
    outer = torch.einsum("bic,bjd->bijcd", a.float(), b.float()).to(s.dtype)
    return cm.dense(p["out"], outer.reshape(*outer.shape[:3], -1))


# --------------------------------------------------------------------------
# one folding block
# --------------------------------------------------------------------------
def block_apply(p, s, z, cfg: PPMConfig, scheme: QuantScheme, mask=None,
                shard=None):
    s = s + seq_attn_apply(p["seq_attn"], s, z, cfg.seq_heads, mask=mask,
                           shard=shard)
    s = s + seq_transition_apply(p["seq_trans"], s)
    z = z + opm_apply(p["opm"], s, shard=shard)
    z = z + tri_mul_apply(p["tri_mul_out"], z, scheme, True, "tri_mul_out",
                          mask=mask, shard=shard)
    z = z + tri_mul_apply(p["tri_mul_in"], z, scheme, False, "tri_mul_in",
                          mask=mask, shard=shard)
    z = z + tri_attn_apply(p["tri_attn_start"], z, scheme, True,
                           "tri_attn_start", cfg.pair_heads, mask=mask,
                           shard=shard)
    z = z + tri_attn_apply(p["tri_attn_end"], z, scheme, False,
                           "tri_attn_end", cfg.pair_heads, mask=mask,
                           shard=shard)
    z = z + pair_transition_apply(p["pair_trans"], z, scheme)
    return s, z


def trunk_apply(blocks: list[cm.Params], s, z, cfg: PPMConfig,
                scheme: QuantScheme, mask=None, chunk_size: int | None = None,
                shard=None):
    """``chunk_size`` routes every block through the row-chunked pair stack
    (``repro_torch.models.ppm.chunking``): same ops, same sites, O(N·chunk)
    slabs instead of O(N²), each op's slabs added into ``z`` in place, so
    the chunked path consumes ``z``: the caller hands over a tensor it owns
    (``ppm_forward`` does).  None/0 is the unchunked path, which never
    writes ``z``.  ``shard`` (a ``PairShard`` or a ``PairGrid``, chunked or
    not): ``z`` is this rank's part (module docstring), pinned at every
    block boundary (``constrain``), and so is ``s``.  A grid whose
    parameters ``sharding.grid_params`` cut (``shard.specs``) gathers one
    block's weights at its use and drops them after it."""
    specs = None if shard is None else shard.specs
    if chunk_size:
        from repro_torch.models.ppm import chunking as ck   # imports this module
    for i, p in enumerate(blocks):
        if specs is not None:
            p = shard.whole_params(p, specs["trunk"][i])
        if chunk_size:
            s, z = ck.block_apply_chunked(p, s, z, cfg, scheme, chunk_size,
                                          mask=mask, shard=shard)
        else:
            s, z = block_apply(p, s, z, cfg, scheme, mask=mask, shard=shard)
        p = None            # a gathered block's weights go before the next gather
        s = sh.constrain(s, "seq_track")
        z = sh.constrain(z, "pair")
    return s, z
