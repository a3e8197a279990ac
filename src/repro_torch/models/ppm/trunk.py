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

Every op takes ``shard`` (``repro_torch.parallel.sharding.PairShard``):
the pair tensor then holds this rank's columns j0:j1 of z, (B, N, N/W,
Hz), with ``s`` replicated, and each op fetches what its contraction
needs from the model group (the reference's GSPMD partitioning of the
same ops, made explicit):

  * pair transition, the OPM update and every AAQ site: nothing (AAQ is
    token-wise, so each pair position is local; OPM's ``s`` is whole);
  * tri-mul incoming (x_ij = sum_k a_ki b_kj): ``a`` gathered, ``b`` local;
  * tri-mul outgoing (x_ij = sum_k a_ik b_jk): ``a`` gathered and ``b``'s
    rows j0:j1 over every k (an all-to-all);
  * tri-attention, ending node (attends over i at a fixed j): local, with
    its (B, N, N, heads) bias gathered; starting node (attends over k along
    row i): an all-to-all to a row shard and back, the bias gathered;
  * sequence attention's pair bias: projected on the shard, then gathered.

A gather concatenates and changes no sum, so with ``shard`` of one rank
the ops compute what the unsharded ops do.
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
    (columns j0:j1 only under ``shard``)."""
    cols = mask if shard is None else mask[:, shard.cols(mask.shape[1])]
    return (mask[:, :, None] & cols[:, None, :])[..., None]


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
    if shard is not None:
        a = shard.gather(a, 2)                  # every k (outgoing) / i (incoming)
        if outgoing:
            b = shard.cols_to_rows(b)           # rows j0:j1, every k
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

    It runs on rows: (B, R, N, Hz) with R = N, or under ``shard`` R = N/W
    (the ending node's transposed column shard, the starting node's row
    shard fetched by an all-to-all)."""
    if not starting:
        z = z.transpose(1, 2)
    elif shard is not None:
        z = shard.cols_to_rows(z)
    z = scheme.act(z, f"{sc}.pre_ln")                       # Group A
    zl = cm.layernorm(p["ln"], z)
    zl = scheme.act(zl, f"{sc}.post_ln")                    # Group B
    b_, r, n, hz = zl.shape
    dh = hz // heads
    qkv = cm.dense(p["qkv"], zl, scheme, f"{sc}.qkv_in")
    q, k, v = torch.split(qkv, hz, dim=-1)
    q = q.reshape(b_, r, n, heads, dh)
    k = k.reshape(b_, r, n, heads, dh)
    v = v.reshape(b_, r, n, heads, dh)
    if mask is not None:
        # padded keys: zero v so that 0 * garbage never becomes NaN
        v = v * mask[:, None, :, None, None].to(v.dtype)
    bias = cm.dense(p["bias"], zl, scheme, f"{sc}.post_ln")  # (B,R,N,H)
    if shard is not None:
        bias = shard.gather(bias, 1)                         # (B,N,N,H)
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
        o = dispatch.attention(q.reshape(b_ * r, n, heads, dh),
                               k.reshape(b_ * r, n, heads, dh),
                               v.reshape(b_ * r, n, heads, dh),
                               bias=bias.permute(0, 3, 1, 2),
                               kv_valid_len=kv_valid,
                               causal=False, q_chunk=512)
        o = o.reshape(b_, r, n, heads, dh).to(z.dtype)
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
    o = scheme.act(o.reshape(b_, r, n, hz), f"{sc}.av")     # Group C
    g = torch.sigmoid(cm.dense(p["gate"], zl, scheme, f"{sc}.gate"))
    out = cm.dense(p["out"], g * o, scheme, f"{sc}.proj_in")
    if not starting:
        out = out.transpose(1, 2)
    elif shard is not None:
        out = shard.rows_to_cols(out)
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
    projected here, on ``shard``'s columns and then gathered."""
    b_, n, hm = s.shape
    dh = hm // heads
    sl = cm.layernorm(p["ln"], s)
    qkv = cm.dense(p["qkv"], sl)
    q, k, v = torch.split(qkv, hm, dim=-1)
    q = q.reshape(b_, n, heads, dh)
    k = k.reshape(b_, n, heads, dh)
    v = v.reshape(b_, n, heads, dh)
    if mask is not None:
        v = v * mask[:, :, None, None].to(v.dtype)
    bias = pair_bias
    if bias is None:
        bias = cm.dense(p["pair_bias"], cm.layernorm(p["pair_bias_ln"], z))
        if shard is not None:
            bias = shard.gather(bias, 2)
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
        b = b[:, shard.cols(b.shape[1])]                    # columns j0:j1
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
    writes ``z``.  ``shard``: ``z`` is this rank's column shard (module
    docstring), pinned at every block boundary (``constrain``)."""
    if chunk_size:
        from repro_torch.models.ppm import chunking as ck   # imports this module
        for p in blocks:
            s, z = ck.block_apply_chunked(p, s, z, cfg, scheme, chunk_size,
                                          mask=mask, shard=shard)
            z = sh.constrain(z, "pair")
        return s, z
    for p in blocks:
        s, z = block_apply(p, s, z, cfg, scheme, mask=mask, shard=shard)
        z = sh.constrain(z, "pair")
    return s, z
