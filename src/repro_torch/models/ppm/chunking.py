"""Row-chunked pair-stack execution: the model half of the long-fold tier
(port of ``repro/models/ppm/chunking.py``).

Every pair-stack op (``tri_mul_apply``, ``tri_attn_apply``,
``pair_transition_apply``, the OPM update and seq attention's pair-bias
projection) runs as a loop over row slabs of the pair tensor's i axis: one
(B, chunk, N, H) slab is in flight at a time, so the per-op working set
drops from O(N²·H) to O(N·chunk·H) plus a few *resident* full-width
tensors (the residual stream, tri-mul's partner operand, the attention-bias
tables) that the serving-side planner prices (``repro_torch.serving.longfold``).

Numerical contract (``tests/test_torch_chunking.py``):

  * FP schemes: chunked output is allclose(1e-4) to unchunked.  Every op is
    row-local (layernorm/dense/gating reduce over channels, the
    k-contractions keep their extent and order, the token-wise attention
    path issues the same per-row calls with the same block-broadcast bias),
    so only a matmul's blocking on a smaller row count can move a last bit.
  * AAQ: ``AAQScheme.act`` quantizes per token over channels, so a slab
    quantizes as its slice of the full tensor; parity is TM-gated (≥ 0.995).
  * The five comparison schemes (tensor-, channel- or all-token-wide
    statistics) are NOT chunk-exact: a slab's scales see the slab, not the
    tensor.  Incoming tri-mul slabs by columns with ``a`` resident where
    the reference slabs by rows with ``b`` resident, so its slabs see other
    statistics than the reference's; under FP and AAQ every value is per
    position and the slabbing moves nothing.  The difference is bounded:
    ``test_comparison_schemes_chunked_match_jax_chunked`` holds the port's
    chunked fold to the reference's chunked fold at TM >= 0.995 under each
    of the five (N = 64, slabs of 16).  The planner prices the resident
    operand as the reference does; which operand it is does not change
    its size.

The reference scans slabs with ``jax.lax.map``; here the scan is a Python
loop writing each slab's result into one preallocated output, so a CUDA
graph captured over a chunked forward holds (N / chunk) slabs of every op.
Inside a block (``block_apply_chunked``) each pair op adds its slabs into
the residual ``z`` in place (``into=``) once its full-width resident
tensors are built: from then on a slab reads and writes only its own rows
(its own columns for tri-mul's incoming and tri-attention's ending
variants), and the in-place add rounds as ``z + out`` does.  So no op's
full-size output coexists with ``z``, as XLA's buffer reuse arranges for
the reference; what stays is what the planner prices (the residual, one
resident operand, the bias tables, one slab).
The slab views handed to the kernels keep the flash wrapper's 16-byte base
and stride rule (a slab of a contiguous (B, N, N, H) tensor is a view whose
strides are the full tensor's); the quantize ops copy a non-contiguous slab
to a contiguous (T, H) matrix themselves (``aaq_quant/ops.py``).

Chunked and sharded together (``shard``, ``trunk.py``'s docstring): z is
the rank's block z[:, I, J] (a ``PairGrid``: rows I over the data axes,
columns J over ``model``; a ``PairShard`` is the grid of one row strip,
I every row) and the slabs cut that block, as the reference's module
docstring has it, so a chunked bucket keeps its chunk and gains the
shard.  What the single path streams slab by slab is fetched slab by
slab: outgoing tri-mul gathers each slab's ``a`` over k and keeps
``b[J, :]`` resident, incoming gathers each column slab's ``b`` over k and
keeps ``a[:, I]`` resident, each resident built slab by slab from the
ranks that hold it (``swap_rows_slab``/``swap_cols_slab``); triangular
attention's slabs of the rank's fine rows travel to it and back by the
all-to-all, a slab at a time.  Above its own block a rank then holds
what the chunked single path holds, cut: one resident tri-mul operand
(1/M or 1/D of the single path's), the bias tables, one slab.  Every slab
count follows from N, the grid and the chunk alone, so every rank issues
the same collectives in the same order; a 1 x 1 grid slabs as one device
does and moves nothing, so its fold is the single chunked fold, bitwise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.schemes import QuantScheme
from repro_torch.device import per_row
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.models.ppm import trunk as tk


def effective_chunk_size(n: int, chunk: int) -> int:
    """Largest divisor of ``n`` that is <= ``chunk``.

    Chunks tile the row axis exactly (no ragged tail slab, whose shape
    would differ per remainder).  Serving buckets are powers of two, so a
    power-of-two request degrades gracefully; ``n`` prime degrades to 1.
    """
    c = max(1, min(int(chunk), int(n)))
    while n % c:
        c -= 1
    return c


def _scan_rows(fn, slabs, n: int, chunk: int, into=None) -> torch.Tensor:
    """Map ``fn`` over row-chunks of a tuple of tensors.

    Every tensor of ``slabs`` has the row axis at position 1 (length
    ``n``); ``fn`` receives the tuple with that axis length ``chunk`` and
    returns one (B, chunk, ...) tensor.  The results are written into one
    (B, n, ...) output, or, with ``into``, added into ``into``'s rows in
    place (``into`` is returned): ``fn`` must then read no row of ``into``
    that an earlier slab wrote.  One slab covering all ``n`` rows is
    ``fn``'s own result, uncopied: the unchunked form.
    """
    if into is None and chunk == n:
        return fn(tuple(slabs))
    out = into
    for i in range(n // chunk):
        rows = slice(i * chunk, (i + 1) * chunk)
        y = fn(tuple(x[:, rows] for x in slabs))
        if into is not None:
            into[:, rows].add_(y)
            continue
        if out is None:
            out = y.new_empty((y.shape[0], n, *y.shape[2:]))
        out[:, rows] = y
    return out


def scan_row_slabs(fn, slabs, chunk: int | None) -> torch.Tensor:
    """``_scan_rows`` at ``chunk``'s effective size: a row-local stage
    outside the trunk (the input embedding, the structure module's pair
    bias, the distogram head).  ``chunk`` None/0 is one slab of every row,
    which is the unchunked expression itself."""
    n = slabs[0].shape[1]
    return _scan_rows(fn, slabs, n, effective_chunk_size(n, chunk or n))


def _pair_ln(p, z_rows, scheme: QuantScheme, sc: str, key: str):
    """pre_ln -> layernorm -> post_ln on a row slab, same sites as unchunked."""
    z_rows = scheme.act(z_rows, f"{sc}.pre_ln")             # Group A
    zl = cm.layernorm(p[key], z_rows)
    return scheme.act(zl, f"{sc}.post_ln")                  # Group B


# --------------------------------------------------------------------------
# triangular multiplication
# --------------------------------------------------------------------------
def _tri_mul_ab(p, z_rows, scheme: QuantScheme, sc: str, proj: str, gate: str,
                row_mask=None, col_mask=None):
    """The a/b operand of tri-mul for one row slab; returns (ab, zl).
    ``row_mask``/``col_mask`` are the (B, rows)/(B, cols) token masks of
    the slab's two axes (None: unmasked)."""
    zl = _pair_ln(p, z_rows, scheme, sc, "ln_in")
    ab = (torch.sigmoid(cm.dense(p[gate], zl, scheme, f"{sc}.gate"))
          * cm.dense(p[proj], zl, scheme, f"{sc}.post_ln"))
    ab = scheme.act(ab, f"{sc}.ab")                         # Group C
    if col_mask is not None:
        pm = (row_mask[:, :, None] & col_mask[:, None, :])[..., None]
        ab = ab * pm.to(ab.dtype)
    return ab, zl


def _seg_view(x, segs: int, s: int, c: int, dim: int = 1):
    """Rows s*c:(s+1)*c of each of ``segs`` equal segments of ``x``'s axis
    ``dim``: a view, that axis as (segs, c)."""
    return x.unflatten(dim, (segs, x.shape[dim] // segs)).narrow(dim + 1, s * c, c)


def _rank_rows(x, segs: int, s: int, c: int, dim: int = 1):
    """``_seg_view`` with its two axes as one, (segs * c) rows in order
    (segment 0's first): slab ``s`` of the rows each rank of a row shard
    owns, in all-to-all order."""
    return _seg_view(x, segs, s, c, dim).flatten(dim, dim + 1)


def _pair_n(z, shard) -> int:
    """The pair length of ``z``, the rank's block under ``shard``."""
    return z.shape[1] * (1 if shard is None else shard.d)


def _masks(mask, shard, n: int):
    """(the block's row mask, its column mask) of the (B, N) token mask."""
    if mask is None or shard is None:
        return mask, mask
    return mask[:, shard.rows(n)], mask[:, shard.cols(n)]


def tri_mul_chunked(p, z, scheme: QuantScheme, outgoing: bool, sc: str,
                    chunk: int, mask=None, into=None, shard=None):
    """Row-chunked triangular multiplication.

    One operand of the k-contraction is full-width and resident: the price
    of chunking tri-mul, which the admission controller's chunked estimator
    prices at the scheme's ``{sc}.ab`` bits, as the reference's does.  It is
    built slab by slab (the hz-wide layernorm intermediate never
    materializes at O(N²)) in the config's dtype, as the reference keeps
    it, and in the layout of the per-slab products, which multiply in that
    dtype with float32 accumulation.

    Outgoing, x[b,i,j,c] = sum_k a[b,i,k,c] * b[b,j,k,c]: the slabs are rows
    i of z and ``b`` is resident, as in the reference.  Incoming, x[b,i,j,c]
    = sum_k a[b,k,i,c] * b[b,k,j,c]: the slabs are columns j of z (rows of
    its transpose) and ``a`` is resident, so that each slab reads and writes
    only its own columns and ``into`` can take the slabs in place.  Every
    operand value is computed per pair position, so both give the
    reference's values; only the summation order of the products can move.

    Under ``shard`` (z the rank's block z[I, J], (B, N/D, N/M, H); one row
    strip for a ``PairShard``): outgoing keeps ``b[J, :]`` resident, (B,
    th, N/M, N), built in steps in which each rank computes the same slab of
    every segment of its rows (``swap_rows_slab``: the segments cut at
    every strip's bounds, so every rank computes and receives at every
    step), and gathers each slab's ``a`` over k (``row_strip``); incoming
    keeps ``a[:, I]`` resident, (B, th, N, N/D), each rank computing a slab
    of its rows at a step (``swap_cols_slab``), and gathers each column
    slab's ``b`` over k (``row_strip_t``).
    """
    n = _pair_n(z, shard)
    row_mask, col_mask = _masks(mask, shard, n)
    d, m = (1, 1) if shard is None else (shard.d, shard.m)
    slab_proj, slab_gate = ("a_proj", "a_gate") if outgoing else ("b_proj", "b_gate")
    part = None
    if outgoing:
        # part[b, c, j, k] = b[b, j, k, c] for the rank's rows j of J, in
        # steps t of slab t of each segment (the rows cut at every strip's
        # bounds): ``have`` segments of the rank's rows, ``want`` of J's
        k = math.lcm(d, m)
        seg = n // k
        c = effective_chunk_size(seg, chunk)
        have, want = k // d, k // m
        for t in range(seg // c):
            rm = None if mask is None else _rank_rows(row_mask, have, t, c)
            rr, _ = _tri_mul_ab(p, _rank_rows(z, have, t, c), scheme, sc, "b_proj", "b_gate",
                                row_mask=rm, col_mask=col_mask)
            if shard is not None:
                rr = shard.swap_rows_slab(rr, n, t, c)
            if part is None:
                part = torch.empty((rr.shape[0], rr.shape[-1], z.shape[2], n),
                                   dtype=rr.dtype, device=rr.device)
            _seg_view(part, want, t, c, dim=2).copy_(
                rr.permute(0, 3, 1, 2).unflatten(2, (want, c)))
    else:
        # part[b, c, k, i] = a[b, k, i, c] for the rank's columns i of I
        c = effective_chunk_size(z.shape[1], chunk)
        for s in range(z.shape[1] // c):
            rows_s = slice(s * c, (s + 1) * c)
            rr, _ = _tri_mul_ab(p, z[:, rows_s], scheme, sc, "a_proj", "a_gate",
                                row_mask=None if mask is None else row_mask[:, rows_s],
                                col_mask=col_mask)
            if shard is not None:
                rr = shard.swap_cols_slab(rr, n, s, c)
            if part is None:
                part = torch.empty((rr.shape[0], rr.shape[-1], n, rr.shape[2]),
                                   dtype=rr.dtype, device=rr.device)
            _seg_view(part, d, s, c, dim=2).copy_(rr.permute(0, 3, 1, 2).unflatten(2, (d, c)))

    def rows(slab):
        zc = slab[0]
        mc = slab[-1] if mask is not None else None
        # outgoing: a of rows i; incoming: b of columns j, in the transposed
        # (j, k) layout, and the output gate's zl of the same positions
        xc, zl = _tri_mul_ab(p, zc, scheme, sc, slab_proj, slab_gate,
                             row_mask=mc, col_mask=col_mask if outgoing else row_mask)
        if shard is not None:                               # over every k
            xc = shard.row_strip(xc) if outgoing else shard.row_strip_t(xc)
        if outgoing:
            # (B,th,C,k) @ (B,th,k,J): x of rows i, (B,th,C,J)
            x = per_row(torch.matmul, xc.permute(0, 3, 1, 2), part.transpose(-1, -2))
            x = x.permute(0, 2, 3, 1)
        else:
            # (B,th,I,k) @ (B,th,k,C): x of columns j, (B,th,I,C), laid out
            # as the slab's transposed rows (B,C,I,th)
            x = per_row(torch.matmul, part.transpose(-1, -2), xc.permute(0, 3, 2, 1))
            x = x.permute(0, 3, 2, 1)
        x = x.to(zc.dtype)
        x = scheme.act(x, f"{sc}.prod_pre_ln")              # Group A (large)
        xl = cm.layernorm(p["ln_out"], x)
        xl = scheme.act(xl, f"{sc}.post_ln")                # Group B
        g = torch.sigmoid(cm.dense(p["out_gate"], zl, scheme, f"{sc}.gate"))
        out = g * cm.dense(p["out"], xl, scheme, f"{sc}.post_ln")
        return scheme.act(out, f"{sc}.out")                 # Group C

    zs = z if outgoing else z.transpose(1, 2)
    if into is not None and not outgoing:
        into = into.transpose(1, 2)
    ms = row_mask if outgoing else col_mask
    rows_n = zs.shape[1]
    out = _scan_rows(rows, (zs,) if mask is None else (zs, ms), rows_n,
                     effective_chunk_size(rows_n, chunk), into=into)
    return out if outgoing else out.transpose(1, 2)


# --------------------------------------------------------------------------
# triangular attention
# --------------------------------------------------------------------------
def tri_attn_chunked(p, z, scheme: QuantScheme, starting: bool, sc: str,
                     heads: int, chunk: int, mask=None, into=None, shard=None):
    """Row-chunked triangular attention.

    The (B,N,N,heads) bias table is full-width and resident (heads is
    small); each row chunk then issues the call the unchunked op would: the
    token-wise path flattens (B·chunk) rows through ``dispatch.attention``
    with the (B,heads,N,N) bias broadcast by block (bias row = b // chunk),
    and the einsum path keeps the explicit softmax and its ``{sc}.probs``
    site.  The route is chosen from the FULL n, never the chunk: chunking
    must not change which kernel (and which AAQ sites) a bucket runs.
    With ``into`` the slabs go into it in place once the bias table is
    built (a row of attention reads only its own row of z).

    Under ``shard`` (z the rank's block; one row strip for a ``PairShard``)
    the bias table is built on the block and gathered whole.  The
    attention runs on the rank's fine rows, as the unsharded op does: the
    starting node's N/(DM) rows of I with every column, the ending node's
    N/(DM) columns of J with every row.  A slab is the same rows of every
    fine-row shard of the strip, fetched by the all-to-all
    (``to_fine_rows``/``to_fine_cols``) and sent back by its inverse into
    ``z``.  Where N/(DM) is not whole, the block's own positions are the
    queries, slab by slab of its rows (columns for the ending node), the
    keys gathered over the strip and the bias to the queries' rows
    (``swap_rows``/``swap_cols``), as ``trunk.tri_attn_apply`` does.
    """
    n = _pair_n(z, shard)
    blocks = shard is not None and n % shard.size != 0
    if not starting:
        z = z.transpose(1, 2)
        into = None if into is None else into.transpose(1, 2)
    b_, hz = z.shape[0], z.shape[-1]
    dh = hz // heads

    def bias_rows(slab):
        zl = _pair_ln(p, slab[0], scheme, sc, "ln")
        return cm.dense(p["bias"], zl, scheme, f"{sc}.post_ln")

    bias = _scan_rows(bias_rows, (z,), z.shape[1],
                      effective_chunk_size(z.shape[1], chunk))
    segs, there, back, keys = 1, None, None, None
    if blocks:                                  # the queries' rows, every key
        bias = (shard.swap_rows(bias) if starting
                else shard.swap_cols(bias.transpose(1, 2)).transpose(1, 2))
        keys = shard.row_strip if starting else shard.row_strip_t
    elif shard is not None:                     # (B,N,N,H) on every rank
        bias = shard.whole(bias) if starting else shard.whole_t(bias)
        segs = shard.m if starting else shard.d
        there = shard.to_fine_rows if starting else shard.to_fine_cols
        back = shard.from_fine_rows if starting else shard.from_fine_cols
    bias_t = bias.permute(0, 3, 1, 2)                       # (B,H,Nq,N)
    r = z.shape[1] // segs                      # the rows a rank attends over
    c = effective_chunk_size(r, chunk)

    tokenwise = n >= tk.CHUNKED_ATTN_LEN or dispatch.attention_is_kernel(z.device)
    kv_valid = None
    if mask is not None and tokenwise:
        lens = mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)   # (B,)
        kv_valid = tk.rows_valid_len(lens, c)                            # (B*c,)

    def rows(zc):                                           # (B,C,Nq,hz)
        if there is not None:
            zc = there(zc)                      # this rank's slab over every column
        zl = _pair_ln(p, zc, scheme, sc, "ln")
        qkv = cm.dense(p["qkv"], zl, scheme, f"{sc}.qkv_in")
        q, k, v = torch.split(qkv, hz, dim=-1)
        if keys is not None:
            k, v = keys(k), keys(v)
        nq, nk = q.shape[2], k.shape[2]
        q = q.reshape(b_, c, nq, heads, dh)
        k = k.reshape(b_, c, nk, heads, dh)
        v = v.reshape(b_, c, nk, heads, dh)
        if mask is not None:
            v = v * mask[:, None, :, None, None].to(v.dtype)
        if tokenwise:
            o = dispatch.attention(q.reshape(b_ * c, nq, heads, dh),
                                   k.reshape(b_ * c, nk, heads, dh),
                                   v.reshape(b_ * c, nk, heads, dh),
                                   bias=bias_t, kv_valid_len=kv_valid,
                                   causal=False, q_chunk=512)
            o = o.reshape(b_, c, nq, heads, dh).to(zc.dtype)
        else:
            logits = per_row(lambda q, k: torch.einsum("bijhd,bikhd->bhijk", q.float(),
                                                       k.float()),
                             q, k) / torch.sqrt(torch.tensor(float(dh)))
            logits = logits + bias_t[:, :, None].float()
            if mask is not None:
                logits = logits + cm.key_padding_bias(mask)[:, None, None, None, :]
            probs = torch.softmax(logits, dim=-1).to(zc.dtype)
            probs = scheme.act(probs, f"{sc}.probs")        # Group C
            o = per_row(lambda p, v: torch.einsum("bhijk,bikhd->bijhd", p.float(), v.float()),
                        probs, v).to(zc.dtype)
        o = scheme.act(o.reshape(b_, c, nq, hz), f"{sc}.av")  # Group C
        g = torch.sigmoid(cm.dense(p["gate"], zl, scheme, f"{sc}.gate"))
        out = cm.dense(p["out"], g * o, scheme, f"{sc}.proj_in")
        return out if back is None else back(out)

    if segs == 1:
        out = _scan_rows(lambda slab: rows(slab[0]), (z,), r, c, into=into)
    else:
        # slab s: rows s*c:(s+1)*c of every fine-row shard, in all-to-all
        # order; its output goes back to the same rows of z
        out = into if into is not None else torch.empty_like(z)
        for s in range(r // c):
            y = rows(_rank_rows(z, segs, s, c)).unflatten(1, (segs, c))
            dst = _seg_view(out, segs, s, c)
            if into is not None:
                dst.add_(y)
            else:
                dst.copy_(y)
    if not starting:
        out = out.transpose(1, 2)
    return out


# --------------------------------------------------------------------------
# pair transition / OPM / seq-attention pair bias
# --------------------------------------------------------------------------
def pair_transition_chunked(p, z, scheme: QuantScheme, chunk: int,
                            sc: str = "pair_trans", into=None):
    """Pair transition is elementwise over (i, j): chunk rows directly."""
    n = z.shape[1]
    c = effective_chunk_size(n, chunk)
    return _scan_rows(
        lambda slab: tk.pair_transition_apply(p, slab[0], scheme, sc),
        (z,), n, c, into=into)


def opm_chunked(p, s, chunk: int, into=None, shard=None):
    """Outer-product-mean without the (B,N,N,32·32) slab: the a/b vectors
    are linear in N, only the per-chunk outer product materializes.

    The outer product is formed in ``a``'s dtype directly: a product of two
    bf16 values is exact in float32, so rounding it once to bf16 gives the
    reference's float32 einsum rounded to bf16, bit for bit, without its
    float32 slab (512 MiB a slab at N = 2,048, chunk 64, which gave the
    graph pool a segment of its own)."""
    n = s.shape[1]
    c = effective_chunk_size(n, chunk)
    sl = cm.layernorm(p["ln"], s)
    a, b = cm.dense(p["a"], sl), cm.dense(p["b"], sl)       # (B,N,32)
    if shard is not None:
        b = shard.seq_cols(b)                               # s's rows J

    def rows(slab):
        outer = slab[0][:, :, None, :, None] * b[:, None, :, None, :]
        return cm.dense(p["out"], outer.reshape(*outer.shape[:3], -1))

    return _scan_rows(rows, (a,), n, c, into=into)


def seq_pair_bias_chunked(p, z, chunk: int, shard=None):
    """Sequence attention's (B,N,N,seq_heads) pair bias, built slab by slab
    so the full hz-wide ln(z) intermediate never materializes (on
    ``shard``'s block, then gathered to its rows over every column)."""
    n = z.shape[1]
    c = effective_chunk_size(n, chunk)
    bias = _scan_rows(
        lambda slab: cm.dense(p["pair_bias"],
                              cm.layernorm(p["pair_bias_ln"], slab[0])),
        (z,), n, c)
    return bias if shard is None else shard.row_strip(bias)


# --------------------------------------------------------------------------
# one folding block, chunked
# --------------------------------------------------------------------------
def block_apply_chunked(p, s, z, cfg, scheme: QuantScheme, chunk: int,
                        mask=None, shard=None):
    """``trunk.block_apply`` with every O(N²·H) pair op row-chunked.

    Op order, residual structure and quantization sites are those of the
    unchunked block; only the materialization schedule changes.  Each pair
    op adds its slabs into ``z`` IN PLACE (the caller hands ``z`` over, as
    ``trunk_apply``'s does), which rounds as ``z + op``.
    """
    pb = seq_pair_bias_chunked(p["seq_attn"], z, chunk, shard=shard)
    s = s + tk.seq_attn_apply(p["seq_attn"], s, z, cfg.seq_heads, mask=mask,
                              pair_bias=pb, shard=shard)
    del pb
    s = s + tk.seq_transition_apply(p["seq_trans"], s)
    opm_chunked(p["opm"], s, chunk, into=z, shard=shard)
    tri_mul_chunked(p["tri_mul_out"], z, scheme, True, "tri_mul_out", chunk,
                    mask=mask, into=z, shard=shard)
    tri_mul_chunked(p["tri_mul_in"], z, scheme, False, "tri_mul_in", chunk,
                    mask=mask, into=z, shard=shard)
    tri_attn_chunked(p["tri_attn_start"], z, scheme, True, "tri_attn_start",
                     cfg.pair_heads, chunk, mask=mask, into=z, shard=shard)
    tri_attn_chunked(p["tri_attn_end"], z, scheme, False, "tri_attn_end",
                     cfg.pair_heads, chunk, mask=mask, into=z, shard=shard)
    pair_transition_chunked(p["pair_trans"], z, scheme, chunk, into=z)
    return s, z
