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
the rank's columns j0:j1 and the slabs split i inside that shard, as the
reference's module docstring has it, so a chunked bucket keeps its chunk
and gains the shard.  What the single path streams slab by slab is
fetched slab by slab: outgoing tri-mul's ``a`` is gathered a slab at a
time, its resident ``b`` (only rows j0:j1 now: 1/W of the single path's)
arrives by an all-to-all a slab at a time, incoming tri-mul's resident
``a`` is gathered a slab at a time into the one buffer, and the starting
node's rows travel to the rank that attends over them and back a slab at
a time.  Above its own shard a rank then holds what the chunked single
path holds: one resident tri-mul operand, the bias tables, one slab.
"""
from __future__ import annotations

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


def _rank_rows(x, shard, s: int, c: int):
    """Rows s*c:(s+1)*c of every rank's row shard of ``x`` (rows on axis
    1, N of them): (B, W*c, ...), rank 0's rows first.  The slab ``s`` of
    the rows each rank owns under a row shard, in all-to-all order."""
    w = 1 if shard is None else shard.size
    v = x.unflatten(1, (w, x.shape[1] // w))[:, :, s * c:(s + 1) * c]
    return v.flatten(1, 2)


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

    Under ``shard`` (z the rank's columns j0:j1): outgoing keeps only the
    rows j0:j1 of ``b`` resident, (B, th, N/W, N), each slab of them sent
    by the all-to-all from the ranks that hold its k, and gathers each
    slab's ``a`` over k; incoming gathers the resident ``a`` slab by slab
    into the one (B, th, N, N) buffer and takes its column slabs locally.
    """
    n = z.shape[1]
    col_mask = mask if mask is None or shard is None else mask[:, shard.cols(n)]
    res_proj, res_gate = ("b_proj", "b_gate") if outgoing else ("a_proj", "a_gate")
    slab_proj, slab_gate = ("a_proj", "a_gate") if outgoing else ("b_proj", "b_gate")

    # the resident operand in the products' layout: part[b, c, r, m] =
    # op[b, r, m, c], written slab by slab.  Incoming: r = the slab rows
    # of z (every rank's slab gathered over m).  Outgoing: r = rows j0:j1;
    # a slab computes those rows of every rank's row shard on the local
    # columns, and the all-to-all hands each rank its own rows over every m.
    w = 1 if shard is None else shard.size
    nr = n // w if outgoing else n            # the resident operand's rows
    c = effective_chunk_size(nr, chunk)
    part = None
    for i in range(nr // c):
        rows_i = slice(i * c, (i + 1) * c)
        if outgoing:
            zr = _rank_rows(z, shard, i, c)
            rm = None if mask is None else _rank_rows(mask, shard, i, c)
        else:
            zr, rm = z[:, rows_i], None if mask is None else mask[:, rows_i]
        rr, _ = _tri_mul_ab(p, zr, scheme, sc, res_proj, res_gate,
                            row_mask=rm, col_mask=col_mask)
        if shard is not None:
            rr = shard.cols_to_rows(rr) if outgoing else shard.gather(rr, 2)
        if part is None:
            part = torch.empty((rr.shape[0], rr.shape[-1], nr, n),
                               dtype=rr.dtype, device=rr.device)
        part[:, :, rows_i] = rr.permute(0, 3, 1, 2)

    def rows(slab):
        zc = slab[0]
        mc = slab[-1] if mask is not None else None
        # outgoing: a of rows i; incoming: b of columns j, in the transposed
        # (j, k) layout, and the output gate's zl of the same positions
        xc, zl = _tri_mul_ab(p, zc, scheme, sc, slab_proj, slab_gate,
                             row_mask=mc, col_mask=col_mask if outgoing else mask)
        if outgoing and shard is not None:
            xc = shard.gather(xc, 2)                        # a over every k
        if outgoing:
            # (B,th,C,k) @ (B,th,k,N): x of rows i, (B,th,C,N)
            x = per_row(torch.matmul, xc.permute(0, 3, 1, 2), part.transpose(-1, -2))
            x = x.permute(0, 2, 3, 1)
        else:
            # (B,th,N,k) @ (B,th,k,C): x of columns j, (B,th,N,C), laid out
            # as the slab's transposed rows (B,C,N,th)
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
    ms = col_mask if not outgoing else mask
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

    Under ``shard`` (z the rank's columns j0:j1) the bias table is built on
    the shard and gathered.  The ending node's rows are the shard's own
    columns; the starting node's rows i are split over the ranks, and each
    slab of a rank's rows arrives by an all-to-all (its row over every
    column) and its output goes back the same way into ``z``'s columns.
    """
    if not starting:
        z = z.transpose(1, 2)
        into = None if into is None else into.transpose(1, 2)
    b_, r, n, hz = z.shape                     # r rows of n positions
    exchange = starting and shard is not None
    if exchange:                                # z holds every row i, the
        r, n = r // shard.size, r               # rank attends over N/W
    c = effective_chunk_size(r, chunk)
    dh = hz // heads

    def bias_rows(slab):
        zl = _pair_ln(p, slab[0], scheme, sc, "ln")
        return cm.dense(p["bias"], zl, scheme, f"{sc}.post_ln")

    bias = _scan_rows(bias_rows, (z,), z.shape[1],
                      effective_chunk_size(z.shape[1], chunk))
    if shard is not None:                       # (B,N,N,H) on every rank
        bias = shard.gather(bias, 2 if starting else 1)
    bias_t = bias.permute(0, 3, 1, 2)                       # (B,H,N,N)

    tokenwise = n >= tk.CHUNKED_ATTN_LEN or dispatch.attention_is_kernel(z.device)
    kv_valid = None
    if mask is not None and tokenwise:
        lens = mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)   # (B,)
        kv_valid = tk.rows_valid_len(lens, c)                            # (B*c,)

    def rows(slab):
        zc = slab[0]                                        # (B,C,N,hz)
        if exchange:
            # every rank's slab s of its rows, over this rank's columns ->
            # this rank's slab over every column
            zc = shard.cols_to_rows(zc)
        zl = _pair_ln(p, zc, scheme, sc, "ln")
        qkv = cm.dense(p["qkv"], zl, scheme, f"{sc}.qkv_in")
        q, k, v = torch.split(qkv, hz, dim=-1)
        q = q.reshape(b_, c, n, heads, dh)
        k = k.reshape(b_, c, n, heads, dh)
        v = v.reshape(b_, c, n, heads, dh)
        if mask is not None:
            v = v * mask[:, None, :, None, None].to(v.dtype)
        if tokenwise:
            o = dispatch.attention(q.reshape(b_ * c, n, heads, dh),
                                   k.reshape(b_ * c, n, heads, dh),
                                   v.reshape(b_ * c, n, heads, dh),
                                   bias=bias_t, kv_valid_len=kv_valid,
                                   causal=False, q_chunk=512)
            o = o.reshape(b_, c, n, heads, dh).to(zc.dtype)
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
        o = scheme.act(o.reshape(b_, c, n, hz), f"{sc}.av")  # Group C
        g = torch.sigmoid(cm.dense(p["gate"], zl, scheme, f"{sc}.gate"))
        out = cm.dense(p["out"], g * o, scheme, f"{sc}.proj_in")
        return shard.rows_to_cols(out) if exchange else out

    if exchange:
        # slab s: rows s*c:(s+1)*c of every rank's row shard, in
        # all-to-all order; its output goes back to the same rows of z
        w = shard.size
        out = into if into is not None else torch.empty_like(z)
        for s in range(r // c):
            y = rows((_rank_rows(z, shard, s, c),)).unflatten(1, (w, c))
            dst = out.unflatten(1, (w, r))[:, :, s * c:(s + 1) * c]
            if into is not None:
                dst.add_(y)
            else:
                dst.copy_(y)
        return out
    out = _scan_rows(rows, (z,), r, c, into=into)
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
        b = b[:, shard.cols(n)]                             # columns j0:j1

    def rows(slab):
        outer = slab[0][:, :, None, :, None] * b[:, None, :, None, :]
        return cm.dense(p["out"], outer.reshape(*outer.shape[:3], -1))

    return _scan_rows(rows, (a,), n, c, into=into)


def seq_pair_bias_chunked(p, z, chunk: int, shard=None):
    """Sequence attention's (B,N,N,seq_heads) pair bias, built slab by slab
    so the full hz-wide ln(z) intermediate never materializes (on
    ``shard``'s columns, then gathered)."""
    n = z.shape[1]
    c = effective_chunk_size(n, chunk)
    bias = _scan_rows(
        lambda slab: cm.dense(p["pair_bias"],
                              cm.layernorm(p["pair_bias_ln"], slab[0])),
        (z,), n, c)
    return bias if shard is None else shard.gather(bias, 2)


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
                              pair_bias=pb)
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
