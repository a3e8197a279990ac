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

The reference scans slabs with ``jax.lax.map``; here the scan is a Python
loop writing each slab's result into one preallocated output, so a CUDA
graph captured over a chunked forward holds (N / chunk) slabs of every op.
The slab views handed to the kernels keep the flash wrapper's 16-byte base
and stride rule (a slab of a contiguous (B, N, N, H) tensor is a view whose
strides are the full tensor's); the quantize ops copy a non-contiguous slab
to a contiguous (T, H) matrix themselves (``aaq_quant/ops.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.schemes import QuantScheme
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


def _scan_rows(fn, slabs, n: int, chunk: int) -> torch.Tensor:
    """Map ``fn`` over row-chunks of a tuple of tensors.

    Every tensor of ``slabs`` has the row axis at position 1 (length
    ``n``); ``fn`` receives the tuple with that axis length ``chunk`` and
    returns one (B, chunk, ...) tensor.  The results are written into one
    (B, n, ...) output.
    """
    out = None
    for i in range(n // chunk):
        rows = slice(i * chunk, (i + 1) * chunk)
        y = fn(tuple(x[:, rows] for x in slabs))
        if out is None:
            out = y.new_empty((y.shape[0], n, *y.shape[2:]))
        out[:, rows] = y
    return out


def _pair_ln(p, z_rows, scheme: QuantScheme, sc: str, key: str):
    """pre_ln -> layernorm -> post_ln on a row slab, same sites as unchunked."""
    z_rows = scheme.act(z_rows, f"{sc}.pre_ln")             # Group A
    zl = cm.layernorm(p[key], z_rows)
    return scheme.act(zl, f"{sc}.post_ln")                  # Group B


# --------------------------------------------------------------------------
# triangular multiplication
# --------------------------------------------------------------------------
def _tri_mul_ab(p, z_rows, scheme: QuantScheme, sc: str, proj: str, gate: str,
                row_mask=None, mask=None):
    """The a/b operand of tri-mul for one row slab; returns (ab, zl)."""
    zl = _pair_ln(p, z_rows, scheme, sc, "ln_in")
    ab = (torch.sigmoid(cm.dense(p[gate], zl, scheme, f"{sc}.gate"))
          * cm.dense(p[proj], zl, scheme, f"{sc}.post_ln"))
    ab = scheme.act(ab, f"{sc}.ab")                         # Group C
    if mask is not None:
        pm = (row_mask[:, :, None] & mask[:, None, :])[..., None]
        ab = ab * pm.to(ab.dtype)
    return ab, zl


def tri_mul_chunked(p, z, scheme: QuantScheme, outgoing: bool, sc: str,
                    chunk: int, mask=None):
    """Row-chunked triangular multiplication.

    The partner operand (``b`` of the k-contraction) is full-width and
    resident: the price of chunking tri-mul.  It is built slab by slab, so
    the hz-wide layernorm intermediate never materializes at O(N²), and kept
    in float32 in the layout of the per-slab products (the reference casts
    it to float32 for every slab's product); the admission controller's
    chunked estimator prices it at the scheme's ``{sc}.ab`` bits, as the
    reference's does.
    """
    n = z.shape[1]
    c = effective_chunk_size(n, chunk)

    # the partner in the layout of the per-slab products: b_t[b, c, r, m]
    # = b[b, r, m, c] in float32, written slab by slab (r = the slab rows)
    b_t = None
    for i in range(n // c):
        rows_i = slice(i * c, (i + 1) * c)
        bb, _ = _tri_mul_ab(p, z[:, rows_i], scheme, sc, "b_proj", "b_gate",
                            row_mask=None if mask is None else mask[:, rows_i],
                            mask=mask)
        if b_t is None:
            b_t = torch.empty((bb.shape[0], bb.shape[-1], n, n),
                              dtype=torch.float32, device=bb.device)
        b_t[:, :, rows_i] = bb.permute(0, 3, 1, 2)
    # outgoing: x[b,i,j,c] = sum_k a[b,i,k,c] * b[b,j,k,c], so the product
    # takes b_t's (j, k) planes transposed; incoming: x[b,i,j,c] = sum_k
    # a[b,k,i,c] * b[b,k,j,c], b_t's (k, j) planes as they are
    b_op = b_t.transpose(-1, -2) if outgoing else b_t

    def rows(slab):
        zc = slab[0]
        mc = slab[-1] if mask is not None else None
        if outgoing:
            # a is row-local
            ac, zl = _tri_mul_ab(p, zc, scheme, sc, "a_proj", "a_gate",
                                 row_mask=mc, mask=mask)
        else:
            # the a columns for rows i come from the transposed slab (same
            # values, (i,k) layout), while the output gate reads zl of the
            # plain rows
            ac, _ = _tri_mul_ab(p, slab[1], scheme, sc, "a_proj", "a_gate",
                                row_mask=mc, mask=mask)
            zl = _pair_ln(p, zc, scheme, sc, "ln_in")
        x = torch.matmul(ac.float().permute(0, 3, 1, 2), b_op)   # (B,th,C,N)
        x = x.permute(0, 2, 3, 1).to(zc.dtype)
        x = scheme.act(x, f"{sc}.prod_pre_ln")              # Group A (large)
        xl = cm.layernorm(p["ln_out"], x)
        xl = scheme.act(xl, f"{sc}.post_ln")                # Group B
        g = torch.sigmoid(cm.dense(p["out_gate"], zl, scheme, f"{sc}.gate"))
        out = g * cm.dense(p["out"], xl, scheme, f"{sc}.post_ln")
        return scheme.act(out, f"{sc}.out")                 # Group C

    slabs = [z] if outgoing else [z, z.transpose(1, 2)]
    if mask is not None:
        slabs.append(mask)
    return _scan_rows(rows, tuple(slabs), n, c)


# --------------------------------------------------------------------------
# triangular attention
# --------------------------------------------------------------------------
def tri_attn_chunked(p, z, scheme: QuantScheme, starting: bool, sc: str,
                     heads: int, chunk: int, mask=None):
    """Row-chunked triangular attention.

    The (B,N,N,heads) bias table is full-width and resident (heads is
    small); each row chunk then issues the call the unchunked op would: the
    token-wise path flattens (B·chunk) rows through ``dispatch.attention``
    with the (B,heads,N,N) bias broadcast by block (bias row = b // chunk),
    and the einsum path keeps the explicit softmax and its ``{sc}.probs``
    site.  The route is chosen from the FULL n, never the chunk: chunking
    must not change which kernel (and which AAQ sites) a bucket runs.
    """
    if not starting:
        z = z.transpose(1, 2)
    b_, n, _, hz = z.shape
    c = effective_chunk_size(n, chunk)
    dh = hz // heads

    def bias_rows(slab):
        zl = _pair_ln(p, slab[0], scheme, sc, "ln")
        return cm.dense(p["bias"], zl, scheme, f"{sc}.post_ln")

    bias = _scan_rows(bias_rows, (z,), n, c)                # (B,N,N,H)
    bias_t = bias.permute(0, 3, 1, 2)                       # (B,H,N,N)

    tokenwise = n >= tk.CHUNKED_ATTN_LEN or dispatch.attention_is_kernel(z.device)
    kv_valid = None
    if mask is not None and tokenwise:
        lens = mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)   # (B,)
        kv_valid = tk.rows_valid_len(lens, c)                            # (B*c,)

    def rows(slab):
        zc = slab[0]                                        # (B,C,N,hz)
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
            logits = torch.einsum("bijhd,bikhd->bhijk", q.float(),
                                  k.float()) / torch.sqrt(torch.tensor(float(dh)))
            logits = logits + bias_t[:, :, None].float()
            if mask is not None:
                logits = logits + cm.key_padding_bias(mask)[:, None, None, None, :]
            probs = torch.softmax(logits, dim=-1).to(zc.dtype)
            probs = scheme.act(probs, f"{sc}.probs")        # Group C
            o = torch.einsum("bhijk,bikhd->bijhd", probs.float(),
                             v.float()).to(zc.dtype)
        o = scheme.act(o.reshape(b_, c, n, hz), f"{sc}.av")  # Group C
        g = torch.sigmoid(cm.dense(p["gate"], zl, scheme, f"{sc}.gate"))
        return cm.dense(p["out"], g * o, scheme, f"{sc}.proj_in")

    out = _scan_rows(rows, (z,), n, c)
    if not starting:
        out = out.transpose(1, 2)
    return out


# --------------------------------------------------------------------------
# pair transition / OPM / seq-attention pair bias
# --------------------------------------------------------------------------
def pair_transition_chunked(p, z, scheme: QuantScheme, chunk: int,
                            sc: str = "pair_trans"):
    """Pair transition is elementwise over (i, j): chunk rows directly."""
    n = z.shape[1]
    c = effective_chunk_size(n, chunk)
    return _scan_rows(
        lambda slab: tk.pair_transition_apply(p, slab[0], scheme, sc),
        (z,), n, c)


def opm_chunked(p, s, chunk: int):
    """Outer-product-mean without the (B,N,N,32·32) slab: the a/b vectors
    are linear in N, only the per-chunk outer product materializes."""
    n = s.shape[1]
    c = effective_chunk_size(n, chunk)
    sl = cm.layernorm(p["ln"], s)
    a, b = cm.dense(p["a"], sl), cm.dense(p["b"], sl)       # (B,N,32)

    def rows(slab):
        outer = torch.einsum("bic,bjd->bijcd", slab[0].float(),
                             b.float()).to(s.dtype)
        return cm.dense(p["out"], outer.reshape(*outer.shape[:3], -1))

    return _scan_rows(rows, (a,), n, c)


def seq_pair_bias_chunked(p, z, chunk: int):
    """Sequence attention's (B,N,N,seq_heads) pair bias, built slab by slab
    so the full hz-wide ln(z) intermediate never materializes."""
    n = z.shape[1]
    c = effective_chunk_size(n, chunk)
    return _scan_rows(
        lambda slab: cm.dense(p["pair_bias"],
                              cm.layernorm(p["pair_bias_ln"], slab[0])),
        (z,), n, c)


# --------------------------------------------------------------------------
# one folding block, chunked
# --------------------------------------------------------------------------
def block_apply_chunked(p, s, z, cfg, scheme: QuantScheme, chunk: int,
                        mask=None):
    """``trunk.block_apply`` with every O(N²·H) pair op row-chunked.

    Op order, residual structure and quantization sites are those of the
    unchunked block; only the materialization schedule changes.
    """
    pb = seq_pair_bias_chunked(p["seq_attn"], z, chunk)
    s = s + tk.seq_attn_apply(p["seq_attn"], s, z, cfg.seq_heads, mask=mask,
                              pair_bias=pb)
    s = s + tk.seq_transition_apply(p["seq_trans"], s)
    z = z + opm_chunked(p["opm"], s, chunk)
    z = z + tri_mul_chunked(p["tri_mul_out"], z, scheme, True, "tri_mul_out",
                            chunk, mask=mask)
    z = z + tri_mul_chunked(p["tri_mul_in"], z, scheme, False, "tri_mul_in",
                            chunk, mask=mask)
    z = z + tri_attn_chunked(p["tri_attn_start"], z, scheme, True,
                             "tri_attn_start", cfg.pair_heads, chunk,
                             mask=mask)
    z = z + tri_attn_chunked(p["tri_attn_end"], z, scheme, False,
                             "tri_attn_end", cfg.pair_heads, chunk, mask=mask)
    z = z + pair_transition_chunked(p["pair_trans"], z, scheme, chunk)
    return s, z
