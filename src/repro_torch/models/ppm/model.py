"""Full protein structure prediction model (port of
``repro/models/ppm/model.py``).

Input embedding -> folding trunk -> structure module, with recycling.  The
upstream protein language model is the input-embedding stub: a learned
amino-acid embedding + relative-position pair embedding.
"""
from __future__ import annotations

import torch

from repro_torch.core.schemes import FP16Baseline, QuantScheme
from repro_torch.device import resolve_device, rows_alone
from repro_torch.models import common as cm
from repro_torch.models.ppm import chunking as ck
from repro_torch.models.ppm import structure as st
from repro_torch.models.ppm import trunk as tk
from repro_torch.models.ppm.trunk import PPMConfig
from repro_torch.parallel import sharding as sh


def init_ppm(cfg: PPMConfig, seed: int = 0, *, device=None) -> cm.Params:
    """Random parameters from ``seed``, made on ``device`` (default CUDA).

    The layout is the reference's, with the trunk as one dict per block;
    the numbers are ``torch.Generator``'s, not ``jax.random``'s.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    return {
        "aa_embed": cm.embed_init(gen, cfg.vocab, cfg.hm, dt),
        "left": cm.dense_init(gen, cfg.hm, cfg.hz, dtype=dt),
        "right": cm.dense_init(gen, cfg.hm, cfg.hz, dtype=dt),
        "relpos": cm.embed_init(gen, cfg.relpos_bins, cfg.hz, dt),
        "recycle_s_ln": cm.ln_init(cfg.hm, dt, dev),
        "recycle_z_ln": cm.ln_init(cfg.hz, dt, dev),
        "trunk": tk.init_trunk(gen, cfg),
        "structure": st.init_structure(gen, cfg),
        "distogram": cm.dense_init(gen, cfg.hz, cfg.distogram_bins, bias=True, dtype=dt),
    }


def input_embedding(p, aatype: torch.Tensor, cfg: PPMConfig,
                    chunk_size: int | None = None, shard=None):
    """aatype (B,N) int -> s0 (B,N,Hm), z0 (B,N,N,Hz).

    With ``chunk_size`` the pair sum is formed by row slabs written into
    one output, so its two full-size addends never exist; each element is
    the same sum in the same order.  Without, one slab holds every row.
    Under ``shard`` z0 is made on the rank's block only, (B,N/D,N/M,Hz),
    and s0 on its rows (every row on one row strip).
    """
    s0 = cm.embed(p["aa_embed"], aatype)
    li = cm.dense(p["left"], s0)
    ri = cm.dense(p["right"], s0)
    n = aatype.shape[-1]
    pos = torch.arange(n, device=aatype.device)
    half = cfg.relpos_bins // 2
    rel = torch.clamp(pos[:, None] - pos[None, :], -half, half) + half
    if shard is not None:
        rows, cols = shard.rows(n), shard.cols(n)
        s0, li, ri, rel = s0[:, rows], li[:, rows], ri[:, cols], rel[rows, cols]
    z0 = ck.scan_row_slabs(
        lambda sl: (sl[0][:, :, None, :] + ri[:, None, :, :]
                    + cm.embed(p["relpos"], sl[1])).to(cfg.torch_dtype),
        (li, rel[None]), chunk_size)
    return s0.to(cfg.torch_dtype), z0


def distogram_head(p, z: torch.Tensor, chunk_size: int | None = None,
                   shard=None):
    """Distogram logits of the symmetrized pair tensor; with ``chunk_size``
    by row slabs (rows i of z with the matching columns for the transpose)
    written into one output.  Under ``shard`` the transpose's block is
    ``shard.swap(z)`` (on one row strip an all-to-all), and the rank's
    block of the logits is gathered to the shard's first rank (``None`` on
    the others)."""
    zt = z.transpose(1, 2) if shard is None else shard.swap(z).transpose(1, 2)
    d = ck.scan_row_slabs(lambda sl: cm.dense(p, 0.5 * (sl[0] + sl[1])),
                          (z, zt), chunk_size)
    return d if shard is None else shard.block_to_root(d)


def ppm_forward(params, aatype: torch.Tensor, cfg: PPMConfig,
                scheme: QuantScheme | None = None, *,
                mask: torch.Tensor | None = None,
                chunk_size: int | None = None, shard=None,
                distogram: bool = True):
    """Full forward pass on ``aatype``'s device.  Returns dict with coords,
    distogram, s, z.

    ``mask`` (B, N) bool marks real tokens when ``aatype`` is padded to a
    serving bucket; ``None`` is the unmasked path.  ``chunk_size`` routes
    the trunk through the row-chunked pair stack (``chunking.py``), the
    long-fold path the memory planner prices, and builds the input
    embedding, the structure module's pair bias and the distogram head by
    row slabs of the same chunk; None/0 is unchunked.

    ``shard`` runs this rank's part of the mesh-sharded forward: a
    ``repro_torch.parallel.sharding.PairShard`` splits the pair tensor on
    j over the model group (the serving tier), a ``PairGrid`` on i over
    the data axes and j over ``model`` (the reference's production layout),
    its parameters the rank's shards where ``sharding.grid_params`` cut
    them (each gathered at its use); either takes ``chunk_size`` too, the
    slabs then cutting the rank's block (``chunking.py``).  ``z`` in
    the result is the rank's part, ``s`` and coords are whole on every
    rank, the distogram on the shard's first rank only.
    ``distogram=False`` skips the head (``None`` in the result).
    """
    scheme = scheme or FP16Baseline()
    if mask is not None:
        mask = mask.to(torch.bool)
    # a float32 fold's products on the card a batch row at a time, so that
    # its rows are bitwise the same proteins folded alone (``rows_alone``)
    with sh.sharded(shard, aatype.shape[-1]), rows_alone(cfg.torch_dtype == torch.float32):
        return _forward(params, aatype, cfg, scheme, mask, chunk_size, shard,
                        distogram)


def _whole(params, shard, *keys):
    """``params`` with ``keys`` gathered whole where a grid cut them."""
    specs = None if shard is None else shard.specs
    if specs is None:
        return params
    return {**params, **{k: shard.whole_params(params[k], specs[k]) for k in keys}}


def _forward(params, aatype, cfg, scheme, mask, chunk_size, shard, distogram):
    s0, z0 = input_embedding(_whole(params, shard, "aa_embed", "left", "right", "relpos"),
                             aatype, cfg, chunk_size, shard)
    s, z = s0, z0
    for r in range(cfg.recycles):
        lns = _whole(params, shard, "recycle_s_ln", "recycle_z_ln")
        ds = cm.layernorm(lns["recycle_s_ln"], s) if r else 0.0
        dz = cm.layernorm(lns["recycle_z_ln"], z) if r else 0.0
        if r == cfg.recycles - 1:
            # the last use of s0/z0: add into them in place (the same
            # rounding as s0 + ds) and hand them over to the trunk
            s_in, z_in = s0.add_(ds), z0.add_(dz)
            s0 = z0 = None
        else:
            s_in, z_in = s0 + ds, z0 + dz
        s = z = ds = dz = None
        s, z = tk.trunk_apply(params["trunk"], s_in, z_in, cfg, scheme, mask=mask,
                              chunk_size=chunk_size, shard=shard)
        s_in = z_in = None
    if shard is not None:
        s = shard.seq_whole(s)
    coords, s_final = st.structure_apply(_whole(params, shard, "structure")["structure"], s, z,
                                         n_iter=cfg.ipa_iters, mask=mask,
                                         chunk_size=chunk_size, shard=shard)
    disto = (distogram_head(_whole(params, shard, "distogram")["distogram"], z, chunk_size,
                            shard) if distogram else None)
    return {"coords": coords, "distogram": disto, "s": s_final, "z": z}


# --------------------------------------------------------------------------
# activation inventory — drives the footprint accounting (paper Table 1)
# --------------------------------------------------------------------------
def pair_activation_inventory(cfg: PPMConfig, ns: int, batch: int = 1):
    """Every pair-dataflow activation one block stores, as (site, shape)."""
    hz, th, f = cfg.hz, cfg.tri_hidden, cfg.transition_factor
    inv: list[tuple[str, tuple[int, ...]]] = []
    for sc in ("tri_mul_out", "tri_mul_in"):
        inv += [(f"{sc}.pre_ln", (batch, ns, ns, hz)),
                (f"{sc}.post_ln", (batch, ns, ns, hz)),
                (f"{sc}.ab", (batch, ns, ns, th)),
                (f"{sc}.ab", (batch, ns, ns, th)),
                (f"{sc}.prod_pre_ln", (batch, ns, ns, th)),
                (f"{sc}.out", (batch, ns, ns, hz))]
    for sc in ("tri_attn_start", "tri_attn_end"):
        inv += [(f"{sc}.pre_ln", (batch, ns, ns, hz)),
                (f"{sc}.post_ln", (batch, ns, ns, hz)),
                (f"{sc}.qkv_in", (batch, ns, ns, 3 * hz)),
                (f"{sc}.av", (batch, ns, ns, hz)),
                (f"{sc}.proj_in", (batch, ns, ns, hz))]
    inv += [("pair_trans.pre_ln", (batch, ns, ns, hz)),
            ("pair_trans.post_ln", (batch, ns, ns, hz)),
            ("pair_trans.proj_in", (batch, ns, ns, f * hz))]
    return inv


def score_tensor_shape(cfg: PPMConfig, ns: int, batch: int = 1):
    """The cubic triangular-attention score tensor (per tri-attn op)."""
    return (batch, cfg.pair_heads, ns, ns, ns)
