"""Structure module (IPA-lite) + structural metrics (Kabsch, TM-score).

Port of ``repro/models/ppm/structure.py``: 3-D C-alpha coordinates from the
trunk's sequence/pair representations via iterative pair-biased attention
with a point-distance term.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.models.ppm.chunking import scan_row_slabs


def init_structure(gen: torch.Generator, cfg) -> cm.Params:
    hm, hz, heads = cfg.hm, cfg.hz, cfg.seq_heads
    dt, dev = cfg.torch_dtype, gen.device

    def d(i, o, bias=False):
        return cm.dense_init(gen, i, o, bias=bias, dtype=dt)

    return {
        "ln_s": cm.ln_init(hm, dt, dev),
        "ln_z": cm.ln_init(hz, dt, dev),
        "qkv": d(hm, 3 * hm, bias=True),
        "pair_bias": d(hz, heads),
        "out": d(hm, hm),
        "trans_mlp": {"ln": cm.ln_init(hm, dt, dev),
                      "up": d(hm, 2 * hm, bias=True),
                      "down": d(2 * hm, hm, bias=True)},
        "coord_ln": cm.ln_init(hm, dt, dev),
        "coord": d(hm, 3, bias=True),
        "dist_w": torch.full((heads,), 0.1, dtype=dt, device=dev),
    }


def pair_bias(p, z, chunk_size: int | None = None):
    """The (B,N,N,H) pair bias ``dense(ln(z))``; with ``chunk_size`` by row
    slabs written into one output, so the layernorm's float32 temporaries
    are one slab's, not the pair tensor's."""
    return scan_row_slabs(
        lambda sl: cm.dense(p["pair_bias"], cm.layernorm(p["ln_z"], sl[0])),
        (z,), chunk_size)


def structure_apply(p, s, z, n_iter: int = 4, mask=None,
                    chunk_size: int | None = None, shard=None):
    """Returns (coords (B,N,3) f32, s_final).

    ``mask`` (B, N) bool marks real tokens; padded keys get the additive
    -1e9 key-padding bias and their values are zeroed.  ``chunk_size``
    builds the pair bias by row slabs (``pair_bias``).  Under ``shard``
    (``z`` the rank's part, ``s`` whole) the (B,N,N,H) bias is built on the
    rank's part and gathered, never z; the rest is replicated.
    """
    b, n, hm = s.shape
    heads = p["pair_bias"]["w"].shape[-1]
    dh = hm // heads
    t = torch.zeros((b, n, 3), dtype=torch.float32, device=s.device)
    bias = pair_bias(p, z, chunk_size)                       # (B,N,N,H)
    if shard is not None:
        bias = shard.whole(bias)
    bias = bias.permute(0, 3, 1, 2).float()
    key_bias = cm.key_padding_bias(mask) if mask is not None else None
    dist = torch.logaddexp(p["dist_w"].float(), torch.zeros((), device=s.device))  # softplus
    for _ in range(n_iter):
        sl = cm.layernorm(p["ln_s"], s)
        q, k, v = torch.split(cm.dense(p["qkv"], sl), hm, dim=-1)
        q = q.reshape(b, n, heads, dh)
        k = k.reshape(b, n, heads, dh)
        v = v.reshape(b, n, heads, dh)
        if mask is not None:
            v = v * mask[:, :, None, None].to(v.dtype)
        d2 = torch.sum((t[:, :, None] - t[:, None, :]) ** 2, dim=-1)  # (B,N,N)
        # pair bias + point-distance term + key padding: one additive bias
        iter_bias = bias - dist[None, :, None, None] * d2[:, None]
        if key_bias is not None:
            iter_bias = iter_bias + key_bias[:, None, None, :]
        o = dispatch.attention(q, k, v, bias=iter_bias)
        s = s + cm.dense(p["out"], o.reshape(b, n, hm).to(s.dtype))
        tm = p["trans_mlp"]
        s = s + cm.dense(tm["down"], torch.relu(cm.dense(tm["up"], cm.layernorm(tm["ln"], s))))
        t = t + cm.dense(p["coord"], cm.layernorm(p["coord_ln"], s)).float()
    return t, s


# --------------------------------------------------------------------------
# structural metrics
# --------------------------------------------------------------------------
def kabsch_align(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Optimal superposition of P onto Q (both (N,3)); returns aligned P."""
    Pc = P - P.mean(dim=0, keepdim=True)
    Qc = Q - Q.mean(dim=0, keepdim=True)
    H = Pc.T @ Qc
    U, _, Vt = torch.linalg.svd(H.float())
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    diag = torch.ones(3, dtype=torch.float32, device=P.device)
    diag[2] = d
    R = (Vt.T * diag) @ U.T
    return Pc @ R.T + Q.mean(dim=0, keepdim=True)


def tm_score(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """TM-score of predicted P vs reference Q, both (N,3) C-alpha traces.

    TM = 1/N * sum_i 1 / (1 + (d_i/d0)^2),  d0 = 1.24 (N-15)^(1/3) - 1.8
    (d0 clamped at 0.5 for short chains), after optimal superposition.
    """
    n = P.shape[0]
    d0 = max(1.24 * max(n - 15.0, 1.0) ** (1.0 / 3.0) - 1.8, 0.5)
    Pa = kabsch_align(P.float(), Q.float())
    d = torch.sqrt(torch.sum((Pa - Q.float()) ** 2, dim=-1) + 1e-12)
    return torch.mean(1.0 / (1.0 + (d / d0) ** 2))


def rmsd(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    Pa = kabsch_align(P.float(), Q.float())
    return torch.sqrt(torch.mean(torch.sum((Pa - Q.float()) ** 2, dim=-1)))
