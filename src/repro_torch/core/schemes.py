"""Quantization-scheme zoo for the paper's comparison tables (port of
``repro/core/schemes.py``).

Every scheme implements the same narrow interface the models call:

    act(x, site)            -> fake-quantized activation (storage boundary)
    linear(x, w, b, site)   -> y = act-quant(x) @ weight-quant(w) + b
    act_bits(site, H)       -> stored bits per activation value at this site
    weight_bits()           -> stored bits per weight value

``baseline_fp16`` and the paper's ``lightnobel_aaq`` are the folding path's
(AAQ runs through the CUDA kernels on the card, ``dispatch``).  The five
comparison schemes are functional re-implementations at the reference's
granularity, plain PyTorch with float32 products:
SmoothQuant = token-wise INT8 acts + channel-wise INT8 weights with dynamic
smoothing; LLM.int8() = INT8 with FP16 outlier-channel decomposition;
PTQ4Protein = tensor-wise INT8; Tender = channel-wise INT4; MEFold =
weight-only INT4.  Their statistics are tensor- or channel-wide, so they are
NOT chunk-exact: on the chunked trunk their scales see one row slab, not the
whole tensor (``repro/models/ppm/chunking.py``, module docstring), and the
port's incoming tri-mul slabs by columns where the reference's slabs by
rows, so chunked folds under them differ between the two packages as well
(``repro_torch/models/ppm/chunking.py``, module docstring).

On the mesh-sharded forward (``repro_torch.parallel.sharding``) a rank
holds part of each pair activation, where the reference's GSPMD program
reduces over the whole tensor.  So every statistic taken over more than
one token (PTQ4Protein's tensor maximum, Tender's and LLM.int8()'s channel
maxima, SmoothQuant's all-token maximum) goes through ``global_amax``: a
maximum over the model group inside a ``sharded`` scope, the local one
outside.  Token-wise statistics and the weights' (replicated) need none.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.policy import AAQConfig
from repro_torch.device import per_row
from repro_torch.core.qtensor import qmax
from repro_torch.parallel.sharding import global_amax

_EPS = 1e-12


def _sym_quant(x: torch.Tensor, bits: int, axis=None,
               global_stat: bool = False) -> torch.Tensor:
    """Uniform symmetric fake-quant with scales over ``axis`` (None: the
    whole tensor); rounds half to even as ``jnp.round`` does.
    ``global_stat``: the maximum spans tokens of an activation, so it is
    taken over the whole of a sharded one (``global_amax``)."""
    xf = x.float()
    if axis is None:
        m = xf.abs().max()
    else:
        m = xf.abs().amax(dim=axis, keepdim=True)
    if global_stat:
        m = global_amax(m)
    s = torch.clamp(m / qmax(bits), min=_EPS)
    return (torch.clamp(torch.round(xf / s), -qmax(bits), qmax(bits)) * s).to(x.dtype)


def _matmul_f32_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with float32 accumulation, result in x's dtype (the reference's
    ``jnp.dot(..., preferred_element_type=f32).astype(x.dtype)``); a row at
    a time in a fold's float32 batch on the card (``device.per_row``)."""
    w = w.to(x.dtype)
    return per_row(lambda t: torch.matmul(t, w), x)


class QuantScheme:
    name = "base"

    def act(self, x, site):
        return x

    def weight(self, w, name=""):
        return w

    def linear(self, x, w, b=None, site=""):
        y = _matmul_f32_acc(self.act(x, site), self.weight(w))
        return y if b is None else y + b

    def act_bits(self, site: str, h: int) -> float:
        return 16.0

    def act_bytes(self, site: str, shape: tuple[int, ...]) -> int:
        """Bytes this scheme stores for activation ``shape`` at ``site``."""
        h = int(shape[-1])
        n_tokens = math.prod(int(d) for d in shape[:-1])
        return int(math.ceil(n_tokens * h * self.act_bits(site, h) / 8.0))

    def weight_bits(self) -> float:
        return 16.0


class FP16Baseline(QuantScheme):
    name = "baseline_fp16"


@dataclasses.dataclass
class AAQScheme(QuantScheme):
    """The paper's scheme. Site-table driven; weights stay 16-bit."""
    cfg: AAQConfig = dataclasses.field(default_factory=AAQConfig)
    name = "lightnobel_aaq"

    def act(self, x, site):
        pol = self.cfg.policy_for(site)
        if not pol.enabled:
            return x
        # routed: the CUDA aaq_fake_quant kernel or the plain reference
        # dataflow (AAQConfig.act's), per the active kernel backend
        from repro_torch.kernels import dispatch
        return dispatch.fake_quant(x, bits=pol.bits, k_outliers=pol.k_outliers)

    def linear(self, x, w, b=None, site=""):
        pol = self.cfg.policy_for(site)
        if pol.enabled:
            # routed: the CUDA aaq_quant + aaq_matmul kernels or the plain
            # integer-path reference, per the active kernel backend
            from repro_torch.kernels import dispatch
            y = dispatch.quantized_linear(x, w, bits=pol.bits,
                                          k_outliers=pol.k_outliers)
        else:
            y = _matmul_f32_acc(x, w)
        return y if b is None else y + b

    def act_bits(self, site, h):
        return self.cfg.policy_for(site).bits_per_value(h)


class SmoothQuantScheme(QuantScheme):
    """Token-wise INT8 activations + channel-wise INT8 weights.

    Smoothing (s_j = max|X_:,j|^a / max|W_j,:|^(1-a)) is applied dynamically
    inside ``linear``: runtime smoothing replaces offline calibration since
    PPM token statistics are input-dependent.
    """
    name = "smoothquant"
    alpha = 0.5

    def act(self, x, site):
        return _sym_quant(x, 8, axis=-1)         # token-wise

    def weight(self, w, name=""):
        return _sym_quant(w, 8, axis=1)          # per-output-channel

    def linear(self, x, w, b=None, site=""):
        xf, wf = x.float(), w.float()
        ax = global_amax(xf.reshape(-1, xf.shape[-1]).abs().amax(dim=0))
        aw = wf.abs().amax(dim=1)
        s = (torch.clamp(ax, min=_EPS) ** self.alpha
             / torch.clamp(aw, min=_EPS) ** (1 - self.alpha))
        s = torch.clamp(s, min=_EPS)
        y = torch.matmul(_sym_quant((xf / s).to(x.dtype), 8, axis=-1).float(),
                         _sym_quant((wf * s[:, None]).to(w.dtype), 8, axis=1).float())
        y = y.to(x.dtype)
        return y if b is None else y + b

    def act_bits(self, site, h):
        return 8 + 32 / h

    def weight_bits(self):
        return 8.0


class LLMInt8Scheme(QuantScheme):
    """INT8 with FP16 outlier-*channel* decomposition (threshold 6.0)."""
    name = "llm_int8"
    threshold = 6.0

    def _decompose(self, x):
        flat = x.float().reshape(-1, x.shape[-1]).abs()
        return global_amax(flat.amax(dim=0)) > self.threshold      # (H,)

    def act(self, x, site):
        oc = self._decompose(x)
        return torch.where(oc, x, _sym_quant(x, 8, axis=-1))

    def weight(self, w, name=""):
        return _sym_quant(w, 8, axis=1)

    def linear(self, x, w, b=None, site=""):
        oc = self._decompose(x)
        x_in = x.masked_fill(oc, 0.0)
        x_out = x.masked_fill(~oc, 0.0)
        y = (torch.matmul(_sym_quant(x_in, 8, axis=-1).float(),
                          _sym_quant(w, 8, axis=1).float())
             + torch.matmul(x_out.float(), w.float())).to(x.dtype)
        return y if b is None else y + b

    def act_bits(self, site, h):
        # measured ~6% outlier channels at fp16 in the reference's calibration
        return 0.94 * 8 + 0.06 * 16 + 32 / h

    def weight_bits(self):
        return 8.0


class PTQ4ProteinScheme(QuantScheme):
    """Tensor-wise INT8 for both activations and weights."""
    name = "ptq4protein"

    def act(self, x, site):
        return _sym_quant(x, 8, axis=None, global_stat=True)

    def weight(self, w, name=""):
        return _sym_quant(w, 8, axis=None)

    def act_bits(self, site, h):
        return 8.0

    def weight_bits(self):
        return 8.0


class TenderScheme(QuantScheme):
    """Channel-wise INT4 with power-of-two row-chunk rescaling (simplified)."""
    name = "tender"

    def act(self, x, site):
        return _sym_quant(x, 4, axis=tuple(range(x.ndim - 1)),   # per-channel
                          global_stat=True)

    def weight(self, w, name=""):
        return _sym_quant(w, 4, axis=0)

    def act_bits(self, site, h):
        return 4.0

    def weight_bits(self):
        return 4.0


class MEFoldScheme(QuantScheme):
    """Weight-only INT4 (mixed INT4/FP16 tensor-wise); activations FP16."""
    name = "mefold"

    def weight(self, w, name=""):
        return _sym_quant(w, 4, axis=None)

    def act_bits(self, site, h):
        return 16.0

    def weight_bits(self):
        return 4.5   # INT4 + FP16 fallback tensors


SCHEMES: dict[str, type[QuantScheme]] = {
    "baseline_fp16": FP16Baseline,
    "lightnobel_aaq": AAQScheme,
    "smoothquant": SmoothQuantScheme,
    "llm_int8": LLMInt8Scheme,
    "ptq4protein": PTQ4ProteinScheme,
    "tender": TenderScheme,
    "mefold": MEFoldScheme,
}


def make_scheme(name: str) -> QuantScheme:
    return SCHEMES[name]()
