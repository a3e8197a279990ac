"""Quantization schemes the models call.

Port of ``repro/core/schemes.py`` for the two schemes of the folding path:
``baseline_fp16`` and the paper's ``lightnobel_aaq``.  Every scheme has the
same narrow interface:

    act(x, site)            -> fake-quantized activation (storage boundary)
    linear(x, w, b, site)   -> y = act-quant(x) @ weight-quant(w) + b
    act_bits(site, H)       -> stored bits per activation value at this site
    weight_bits()           -> stored bits per weight value

The five comparison schemes (SmoothQuant, LLM.int8, PTQ4Protein, Tender,
MEFold) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.policy import AAQConfig


def _matmul_f32_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with float32 accumulation, result in x's dtype (the reference's
    ``jnp.dot(..., preferred_element_type=f32).astype(x.dtype)``)."""
    return torch.matmul(x, w.to(x.dtype))


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


SCHEMES: dict[str, type[QuantScheme]] = {
    "baseline_fp16": FP16Baseline,
    "lightnobel_aaq": AAQScheme,
}


def make_scheme(name: str) -> QuantScheme:
    if name not in SCHEMES:
        raise KeyError(f"scheme {name!r} is not ported; pick one of {sorted(SCHEMES)}")
    return SCHEMES[name]()
