"""AAQ policy table: the 'Adaptive' in Adaptive Activation Quantization.

Port of ``repro/core/policy.py``.  Every activation site of the pair
dataflow belongs to one of three groups:

    Group A  pre-LayerNorm residual-stream tensors   -> INT8 inliers, 4 outliers
    Group B  post-LayerNorm, pre-linear tensors      -> INT4 inliers, 4 outliers
    Group C  everything else (gates, probs, small)   -> INT4 inliers, 0 outliers

The table maps site names (strings in the model code) to groups.  It is
copied exactly from the reference.  ``AAQConfig.act`` routes through
``dispatch.fake_quant`` (the ``aaq_fake_quant`` kernel on the card), or its
straight-through form ``quantize.fake_quant_ste`` when ``ste`` is set (the
training path).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import torch

from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantize import fake_quant_ste as _fake_quant_ste
from repro_torch.core.quantize import quantize as _quantize_fn


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    bits: int          # inlier precision (4 or 8); 16 means "leave unquantized"
    k_outliers: int
    name: str = ""

    @property
    def enabled(self) -> bool:
        return self.bits < 16

    def bits_per_value(self, feature_dim: int) -> float:
        """Average stored bits per original value: inliers, k outliers as
        (16-bit value + 32-bit index), one f32 scale per token."""
        if not self.enabled:
            return 16.0
        total = self.bits * feature_dim + self.k_outliers * (16 + 32) + 32
        return total / feature_dim


GROUP_A = QuantPolicy(bits=8, k_outliers=4, name="A")
GROUP_B = QuantPolicy(bits=4, k_outliers=4, name="B")
GROUP_C = QuantPolicy(bits=4, k_outliers=0, name="C")
NO_QUANT = QuantPolicy(bits=16, k_outliers=0, name="none")

# Site-pattern -> group; the first regex hit wins.
DEFAULT_SITE_TABLE: tuple[tuple[str, QuantPolicy], ...] = (
    (r".*\.pre_ln$", GROUP_A),        # residual stream entering LayerNorm
    (r".*\.residual$", GROUP_A),
    (r".*\.post_ln$", GROUP_B),       # normalized, about to hit a linear
    (r".*\.qkv_in$", GROUP_B),
    (r".*\.gate$", GROUP_C),          # sigmoid gates, small dynamic range
    (r".*\.probs$", GROUP_C),         # attention probabilities
    (r".*\.proj_in$", GROUP_C),       # products of small weights
    (r".*\.av$", GROUP_C),
    (r".*", GROUP_C),                 # default: most conservative size-wise
)


@dataclasses.dataclass(frozen=True)
class AAQConfig:
    """Runtime switchboard for AAQ. ``enabled=False`` => exact FP dataflow."""

    enabled: bool = True
    site_table: tuple[tuple[str, QuantPolicy], ...] = DEFAULT_SITE_TABLE
    overrides: Mapping[str, QuantPolicy] | None = None   # exact-name overrides
    ste: bool = False            # straight-through grads (training path)
    collect_stats: bool = False  # calibration mode (core.calibration)

    def policy_for(self, site: str) -> QuantPolicy:
        if not self.enabled:
            return NO_QUANT
        if self.overrides and site in self.overrides:
            return self.overrides[site]
        for pat, pol in self.site_table:
            if re.fullmatch(pat, site):
                return pol
        return NO_QUANT

    def act(self, x: torch.Tensor, site: str) -> torch.Tensor:
        """Fake-quant an activation at ``site``, routed by ``dispatch``: the
        ``aaq_fake_quant`` kernel on a CUDA tensor, the reference dataflow
        on a CPU one; with ``ste``, under straight-through gradients.  A
        DTensor (a sharded train step) is quantized as each rank's whole
        rows, one routed call a rank."""
        pol = self.policy_for(site)
        if not pol.enabled:
            return x
        if self.ste:
            return _fake_quant_ste(x, pol.bits, pol.k_outliers).to(x.dtype)
        # dispatch imports core (its plain versions): import it at call time
        from repro_torch.kernels import dispatch
        from repro_torch.parallel import sharding as sh
        return sh.on_rows("fake_quant", lambda t: dispatch.fake_quant(
            t, bits=pol.bits, k_outliers=pol.k_outliers), x).to(x.dtype)

    def quantize(self, x: torch.Tensor, site: str) -> QTensor | torch.Tensor:
        pol = self.policy_for(site)
        if not pol.enabled:
            return x
        return _quantize_fn(x, pol.bits, pol.k_outliers)


DISABLED = AAQConfig(enabled=False)
