"""Calibration tooling: the paper's §3.3/§3.4 activation analysis (port of
``repro/core/calibration.py``).

Computes per-token statistics (mean |x|, 3-sigma outlier counts) for every
instrumented activation site, and classifies sites into groups A/B/C with the
thresholds implied by Fig. 6(c):

    A: mean|x| large  (paper: 82.14, ~2.31 outliers/token)
    B: mean|x| small, outliers/token >= 1  (paper: 4.05 / 1.69)
    C: mean|x| small, outliers/token  < 1  (paper: 3.85 / 0.64)

``jnp.std``/``jnp.var`` are population statistics, hence ``correction=0``.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core.policy import GROUP_A, GROUP_B, GROUP_C, QuantPolicy


@dataclasses.dataclass
class SiteStats:
    abs_mean: float = 0.0
    outliers_per_token: float = 0.0
    token_var: float = 0.0      # variance of per-token means (token-wise axis)
    channel_var: float = 0.0    # variance of per-channel means
    n_samples: int = 0


def token_stats(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-activation statistics over the token axis (trailing dim = channel)."""
    xf = x.detach().float().abs().reshape(-1, x.shape[-1])          # (T, H)
    mu, sd = xf.mean(), xf.std(correction=0)
    outliers = (xf > mu + 3.0 * sd).sum(dim=-1)                     # 3-sigma rule
    return {
        "abs_mean": xf.mean(),
        "outliers_per_token": outliers.float().mean(),
        "token_var": xf.mean(dim=1).var(correction=0),    # across tokens
        "channel_var": xf.mean(dim=0).var(correction=0),  # across channels
    }


def classify(abs_mean: float, outliers_per_token: float,
             large_value_threshold: float = 20.0) -> QuantPolicy:
    """Group assignment per Fig. 6(c) characteristics."""
    if abs_mean >= large_value_threshold:
        return GROUP_A
    if outliers_per_token >= 1.0:
        return GROUP_B
    return GROUP_C


class Calibrator:
    """Accumulates site stats across forward passes (``AAQConfig.collect_stats``).

    Models call ``calibrator.observe(site, x)``; afterwards
    ``calibrator.site_table()`` yields a measured policy table that can be
    compared against / substituted for ``DEFAULT_SITE_TABLE``.
    """

    def __init__(self):
        self._acc: dict[str, list[dict[str, float]]] = defaultdict(list)

    def observe(self, site: str, x: torch.Tensor) -> None:
        self._acc[site].append({k: float(v) for k, v in token_stats(x).items()})

    def stats(self) -> dict[str, SiteStats]:
        out = {}
        for site, rows in self._acc.items():
            agg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
            out[site] = SiteStats(abs_mean=agg["abs_mean"],
                                  outliers_per_token=agg["outliers_per_token"],
                                  token_var=agg["token_var"],
                                  channel_var=agg["channel_var"],
                                  n_samples=len(rows))
        return out

    def site_table(self) -> dict[str, QuantPolicy]:
        return {site: classify(s.abs_mean, s.outliers_per_token)
                for site, s in self.stats().items()}
