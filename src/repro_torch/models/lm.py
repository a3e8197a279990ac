"""Unified architecture API, the dense kind (port of ``repro/models/lm.py``).

    init_params(gen, cfg)                      -> params
    prefill_fn(params, batch, cfg, aaq)        -> last-position logits
    decode_fn(params, batch, cache, cfg, aaq)  -> (logits, cache')
    make_cache(cfg, batch_size, max_len)       -> cache

The other kinds (MoE, SSM, hybrid, enc-dec, VLM) are ROADMAP Queue 1 item 9;
``loss_fn`` waits for training (item 10).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.models import transformer as tf


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.kind != "dense":
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet (ROADMAP Queue 1 item 9); "
            "the port runs the dense transformer")


def init_params(gen: torch.Generator, cfg: ArchConfig):
    """Random parameters from ``gen`` (made on ``gen.device``)."""
    _dense_only(cfg)
    return tf.init_lm(gen, cfg)


def prefill_fn(params, batch, cfg: ArchConfig, aaq: AAQConfig = DISABLED):
    """Full-sequence forward -> logits of the last position (B, 1, V)."""
    _dense_only(cfg)
    return tf.lm_forward(params, batch, cfg, aaq=aaq, last_only=True)


def make_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               quantized: bool = False, device=None):
    _dense_only(cfg)
    return tf.init_cache(cfg, batch, max_len, dtype, quantized=quantized, device=device)


def decode_fn(params, batch, cache, cfg: ArchConfig, aaq: AAQConfig = DISABLED):
    _dense_only(cfg)
    return tf.decode_step(params, batch, cache, cfg, aaq=aaq)
