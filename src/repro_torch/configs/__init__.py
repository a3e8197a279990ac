"""Config registry (port of ``repro.configs``): ``get_config(name)``,
reduced CPU variants, shapes."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, HybridConfig, LM_SHAPES,  # noqa: F401
                                      MLAConfig, MoEConfig, PPM_SHAPES, ShapeSpec,
                                      SSMConfig)

_MODULES = {
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen2.5-3b": "qwen2_5_3b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-780m": "mamba2_780m",
    "whisper-base": "whisper_base",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str):
    if name == "esmfold_ppm":
        return get_ppm_config()
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def get_ppm_config():
    from repro_torch.configs.esmfold_ppm import CONFIG
    return CONFIG


def shapes_for(name: str) -> tuple[ShapeSpec, ...]:
    return PPM_SHAPES if name == "esmfold_ppm" else LM_SHAPES


def cell_supported(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Is this (arch x shape) cell runnable? (False, reason) for the
    documented skips."""
    if getattr(cfg, "kind", "ppm") == "ppm":
        return True, ""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k dense-KV decode excluded "
                       "per assignment (needs sub-quadratic attention)")
    if shape.name == "long_500k" and cfg.kind == "encdec":
        return False, "enc-dec with fixed 1500-frame encoder; no 500k decode"
    return True, ""


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests (the reference's rule)."""
    kw = dict(
        layers=min(cfg.layers, 3 if cfg.kind == "hybrid" else 2),
        d_model=64, n_heads=4,
        n_kv_heads=max(1, round(4 * cfg.n_kv_heads / cfg.n_heads)),
        d_ff=96 if cfg.d_ff else 0, vocab=128, head_dim=16,
        max_seq=512, window=(16 if cfg.window else None),
    )
    if cfg.kind == "hybrid":
        kw["layers"] = 3
        kw["hybrid"] = HybridConfig(lru_width=64, conv_width=4, attn_every=3, window=16)
    if cfg.kind == "ssm":
        kw["ssm"] = SSMConfig(d_state=16, head_dim=8, expand=2, conv_width=4, chunk=8)
        kw["n_heads"] = 16   # d_inner/head_dim = 128/8
        kw["n_kv_heads"] = 16
    if cfg.moe:
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=2, n_shared=cfg.moe.n_shared, expert_ff=64,
            dense_first_layer_ff=(128 if cfg.moe.dense_first_layer_ff else 0))
    if cfg.mla:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.kind == "vlm":
        kw["n_image_tokens"] = 4
    if cfg.kind == "encdec":
        kw["n_audio_frames"] = 8
        kw["enc_layers"] = 2
    return cfg.replace(**kw)


def reduce_ppm_config(cfg=None):
    """Tiny same-family variant for CPU tests and the CLI default."""
    from repro_torch.models.ppm.trunk import PPMConfig
    return PPMConfig(blocks=2, hm=64, hz=32, seq_heads=4, pair_heads=4,
                     tri_hidden=32, vocab=23, recycles=1, ipa_iters=2,
                     dtype="float32")
