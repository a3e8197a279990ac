"""Config registry (port of ``repro.configs``): the folding model's config
and the dense LM architectures.  The other LM families are not ported yet
(ROADMAP Queue 1 item 9); asking for one raises ``NotImplementedError``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "qwen2.5-3b": "qwen2_5_3b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
}
#: the reference's architectures of other kinds, not ported yet
_NOT_PORTED = ("phi-3-vision-4.2b", "deepseek-v2-lite-16b", "mixtral-8x22b",
               "recurrentgemma-9b", "mamba2-780m", "whisper-base")

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str):
    if name == "esmfold_ppm":
        return get_ppm_config()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not a dense transformer; the port serves only the dense "
            f"configs {ARCH_NAMES} (the other kinds are ROADMAP Queue 1 item 9)")
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU tests (the reference's dense rule)."""
    if cfg.kind != "dense":
        raise NotImplementedError(
            f"reduce_config: kind {cfg.kind!r} is ROADMAP Queue 1 item 9")
    return cfg.replace(
        layers=min(cfg.layers, 2), d_model=64, n_heads=4,
        n_kv_heads=max(1, round(4 * cfg.n_kv_heads / cfg.n_heads)),
        d_ff=96 if cfg.d_ff else 0, vocab=128, head_dim=16,
        max_seq=512, window=(16 if cfg.window else None))


def get_ppm_config():
    from repro_torch.configs.esmfold_ppm import CONFIG
    return CONFIG


def reduce_ppm_config(cfg=None):
    """Tiny same-family variant for CPU tests and the CLI default."""
    from repro_torch.models.ppm.trunk import PPMConfig
    return PPMConfig(blocks=2, hm=64, hz=32, seq_heads=4, pair_heads=4,
                     tri_hidden=32, vocab=23, recycles=1, ipa_iters=2,
                     dtype="float32")
