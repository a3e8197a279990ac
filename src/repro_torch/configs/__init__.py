"""Config registry for the folding model (port of the PPM half of
``repro.configs``); the LM architectures are not ported yet."""
from __future__ import annotations


def get_ppm_config():
    from repro_torch.configs.esmfold_ppm import CONFIG
    return CONFIG


def reduce_ppm_config(cfg=None):
    """Tiny same-family variant for CPU tests and the CLI default."""
    from repro_torch.models.ppm.trunk import PPMConfig
    return PPMConfig(blocks=2, hm=64, hz=32, seq_heads=4, pair_heads=4,
                     tri_hidden=32, vocab=23, recycles=1, ipa_iters=2,
                     dtype="float32")
