"""esmfold_ppm — the paper's own architecture: ESMFold folding trunk
(Hz=128, Hm=1024, 48 blocks, pair heads 4x32) + structure module.
[ESMFold: Lin et al., Science 379 (2023)]"""
from repro_torch.models.ppm.trunk import PPMConfig

CONFIG = PPMConfig(
    blocks=48, hm=1024, hz=128, seq_heads=16, pair_heads=4,
    tri_hidden=128, transition_factor=4, vocab=23, relpos_bins=65,
    recycles=1, distogram_bins=64, ipa_iters=4, dtype="bfloat16",
)
