"""mamba2-780m [ssm]: SSD (state-space duality), attention-free,
ssm_state=128. [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m", kind="ssm",
    layers=48, d_model=1536, n_heads=48, n_kv_heads=48, d_ff=0,
    vocab=50280, act="silu_glu", norm="rms", rotary_frac=0.0,
    max_seq=1048576, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=128),
    source="arXiv:2405.21060",
)
