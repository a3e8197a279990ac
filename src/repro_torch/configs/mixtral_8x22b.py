"""mixtral-8x22b [moe]: 8 experts top-2, GQA kv=8, sliding-window attention
(per assignment). [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", kind="moe",
    layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, head_dim=128, act="silu_glu", norm="rms",
    rope_theta=1000000.0, window=4096, max_seq=65536,
    train_microbatches=8,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, expert_ff=16384),
    source="arXiv:2401.04088",
)
