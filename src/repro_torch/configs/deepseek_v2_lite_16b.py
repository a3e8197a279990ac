"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + 64 routed experts top-6
+ 2 shared, dense first layer. [arXiv:2405.04434; hf]

The bracket config (64e top-6) is authoritative; the '160 routed' prose
matches full V2, not Lite.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", kind="moe",
    layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, act="silu_glu", norm="rms",
    rope_theta=10000.0, max_seq=163840, train_microbatches=4,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_ff=1408,
                  dense_first_layer_ff=10944),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
)
