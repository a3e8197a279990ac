"""chatglm3-6b [dense]: GQA kv=2, 2D (partial) RoPE, QKV bias.
[arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", kind="dense",
    layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=65024, head_dim=128, qkv_bias=True, act="silu_glu", norm="rms",
    rotary_frac=0.5,      # ChatGLM rotates half the head dim ("RoPE 2d")
    rope_theta=10000.0, max_seq=32768,
    source="arXiv:2406.12793",
)
