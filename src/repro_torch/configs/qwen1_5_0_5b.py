"""qwen1.5-0.5b [dense]: MHA (kv=16), QKV bias, tied embeddings.
[hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", kind="dense",
    layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, head_dim=64, qkv_bias=True, act="silu_glu", norm="rms",
    rope_theta=10000.0, tie_embeddings=True, max_seq=32768,
    source="hf:Qwen/Qwen1.5-0.5B",
)
