"""qwen2.5-3b [dense]: GQA kv=2, QKV bias, tied embeddings.
[hf:Qwen/Qwen2.5-3B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", kind="dense",
    layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab=151936, head_dim=128, qkv_bias=True, act="silu_glu", norm="rms",
    rope_theta=1000000.0, tie_embeddings=True, max_seq=32768,
    source="hf:Qwen/Qwen2.5-3B",
)
