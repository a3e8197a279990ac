"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (stubbed).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", kind="vlm",
    layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064, head_dim=96, act="silu_glu", norm="rms",
    rope_theta=10000.0, max_seq=131072,
    n_image_tokens=256,   # stub: precomputed CLIP patch embeddings
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
