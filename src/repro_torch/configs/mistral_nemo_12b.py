"""mistral-nemo-12b [dense]: GQA kv=8, head_dim 128 (decoupled), 128k ctx.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", kind="dense",
    layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128, act="silu_glu", norm="rms",
    rope_theta=1000000.0, max_seq=131072, train_microbatches=2,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
