"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2 recurrent : 1
attention, window 2048, MQA (kv=1). [arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", kind="hybrid",
    layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, act="gelu_glu", norm="rms",
    rope_theta=10000.0, window=2048, max_seq=1048576, scan_layers=False,
    train_microbatches=2,
    hybrid=HybridConfig(lru_width=4096, conv_width=4, attn_every=3,
                        window=2048),
    source="arXiv:2402.19427",
)
