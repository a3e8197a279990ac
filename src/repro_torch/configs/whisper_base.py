"""whisper-base [audio]: enc-dec backbone; conv frontend STUBBED — the
encoder consumes precomputed (B, 1500, 512) frame embeddings.
Decode cells run the decoder mechanically at the assigned KV length
(the real model caps targets at 448).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", kind="encdec",
    layers=6, enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51865, act="gelu", norm="ln", rotary_frac=0.0,
    tie_embeddings=True,
    n_audio_frames=1500, max_seq=32768, scan_layers=False,
    source="arXiv:2212.04356",
)
