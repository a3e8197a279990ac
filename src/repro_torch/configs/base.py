"""Architecture config schema shared by the whole zoo (port of
``repro/configs/base.py``).

One ``ArchConfig`` instance fully describes a model: the launcher, the
smoke tests and ``chip_smoke.py`` all consume the same object.  Exact
assigned configs live in sibling files (one per architecture).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    expert_ff: int = 0            # per-expert FFN hidden
    capacity_factor: float = 1.25
    dense_first_layer_ff: int = 0  # DeepSeek: layer 0 is a dense FFN


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma: RG-LRU + local attention, pattern 2:1."""
    lru_width: int = 0            # 0 -> d_model
    conv_width: int = 4
    attn_every: int = 3           # 1 attention per (attn_every - 1) recurrent
    window: int = 2048


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    kind: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "ppm"]
    layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: Literal["rms", "ln"] = "rms"
    act: Literal["silu_glu", "gelu_glu", "gelu", "relu"] = "silu_glu"
    rope_theta: float = 10000.0
    rotary_frac: float = 1.0      # ChatGLM 2D-RoPE rotates half the head dim
    window: int | None = None     # sliding-window attention
    tie_embeddings: bool = False
    max_seq: int = 131072
    scan_layers: bool = True      # the reference scans (and remats) its layers
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    # modality frontends (stubs: precomputed embeddings)
    n_image_tokens: int = 0       # vlm: patch embeds prepended to the stream
    n_audio_frames: int = 0       # encdec: encoder input frames
    enc_layers: int = 0           # encdec: encoder depth
    dtype: str = "bfloat16"
    train_microbatches: int = 1   # gradient-accumulation steps per train_step
    source: str = ""              # provenance note [hf/arXiv]

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def attention_free(self) -> bool:
        return self.kind == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid / bounded-window attn)"""
        return self.kind in ("ssm", "hybrid") or self.window is not None

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: Literal["train", "prefill", "decode", "fold"]


LM_SHAPES: tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

PPM_SHAPES: tuple[ShapeSpec, ...] = (
    ShapeSpec("ns256", 256, 1, "fold"),
    ShapeSpec("ns512", 512, 1, "fold"),
    ShapeSpec("ns1024", 1024, 1, "fold"),
    ShapeSpec("ns2048", 2048, 1, "fold"),
)
