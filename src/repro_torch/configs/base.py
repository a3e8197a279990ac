"""Architecture config schema of the LM zoo (port of ``repro/configs/base.py``,
the dense half).

One ``ArchConfig`` instance fully describes a model.  The fields of the
other families (MoE, MLA, SSM, hybrid, modality frontends) and the dry-run
``ShapeSpec`` tables are not ported yet (ROADMAP Queue 1 item 9): nothing
of the dense path reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    dtype: str = "bfloat16"
    source: str = ""              # provenance note [hf/arXiv]

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
