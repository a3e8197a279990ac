"""Long-fold serving tier: memory planning for row-chunked trunk execution.

The model half lives in ``repro_torch.models.ppm.chunking`` (row-chunked pair
ops); this package is the serving half — the planner that decides which
buckets chunk and at what size, against the admission controller's
chunked-path cost model.  See ``planner.ChunkPolicy``.
"""
from repro_torch.serving.longfold.planner import (
    AUTO,
    DEFAULT_LONGFOLD_BUDGET_MB,
    FIXED,
    MIN_CHUNK,
    OFF,
    ChunkPolicy,
    chunk_candidates,
    parse_chunk_spec,
)

__all__ = [
    "AUTO",
    "DEFAULT_LONGFOLD_BUDGET_MB",
    "FIXED",
    "MIN_CHUNK",
    "OFF",
    "ChunkPolicy",
    "chunk_candidates",
    "parse_chunk_spec",
]
