"""Length buckets (the shape-policy functions of
``repro/serving/scheduler.py``)."""
from __future__ import annotations


def pow2_buckets(min_len: int, max_len: int, floor: int = 16) -> tuple[int, ...]:
    """Power-of-two bucket edges covering [min_len, max_len]."""
    edges = []
    b = floor
    while b < max(min_len, floor):
        b *= 2
    while True:
        edges.append(b)
        if b >= max_len:
            break
        b *= 2
    return tuple(edges)


def parse_buckets(spec: str, min_len: int, max_len: int) -> tuple[int, ...]:
    """--buckets CLI spec: 'pow2' or comma-separated edges ('32,64,96')."""
    if spec == "pow2":
        return pow2_buckets(min_len, max_len)
    edges = tuple(sorted(int(tok) for tok in spec.split(",") if tok.strip()))
    if not edges:
        raise ValueError(f"empty bucket spec {spec!r}")
    return edges


def bucket_for(buckets: tuple[int, ...], length: int) -> int | None:
    """Smallest bucket edge holding ``length`` (None = too long)."""
    for edge in buckets:
        if length <= edge:
            return edge
    return None
