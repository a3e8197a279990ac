"""Request padding (``pad_to_bucket`` of ``repro/serving/types.py``)."""
from __future__ import annotations

import numpy as np


def pad_to_bucket(seqs: list[np.ndarray], bucket: int,
                  batch: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad sequences into an (B, bucket) aatype batch + bool mask.

    ``batch`` > len(seqs) appends fully-masked dummy rows.
    """
    b = batch or len(seqs)
    if b < len(seqs):
        raise ValueError(f"batch {b} < {len(seqs)} sequences")
    aatype = np.zeros((b, bucket), np.int32)
    mask = np.zeros((b, bucket), bool)
    for i, s in enumerate(seqs):
        ln = len(s)
        if ln > bucket:
            raise ValueError(f"sequence len {ln} exceeds bucket {bucket}")
        aatype[i, :ln] = s
        mask[i, :ln] = True
    return aatype, mask
