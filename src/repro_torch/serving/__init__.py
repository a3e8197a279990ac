"""Fold-serving helpers of the sequential server (bucketing and padding);
the batching engine is not ported yet."""
from repro_torch.serving.scheduler import bucket_for, parse_buckets, pow2_buckets
from repro_torch.serving.types import pad_to_bucket
