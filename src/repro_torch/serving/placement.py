"""Device placement for the serving tier (port of
``repro/serving/placement.py``, single device only).

A ``Placement`` is part of the engine's executable-cache key
``(bucket, launch_batch, scheme, placement, chunk)`` and its ``label`` rides
``ScheduledBatch`` / ``FoldResult.placement`` into the reports, so the
port's keys and report columns read as the reference's.  The port serves on
one card: every bucket's placement is ``SINGLE``.  Mesh-sharded serving
(``mesh=`` / ``shard_threshold=``) is not ported (ROADMAP Queue 1 item 11)
and raises, so that no caller believes a bucket is sharded while it runs
on one device.
"""
from __future__ import annotations

import dataclasses

SINGLE = "single"

NOT_PORTED = ("mesh-sharded serving is not ported to repro_torch yet "
              "(ROADMAP Queue 1 item 11, multi-device); the port serves on "
              "one device only")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one bucket's executable is captured and run."""
    kind: str                                  # SINGLE
    label: str                                 # cache-key + report column


SINGLE_PLACEMENT = Placement(SINGLE, SINGLE)


class PlacementPolicy:
    """bucket -> Placement: always ``SINGLE_PLACEMENT`` in the port.  A mesh
    or a shard threshold raises ``NotImplementedError``."""

    def __init__(self, mesh=None, shard_threshold: int | None = None):
        if mesh is not None or shard_threshold is not None:
            raise NotImplementedError(NOT_PORTED)
        self.mesh = None
        self.shard_threshold = None

    def placement_for(self, bucket: int) -> Placement:
        return SINGLE_PLACEMENT

    def shards_for(self, bucket: int) -> int:
        """Model-axis shard count admission divides per-device bytes by."""
        return 1

    def label_for(self, bucket: int) -> str:
        return SINGLE

    def describe(self) -> dict:
        """Run-level placement facts for trace metadata."""
        return {"shard_threshold": None, "mesh": None, "model_shards": 1}
