"""Elastic scaling: resume a run on another device count or mesh shape
(port of ``repro/runtime/elastic.py``).

Checkpoints are mesh-agnostic (host-view arrays); elasticity is therefore:
  1. build a new mesh from the ranks there are,
  2. recompute the specs from the SAME logical rules on the new mesh,
  3. distribute the restored tree (``checkpoint.restore(shardings=...)``),
  4. re-shard the data stream deterministically (``ShardInfo.reshard``).

Scale-down of the data axis changes the per-rank batch, not the global
batch: the global batch is part of the training semantics, kept by raising
the gradient-accumulation microbatches by the same factor.
"""
from __future__ import annotations

import dataclasses

from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.data.pipeline import ShardInfo
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding as sh


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    microbatch_scale: int          # multiply the microbatches by this
    shard: ShardInfo


def plan_for_devices(n_devices: int, model_parallel: int, old_data: int,
                     host_rank: int = 0, n_hosts: int = 1) -> ElasticPlan:
    """A mesh for the surviving devices, keeping the model axis (the
    weights' layouts stay valid) and absorbing lost data ranks into
    microbatching (the reference's integer arithmetic)."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices do not hold a model axis of {model_parallel}")
    data = n_devices // model_parallel
    scale = max(1, old_data // data)
    return ElasticPlan((data, model_parallel), ("data", "model"), scale,
                       ShardInfo(host_rank, n_hosts))


def resume_elastic(ckpt_dir: str, template, plan: ElasticPlan, cfg=None):
    """Restore the latest checkpoint onto the new mesh (the process group
    must hold exactly its ranks): (step, tree of DTensors, mesh).  ``cfg``
    also names the layers the checkpoint stacks (``checkpointing.restore``)."""
    mesh = make_mesh(plan.mesh_shape, plan.mesh_axes)
    shardings = sh.param_shardings(template, mesh, cfg)
    step, tree = ckpt.restore(ckpt_dir, template, shardings=shardings, cfg=cfg)
    return step, tree, mesh
