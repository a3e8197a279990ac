"""Training launcher (port of ``repro/launch/train.py``).

Wires together: config registry -> model init (random, from a seeded
``torch.Generator``) -> sharding rules -> train step (remat +
microbatching + optional AAQ straight-through fake-quant + gradient
compression) -> deterministic data pipeline -> async checkpointing ->
fault-tolerant driver (restart from the latest checkpoint, straggler
watch).  Float32, as the reference trains.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 200 --batch 8 --seq 64 --device cpu

On the card (the default device) ``--aaq-ste``'s fake-quant runs the
``aaq_fake_quant`` kernel at every activation site and the attention its
plain version (no kernel has a backward; ``kernels/dispatch.py``).
``examples/train_lm.py``'s run is this module with its argv:
``--arch qwen1.5-0.5b --steps 200 --batch 8 --seq 64 --lr 1e-3
--ckpt-every 25 --fail-at 100 --aaq-ste --reduced``.

``--model-parallel M`` trains on a ``(world / M, M)`` ``(data, model)``
mesh, the reference's GSPMD step as DTensors: the parameters and AdamW
moments on ``param_shardings``' placements, the batch on ``batch_specs``',
the activations pinned by ``default_act_rules`` (``parallel/sharding.py``).
Under ``torchrun`` (or any initialised group) the group is the mesh;
alone the run takes every card (one rank a card, fewer cards than M
refused) or M ranks on the CPU, starting ranks 1..W-1 itself
(``launch.mesh.start_train_ranks``).  Every rank makes the parameters
from the same seed a part at a time, keeping its shard of each part
before the next is made, and builds the same global batch and keeps its
shard; only rank 0 prints the ``done:`` line and writes checkpoints.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.data.pipeline import ShardInfo, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.optim import adamw, grad_compress
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as sh
from repro_torch.runtime.fault_tolerance import DriverConfig, TrainingDriver
from repro_torch.tree import leaves, unflatten

@dataclasses.dataclass
class TrainRun:
    """What ``main`` returns: the per-step losses (the reference's return
    value), the final (params, opt_state), the driver (restarts, starts,
    straggler flags, saves, history) and the mesh shape.  In a sharded run
    the state is the rank's DTensors, whose group is gone when ``main``
    returns (``to_local()`` is the rank's shard); with ``--gather-state``
    rank 0 gets every leaf whole on the host instead (gathered one leaf at
    a time, so no device holds the whole state) and the other ranks None."""
    losses: list[float]
    state: Any
    driver: TrainingDriver
    mesh: Any = None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--aaq-ste", action="store_true",
                    help="train with AAQ fake-quant + straight-through grads")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms on every rank (a bitwise "
                         "resume on the card)")
    ap.add_argument("--gather-state", action="store_true",
                    help="a sharded run returns its final state to rank 0 whole, on the "
                         "host, gathered one leaf at a time (for comparisons)")
    ap.add_argument("--report", default=None,
                    help="directory each rank writes rank<r>.json to: losses, step ms, "
                         "peak device memory, kernel launches and plain calls, routed "
                         "calls, collectives a step (calls and bytes)")
    ap.add_argument("--kernels", choices=list(dispatch.BACKENDS), default=dispatch.AUTO,
                    help="kernel backend: the CUDA kernels, the plain references, or "
                         "auto (kernels on CUDA tensors; plain where an operand "
                         "requires grad)")
    # a started rank of a --model-parallel run (launch.mesh.start_train_ranks)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--threads", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


@dataclasses.dataclass
class _Group:
    """The process group of a sharded run: ``made`` if this call created
    it (and tears it down), ``procs`` the ranks it started."""
    made: bool = False
    procs: list = dataclasses.field(default_factory=list)
    tmp: str | None = None


def _join_group(args, argv, dev: torch.device) -> _Group:
    """Join or make the group of a sharded run (see the module docstring)."""
    g = _Group()
    if dist.is_initialized():
        return g
    if args.rank is not None:                         # a started rank
        if args.parent:
            lmesh._watch_parent(args.parent)
        if args.threads:
            torch.set_num_threads(args.threads)
        lmesh.init_train_group(args.rank, args.world, args.init, dev.type)
        g.made = True
        return g
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:     # torchrun
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo")
        g.made = True
        return g
    world = lmesh.training_world(args.model_parallel, dev.type)
    g.tmp, init = lmesh.rendezvous()
    g.procs = lmesh.start_train_ranks(world, argv, init)
    lmesh.init_train_group(0, world, init, dev.type)
    g.made = True
    return g


def _leave_group(g: _Group, ok: bool) -> None:
    if g.made and dist.is_initialized():
        if ok:
            dist.barrier()
        dist.destroy_process_group()
    if ok:
        lmesh.stop_ranks(g.procs)
    else:
        for p in g.procs:
            p.kill()
            p.wait()
    if g.tmp:
        shutil.rmtree(g.tmp, ignore_errors=True)


def _report(path: str, rank: int, driver: TrainingDriver, dev: torch.device,
            held: int) -> None:
    """``--report``: this rank's readings as ``<path>/rank<rank>.json``
    (``peak_bytes``: the device's peak above the ``held`` bytes allocated
    before the run)."""
    steps = max(len(driver.history), 1)
    out = {"rank": rank, "losses": [h["loss"] for h in driver.history],
           "step_ms": [h["step_ms"] for h in driver.history],
           "restarts": driver.restarts, "starts": driver.starts,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev) - held
                          if dev.type == "cuda" else None),
           "launches": dispatch.launch_counts(), "plain": dispatch.plain_counts(),
           "routed": dict(dispatch.counters), "redistributed": dict(sh.REDISTRIBUTED),
           "collectives_a_step": {k: {f: v[f] / steps for f in v}
                                  for k, v in coll.counts().items() if v["calls"]}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _host_state(state, rank0: bool):
    """``state``'s DTensors whole on rank 0's host (None elsewhere): a
    collective a leaf on every rank, one leaf whole on a device at a time."""
    out = []
    for x in leaves(state):
        whole = sh.to_global(x)                     # every rank takes part
        out.append(whole.cpu() if rank0 else None)
    return unflatten(state, out) if rank0 else None


def main(argv=None) -> TrainRun:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--deterministic" in argv:
        # cuBLAS's deterministic products need this before CUDA starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = cfg.replace(dtype="float32")
    sharded = args.model_parallel > 1 or args.rank is not None or dist.is_initialized() \
        or ("WORLD_SIZE" in os.environ and "RANK" in os.environ)
    group = _join_group(args, argv, dev) if sharded else _Group()
    ok = False
    was = torch.are_deterministic_algorithms_enabled()
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    try:
        run = _train(args, cfg, dev, sharded)
        ok = True
        return run
    finally:
        torch.use_deterministic_algorithms(was)
        if sharded:
            _leave_group(group, ok)


def _train(args, cfg, dev: torch.device, sharded: bool) -> TrainRun:
    if sharded and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    aaq = AAQConfig(enabled=True, ste=True) if args.aaq_ste else DISABLED
    mesh = lmesh.make_host_mesh(model=args.model_parallel) if sharded else None
    rank0 = not sharded or dist.get_rank() == 0

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0, shard=ShardInfo(0, 1))
    bspec = (sh.batch_specs(cfg, ShapeSpec("train", args.seq, args.batch, "train"),
                            mesh)["batch"] if sharded else None)
    gc_state = {"r": None}

    def compress(grads):
        if gc_state["r"] is None:
            gc_state["r"] = grad_compress.init_state(grads)
        g, gc_state["r"] = grad_compress.compress_decompress(grads, gc_state["r"], bits=8)
        return g

    step_fn = make_train_step(cfg, adamw.AdamWConfig(lr=args.lr), aaq=aaq,
                              microbatches=args.microbatches,
                              grad_compress=compress if args.grad_compress else None)

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        # sharded: each part distributed as it is made (the same numbers)
        place = ((lambda path, part: sh.distribute_params(part, mesh, cfg, path))
                 if sharded else cm.as_made)
        params = lm.init_params(gen, cfg, place=place)
        return (params, adamw.init(params))

    def train_one(state, step):
        params, opt = state
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}
        if sharded:
            batch = {k: sh.distribute(v, mesh, bspec[k]) for k, v in batch.items()}
        t0 = time.perf_counter()
        counting = coll.counting_dtensor() if args.report else contextlib.nullcontext()
        with sh.act_rules(sh.default_act_rules(mesh, "train", cfg) if sharded else None), \
                counting:
            params, opt, metrics = step_fn(params, opt, batch)
        # waits for the step (a collective where the metric is a DTensor)
        out = {k: float(sh.to_global(v)) for k, v in metrics.items()}
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        return (params, opt), out

    driver = TrainingDriver(
        DriverConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at, arch=cfg),
        train_one, init_state, barrier=dist.barrier if sharded else None)
    prev = dispatch.get_backend()
    dispatch.set_backend(args.kernels)      # process-wide: backward runs on autograd's threads
    held = 0
    if args.report:
        dispatch.reset_counters()
        coll.reset_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
    t0 = time.monotonic()
    try:
        state = driver.run()
    finally:
        dispatch.set_backend(prev)
    dt = time.monotonic() - t0
    losses = [h["loss"] for h in driver.history]
    if args.report:
        _report(args.report, dist.get_rank() if sharded else 0, driver, dev, held)
    if sharded and args.gather_state:      # before the group goes
        state = _host_state(state, rank0)
    if rank0:
        print(f"done: {len(driver.history)} steps in {dt:.1f}s | "
              f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f} | "
              f"restarts={driver.restarts} stragglers={driver.watch.flagged}")
    return TrainRun(losses, state, driver,
                    tuple(mesh.shape) if mesh is not None else None)


if __name__ == "__main__":
    main()
