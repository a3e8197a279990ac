"""Training launcher (port of ``repro/launch/train.py``).

Wires together: config registry -> model init (random, from a seeded
``torch.Generator``) -> train step (remat + microbatching + optional AAQ
straight-through fake-quant + gradient compression) -> deterministic data
pipeline -> async checkpointing -> fault-tolerant driver (restart from the
latest checkpoint, straggler watch).  Float32, as the reference trains.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 200 --batch 8 --seq 64 --device cpu

On the card (the default device) ``--aaq-ste``'s fake-quant runs the
``aaq_fake_quant`` kernel at every activation site and the attention its
plain version (no kernel has a backward; ``kernels/dispatch.py``).
``examples/train_lm.py``'s run is this module with its argv:
``--arch qwen1.5-0.5b --steps 200 --batch 8 --seq 64 --lr 1e-3
--ckpt-every 25 --fail-at 100 --aaq-ste --reduced``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.data.pipeline import ShardInfo, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import adamw, grad_compress
from repro_torch.runtime.fault_tolerance import DriverConfig, TrainingDriver


@dataclasses.dataclass
class TrainRun:
    """What ``main`` returns: the per-step losses (the reference's return
    value), the final (params, opt_state) and the driver (restarts, starts,
    straggler flags, saves, history)."""
    losses: list[float]
    state: Any
    driver: TrainingDriver


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
    ap.add_argument("--kernels", choices=list(dispatch.BACKENDS), default=dispatch.AUTO,
                    help="kernel backend: the CUDA kernels, the plain references, or "
                         "auto (kernels on CUDA tensors; plain where an operand "
                         "requires grad)")
    return ap.parse_args(argv)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the multi-device tier (ROADMAP Queue 1 item 11), "
            "which is not ported to repro_torch yet")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = cfg.replace(dtype="float32")
    aaq = AAQConfig(enabled=True, ste=True) if args.aaq_ste else DISABLED

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0, shard=ShardInfo(0, 1))
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
        params = lm.init_params(gen, cfg)
        return (params, adamw.init(params))

    def train_one(state, step):
        params, opt = state
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(step).items()}
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        out = {k: float(v) for k, v in metrics.items()}    # waits for the step
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        return (params, opt), out

    driver = TrainingDriver(
        DriverConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, fail_at_step=args.fail_at),
        train_one, init_state)
    prev = dispatch.get_backend()
    dispatch.set_backend(args.kernels)      # process-wide: backward runs on autograd's threads
    t0 = time.monotonic()
    try:
        state = driver.run()
    finally:
        dispatch.set_backend(prev)
    dt = time.monotonic() - t0
    losses = [h["loss"] for h in driver.history]
    print(f"done: {len(driver.history)} steps in {dt:.1f}s | "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f} | "
          f"restarts={driver.restarts} stragglers={driver.watch.flagged}")
    return TrainRun(losses, state, driver)


if __name__ == "__main__":
    main()
