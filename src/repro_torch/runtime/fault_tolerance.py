"""Fault-tolerant training driver: checkpoint/restart, straggler watch,
preemption simulation (port of ``repro/runtime/fault_tolerance.py``).

The driver is host-level Python: on a real cluster this is the per-job
supervisor that the scheduler restarts; in tests a failure is injected and
the resumed run's final state must equal an uninterrupted run's bitwise
(the data stream is a pure function of the step, ``data.pipeline``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint import checkpointing as ckpt


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerWatch:
    """Flags steps whose duration z-scores out against the trailing window.

    On a flag the driver calls ``on_straggler(step)`` (in production that
    moves data shards away from the slow host: ``ShardInfo.reshard``); here
    it is recorded.
    """
    window: int = 32
    z_threshold: float = 4.0
    _times: list[float] = dataclasses.field(default_factory=list)
    flagged: list[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        hist = self._times[-self.window:]
        self._times.append(dt)
        if len(hist) < 8:
            return False
        mu, sd = float(np.mean(hist)), float(np.std(hist) + 1e-9)
        if (dt - mu) / sd > self.z_threshold:
            self.flagged.append(step)
            return True
        return False


@dataclasses.dataclass
class DriverConfig:
    total_steps: int = 100
    ckpt_every: int = 10
    ckpt_dir: str = "build/train_ckpt"
    keep_last_k: int = 3
    fail_at_step: int | None = None      # simulate preemption once
    max_restarts: int = 3
    arch: Any = None                     # the model's config: checkpoints stack its layers


class TrainingDriver:
    """``run()`` executes ``train_step_fn`` with checkpoint/restart semantics.

    train_step_fn: (state, step) -> (state, metrics)
    state is any tree of tensors, e.g. (params, opt_state): saved and
    restored whole.  ``init_state_fn`` makes a fresh state, which a restart
    uses as the template it restores the latest checkpoint into (DTensor
    leaves onto their placements).  ``barrier``: called before a (re)start
    looks for the latest checkpoint, so that in a run of several ranks
    every rank has finished the save rank 0 writes.
    """

    def __init__(self, cfg: DriverConfig,
                 train_step_fn: Callable[[Any, int], tuple[Any, dict]],
                 init_state_fn: Callable[[], Any],
                 on_straggler: Callable[[int], None] | None = None,
                 barrier: Callable[[], Any] | None = None):
        self.cfg = cfg
        self.barrier = barrier
        self.train_step_fn = train_step_fn
        self.init_state_fn = init_state_fn
        self.watch = StragglerWatch()
        self.on_straggler = on_straggler or (lambda step: None)
        self.restarts = 0
        self.starts: list[int] = []          # the first step of each run
        self.saves: list[dict] = []          # AsyncCheckpointer.records of every run
        self.history: list[dict] = []
        self._failed_once = False

    def _resume(self):
        template = self.init_state_fn()
        if self.barrier is not None:
            self.barrier()
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return 0, template
        step, state = ckpt.restore(self.cfg.ckpt_dir, template, cfg=self.cfg.arch)
        return step + 1, state

    def run(self):
        while True:
            try:
                return self._run_once()
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                # scheduler restart: a fresh process would re-enter here

    def _run_once(self):
        start, state = self._resume()
        self.starts.append(start)
        saver = ckpt.AsyncCheckpointer(self.cfg.ckpt_dir, self.cfg.keep_last_k, self.cfg.arch)
        # the save in flight finishes before a restart looks for the latest
        # step (the failure is simulated in this process: its writer thread
        # would otherwise race the restart's restore)
        try:
            for step in range(start, self.cfg.total_steps):
                if self.cfg.fail_at_step == step and not self._failed_once:
                    self._failed_once = True
                    raise SimulatedFailure(f"injected failure at step {step}")
                t0 = time.monotonic()
                state, metrics = self.train_step_fn(state, step)
                dt = time.monotonic() - t0
                if self.watch.observe(step, dt):
                    self.on_straggler(step)
                metrics = dict(metrics)
                metrics["step"] = step
                self.history.append(metrics)
                if (step + 1) % self.cfg.ckpt_every == 0:
                    saver.save_async(step, state)
        finally:
            saver.wait()
            self.saves.extend(saver.records)
        return state
