"""Device meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``), and the ranks of a serving mesh.

``make_mesh(shape, axes)`` builds a ``DeviceMesh`` over the initialised
default process group (one process a rank, as torch runs); it raises
unless the group has exactly that many ranks, so ``make_production_mesh``
(the reference's 16 x 16 pod, or 2 x 16 x 16) raises anywhere but on 256
(512) ranks.  Functions, not module constants: importing this module
touches no process group.

``start_ranks`` starts ranks 1..W-1 of a ``serving.placement.ServingMesh``
as processes of this module (``python -m repro_torch.launch.mesh --rank
r ...``) that meet rank 0 at a ``file://`` rendezvous and run the engine's
worker loop (``serving.engine.serve_worker``) until rank 0 sends
``exit``.  The compute groups time out after ``TIMEOUT_S`` (a rank that
died fails its peers' collectives instead of hanging them); a started rank
also leaves when the process that started it is gone.

Training ranks (``launch.train --model-parallel``) start the same way:
``training_world`` counts them (every card on CUDA, one a card, and more
ranks than cards refused with "needs N devices"; M on the CPU),
``start_train_ranks`` starts ranks 1..W-1 as ``python -m
repro_torch.launch.train`` with the caller's arguments, and
``init_train_group`` joins one (NCCL on the card, one card a rank; gloo on
the CPU).
"""
from __future__ import annotations

import argparse
import datetime
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: the directory that holds the ``repro_torch`` package (a started rank's
#: PYTHONPATH)
SRC = Path(__file__).resolve().parents[2]
#: seconds a collective of the compute groups waits for its peers
TIMEOUT_S = 300.0


def _axis_type(device_type: str | None) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group,
    rank r at position r in row-major order."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs an initialised process group "
                           f"of {n} ranks (torchrun, or launch.mesh.init_group)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process group "
                           f"has {dist.get_world_size()}")
    return DeviceMesh(_axis_type(device_type), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_host_mesh(model: int | None = None):
    """(world / model, model) over every rank of the group."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = model or 1
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    return make_mesh((n // model, model), ("data", "model"))


# --------------------------------------------------------------------------
# the ranks of a serving mesh
# --------------------------------------------------------------------------
def rendezvous():
    """(its directory, to remove at close; the init method): a fresh
    ``file://`` rendezvous."""
    d = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    return d, f"file://{d}/rendezvous"


def _backend(route: str) -> str:
    return "cpu:gloo,cuda:nccl" if route == "nccl" else "gloo"


def init_group(mesh, rank: int, init_method: str, device: torch.device) -> None:
    """Join ``mesh``'s process group as ``rank``."""
    dev = mesh.rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(mesh.route), init_method=init_method,
                            rank=rank, world_size=mesh.size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def start_ranks(mesh, device: torch.device, init_method: str) -> list:
    """Start ranks 1..size-1 of ``mesh`` as processes of this module."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH", "")) if p)
    argv = [sys.executable, "-m", "repro_torch.launch.mesh",
            "--data", str(mesh.shape["data"]),
            "--model", str(mesh.shape["model"]), "--init", init_method,
            "--route", mesh.route, "--device", device.type,
            "--threads", str(torch.get_num_threads()),
            "--parent", str(os.getpid())]
    return [subprocess.Popen([*argv, "--rank", str(r)], env=env)
            for r in range(1, mesh.size)]


def stop_ranks(procs: list, timeout_s: float = 60.0) -> None:
    """Wait for started ranks to leave; kill any still there after
    ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _watch_parent(pid: int) -> None:
    """Leave when the process that started this rank is gone."""
    def watch():
        while True:
            if os.getppid() != pid:
                os._exit(3)
            time.sleep(1.0)
    threading.Thread(target=watch, daemon=True, name="parent-watch").start()


# --------------------------------------------------------------------------
# the ranks of a training mesh
# --------------------------------------------------------------------------
def training_world(model: int, device_type: str) -> int:
    """Ranks a ``--model-parallel model`` run takes when no group exists:
    every card on CUDA (one rank a card; fewer cards than ``model`` is
    refused), ``model`` ranks on the CPU."""
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if model > cards:
            raise ValueError(f"--model-parallel {model} needs {model} devices but only "
                             f"{cards} visible (one process a rank, one card a rank: NCCL "
                             f"refuses two ranks on one card)")
        return cards - cards % model
    return model


def init_train_group(rank: int, world: int, init_method: str, device_type: str) -> None:
    """Join a training mesh's group as ``rank``: on CUDA card ``rank`` over
    NCCL (gloo beside it for host barriers), on the CPU gloo."""
    backend = "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def start_train_ranks(world: int, argv: list[str], init_method: str) -> list:
    """Start ranks 1..world-1 of a training run as ``python -m
    repro_torch.launch.train <argv>``, each told its rank and the
    rendezvous; each leaves when its parent is gone."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH", "")) if p)
    base = [sys.executable, "-m", "repro_torch.launch.train", *argv,
            "--world", str(world), "--init", init_method,
            "--threads", str(torch.get_num_threads()), "--parent", str(os.getpid())]
    return [subprocess.Popen([*base, "--rank", str(r)], env=env) for r in range(1, world)]


def parser() -> argparse.ArgumentParser:
    """The rank worker's flags (``main``); ``--device`` defaults to the
    card, as every entry point of the port does."""
    ap = argparse.ArgumentParser(description="one rank of a serving mesh")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--data", type=int, required=True)
    ap.add_argument("--model", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--route", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--parent", type=int, default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.parent:
        _watch_parent(args.parent)
    if args.threads:
        torch.set_num_threads(args.threads)
    from repro_torch.serving.engine import serve_worker
    from repro_torch.serving.placement import ServingMesh
    mesh = ServingMesh(args.data, args.model)
    mesh.route = args.route
    device = resolve_device(args.device)
    init_group(mesh, args.rank, args.init, device)
    mesh._setup(device)
    serve_worker(mesh)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
