"""End-to-end training driver (port of ``examples/train_lm.py``): a
qwen1.5-family model, a few hundred steps on the deterministic synthetic
stream, with checkpointing, a mid-run simulated preemption + automatic
restart, and AAQ straight-through-estimator activation quantization.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]

Runs ``repro_torch.launch.train`` with the reference example's arguments
(the reduced config unless ``--full100m``), on the card unless
``--device cpu``; exits 1 unless the last step's loss is below the
first's.  The last line counts the kernel launches (and plain calls) of
the run.
"""
from __future__ import annotations

import argparse
import json
import tempfile

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full100m", action="store_true",
                    help="use a ~100M-param config instead of the smoke config")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory(prefix="repro_example_train") as ckpt_dir:
        train_argv = ["--arch", "qwen1.5-0.5b", "--steps", str(args.steps),
                      "--batch", "8", "--seq", "64", "--lr", "1e-3",
                      "--ckpt-dir", ckpt_dir, "--ckpt-every", "25",
                      "--fail-at", str(args.steps // 2),     # inject a preemption mid-run
                      "--aaq-ste", "--device", dev.type]
        if not args.full100m:
            train_argv.append("--reduced")
        losses = train_main(train_argv).losses
    ok = losses[-1] < losses[0]
    print("training example OK: loss decreased through a simulated preemption" if ok
          else f"FAIL: loss did not decrease ({losses[0]:.4f} -> {losses[-1]:.4f})")
    # the kernels the run launched (on the card) or their plain versions ran
    print(f"# launches {json.dumps(dispatch.launch_counts())} "
          f"plain {json.dumps(dispatch.plain_counts())}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
