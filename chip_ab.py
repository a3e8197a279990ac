#!/usr/bin/env python3
"""Time one phase-3 check of ``chip_smoke.py`` in two checkouts on one card,
in turns: base, change, change, base.

    python3 chip_ab.py BASE_DIR [CHANGE_DIR] [--check check_quantize]

BASE_DIR and CHANGE_DIR (default: this checkout) each hold a ``chip_smoke.py``
and ``src/repro_torch``; unpack an older commit with ``git archive`` into an
ignored directory to compare against it.  Each turn runs in its own process,
which builds that checkout's kernels under its own ``build/`` directory,
runs the named check (its correctness checks included) and prints its
kernel rows.  The last line is one JSON object: for every (checkout, kernel,
shape), the ``kernel_ms`` and ``call_ms`` of each turn.  Needs one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_TURN = r"""
import dataclasses, json, sys
sys.path.insert(0, {root!r})
import chip_smoke
sys.path.insert(0, str(chip_smoke.SRC))
import torch
from repro_torch.kernels import build
build.library()
rows = {{}}
chip_smoke.{check}(torch, rows)
for name, rs in rows.items():
    for r in rs:
        print("ROW " + json.dumps(dataclasses.asdict(r)), flush=True)
"""


def turn(root: Path, check: str) -> list[dict]:
    out = subprocess.run([sys.executable, "-c", _TURN.format(root=str(root), check=check)],
                         capture_output=True, text=True, cwd=str(root))
    sys.stderr.write(out.stderr[-4000:])
    if out.returncode:
        print(out.stdout[-4000:])
        raise SystemExit(f"FAIL: {check} in {root} exited with {out.returncode}")
    return [json.loads(line[4:]) for line in out.stdout.splitlines() if line.startswith("ROW ")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("change", type=Path, nargs="?", default=Path(__file__).resolve().parent)
    ap.add_argument("--check", default="check_quantize")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    result: dict[str, dict] = {}
    for label, root in (("base", args.base), ("change", args.change),
                        ("change", args.change), ("base", args.base)):
        for r in turn(root.resolve(), args.check):
            key = f"{label} {r['name']} [{r['shape']}]"
            entry = result.setdefault(key, {"kernel_ms": [], "call_ms": []})
            entry["kernel_ms"].append(r["ms"])
            entry["call_ms"].append(r["call_ms"])
            print(f"{key}: kernel_ms={r['ms']:.4f} call_ms={r['call_ms']:.4f}", flush=True)
    print(json.dumps({"card": smi, "check": args.check, "turns": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
