#!/usr/bin/env python3
"""Two diagnostics of the port, on the card (or, smaller, on the CPU).

    python3 chip_diag.py batch     # where a fold stops being batch-invariant
    python3 chip_diag.py dryrun    # a dry-run cell's FLOPs by aten op

``batch``: the two float32 kernel variants alone (``aaq_matmul_f32`` on
batch 1's rows against batch 4's, ``flash_mha_simt`` on batch row 0),
then the reduced config's fold of ``examples/fold_server``'s first protein
(26 residues, bucket 32) alone against the same protein in act one's
batch of 4, under AAQ and the unquantized scheme, on the kernel route
(``auto``) and the plain route (``ref``): bitwise or not, the largest
coordinate gap and the TM; and for each, every op of the batch-4 fold run
again on the first quarter of its inputs' rows (dim 0, where an input's
dim 0 is the output's): an op whose output's first quarter then differs
follows the row count in itself, whatever its inputs.  Ops run through a
kernel wrapper (ctypes) do not pass the dispatcher.  All of it twice:
with the fold's float32 products a batch row at a time
(``device.rows_alone``, as the fold runs) and without.

``dryrun``: ``launch.dryrun.lower_cell`` of qwen1.5-0.5b x train_4k on the
fake 16 x 16 mesh at 1 and 2 layers (vocabulary 4,096) and at 1 layer
(vocabulary 32,768), each device's FLOPs by aten op: the count is exactly
linear in both, which gives the whole cell's; with a card, the whole cell
(24 layers, 151,936) traced as well.  The fake tensors sit on the card
where there is one, so it compares the card's PyTorch with the CPU's.

Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def _print(*a) -> None:
    print(*a, flush=True)


def batch(torch) -> None:
    import contextlib
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import reduce_ppm_config
    from repro_torch.core.schemes import make_scheme
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel
    from repro_torch.kernels.flash_attention.flash_attention import flash_mha_kernel
    from repro_torch.models.ppm import init_ppm, tm_score
    from repro_torch.models.ppm.model import ppm_forward
    from repro_torch.serving.types import pad_to_bucket
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    g = torch.Generator(device="cpu").manual_seed(0)
    t, h, d = 4 * 32 * 32, 32, 64
    for bits in (4, 8):
        hp = h // 2 if bits == 4 else h
        q = torch.randint(-128, 127, (t, hp), generator=g, dtype=torch.int8).to(dev)
        sc = torch.rand(t, 1, generator=g).to(dev)
        ov = torch.randn(t, 4, generator=g).to(torch.bfloat16).to(dev)
        oi = torch.randint(0, h, (t, 4), generator=g, dtype=torch.int32).to(dev)
        w = torch.randn(h, d, generator=g).to(dev)
        y4 = aaq_matmul_kernel(q, sc, ov, oi, w, bits=bits)
        n = t // 4
        y1 = aaq_matmul_kernel(q[:n].contiguous(), sc[:n].contiguous(), ov[:n].contiguous(),
                               oi[:n].contiguous(), w, bits=bits)
        _print(f"aaq_matmul_f32 bits {bits}: rows of batch 1 bitwise batch 4's: "
               f"{torch.equal(y1, y4[:n])}")
    for hd in (8, 16, 32):
        b, s, hh = 4, 32, 4
        qq, kk, vv = (torch.randn(b, s, hh, hd, generator=g).to(dev) for _ in range(3))
        bias = torch.randn(b, hh, s, s, generator=g).to(dev)
        kvl = torch.tensor([26, 24, 26, 32], dtype=torch.int32).to(dev)
        o4 = flash_mha_kernel(qq, kk, vv, bias, kvl)
        o1 = flash_mha_kernel(qq[:1], kk[:1], vv[:1], bias[:1], kvl[:1])
        _print(f"flash_mha_simt D={hd}: batch 1 bitwise batch 4's row: "
               f"{torch.equal(o1, o4[:1])}")

    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device=dev)
    sampler = ProteinSampler(seed=11, min_len=24, max_len=48)
    trace = [sampler.sample(i) for i in range(6)]
    batch4 = [trace[i] for i in (0, 2, 3, 4)]           # act one's batch of bucket 32
    schemes = {"aaq": make_scheme("lightnobel_aaq"), "fp": make_scheme("baseline_fp16")}

    def fold(seqs, route, scheme, mode=None):
        aat, mask = pad_to_bucket(seqs, 32, len(seqs))
        aat, mask = torch.from_numpy(aat).to(dev), torch.from_numpy(mask).to(dev)
        with torch.inference_mode(), dispatch.use_backend(route), \
                mode if mode is not None else contextlib.nullcontext():
            return ppm_forward(params, aat, cfg, scheme, mask=mask, distogram=False)["coords"]

    class Intrinsic(TorchDispatchMode):
        """Each op again on the first quarter of its rows (dim 0)."""

        def __init__(self):
            super().__init__()
            self.ops, self.variant = 0, {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = str(func)
            if (not isinstance(out, torch.Tensor) or not out.is_floating_point()
                    or out.dim() == 0 or out.shape[0] % 4 or "empty" in name
                    or func._schema.is_mutable or any(r.alias_info is not None
                                                      for r in func._schema.returns)):
                return out
            q = out.shape[0] // 4
            rows = [isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == out.shape[0]
                    for a in args]
            if not any(rows):
                return out
            self.ops += 1
            part = func(*(a[:q] if r else a for a, r in zip(args, rows)), **kwargs)
            if not torch.equal(part, out[:q]):
                key = (name, tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)),
                       str(out.dtype))
                self.variant[key] = self.variant.get(key, 0) + 1
            return out

    from repro_torch import device as dev_mod
    from repro_torch.models.ppm import model as ppm_model
    n0 = len(trace[0])
    for alone in (True, False):
        ppm_model.rows_alone = dev_mod.rows_alone if alone else contextlib.nullcontext
        _print(f"-- a float32 fold's products a batch row at a time (rows_alone): {alone}")
        for route in ("auto", "ref"):
            for name, scheme in schemes.items():
                c1 = fold([trace[0]], route, scheme)[0, :n0].float().cpu()
                c4 = fold(batch4, route, scheme)[0, :n0].float().cpu()
                _print(f"fold {route} {name}: batch-1 coords bitwise batch-4's: "
                       f"{torch.equal(c1, c4)}, max |d| {(c1 - c4).abs().max().item():.3e}, "
                       f"TM {float(tm_score(c1, c4)):.6f}")
                mode = Intrinsic()
                fold(batch4, route, scheme, mode)
                _print(f"  {route} {name}, batch 4: {mode.ops} ops run again on their first "
                       f"quarter; {len(mode.variant)} kinds of op differ in themselves"
                       + "".join(f"\n    {op} {dt} inputs {shapes}: {n} calls"
                                 for (op, shapes, dt), n in sorted(mode.variant.items())))
    ppm_model.rows_alone = dev_mod.rows_alone


def dryrun_flops(torch) -> None:
    from repro_torch.configs import get_config, shapes_for
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch import dryrun
    modes = []

    class Counting(ca.CostMode):
        def __init__(self):
            super().__init__()
            modes.append(self)

    ca.CostMode = Counting
    shape = next(s for s in shapes_for("qwen1.5-0.5b") if s.name == "train_4k")
    cells = [(1, 4096), (2, 4096), (1, 32768)]
    if torch.cuda.is_available():
        cells.append((None, None))
    for layers, vocab in cells:
        cfg = get_config("qwen1.5-0.5b")
        if layers:
            cfg = cfg.replace(layers=layers, vocab=vocab)
        t0 = time.perf_counter()
        rec = dryrun.lower_cell("qwen1.5-0.5b", shape, cfg=cfg)
        by_op = {k: f"{v:.0f}" for k, v in sorted(modes[-1].flops_by_op.items())}
        _print(f"dryrun torch {torch.__version__} on {rec['device']}, {cfg.layers} layers, "
               f"vocabulary {cfg.vocab}: flops/dev {rec['cost']['flops_per_dev']:.0f} by op "
               f"{by_op}; widened copies {rec['cost']['widen_bytes_per_dev']:.0f} B; "
               f"collectives {rec['collectives']['counts']}; peak "
               f"{rec['mem']['peak_bytes_per_dev']} B; {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="diagnostics of the port")
    ap.add_argument("what", choices=("batch", "dryrun"))
    args = ap.parse_args(argv)
    import torch
    if torch.cuda.is_available():
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        _print(f"card: {smi}; torch {torch.__version__}")
    (batch if args.what == "batch" else dryrun_flops)(torch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
