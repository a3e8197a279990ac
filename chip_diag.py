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
coordinate gap and the TM; then, op by op, the first ops whose output
rows for that protein differ (``inputs equal`` names an op that is itself
batch-variant).  Ops run through a kernel wrapper (ctypes) do not pass the
dispatcher, so a kernel that differs shows as the next op's inputs.

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

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ins = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
            outs = [o for o in (out if isinstance(out, (list, tuple)) else [out])
                    if isinstance(o, torch.Tensor)]
            self.ops.append((str(func), [i.detach().clone() for i in ins],
                             [o.detach().clone() for o in outs]))
            return out

    def fold(seqs, route, scheme, rec=None):
        aat, mask = pad_to_bucket(seqs, 32, len(seqs))
        aat, mask = torch.from_numpy(aat).to(dev), torch.from_numpy(mask).to(dev)
        with torch.inference_mode(), dispatch.use_backend(route):
            if rec is None:
                return ppm_forward(params, aat, cfg, scheme, mask=mask,
                                   distogram=False)["coords"]
            with rec:
                return ppm_forward(params, aat, cfg, scheme, mask=mask,
                                   distogram=False)["coords"]

    def first_rows_equal(a, b):
        """``a`` of batch 1 against ``b``'s first rows of batch 4 (None where
        the shapes do not say which rows are the protein's)."""
        if a.dim() and a.dim() == b.dim() and a.shape[1:] == b.shape[1:] \
                and b.shape[0] == 4 * a.shape[0]:
            return torch.equal(a, b[:a.shape[0]])
        return None

    n0 = len(trace[0])
    for route in ("auto", "ref"):
        for name, scheme in schemes.items():
            c1 = fold([trace[0]], route, scheme)[0, :n0].float().cpu()
            c4 = fold(batch4, route, scheme)[0, :n0].float().cpu()
            _print(f"fold {route} {name}: batch-1 coords bitwise batch-4's: "
                   f"{torch.equal(c1, c4)}, max |d| {(c1 - c4).abs().max().item():.3e}, "
                   f"TM {float(tm_score(c1, c4)):.6f}")
        r1, r4 = Record(), Record()
        fold([trace[0]], route, schemes["aaq"], r1)
        fold(batch4, route, schemes["aaq"], r4)
        _print(f"{route}: {len(r1.ops)} ops at batch 1, {len(r4.ops)} at batch 4")
        shown = 0
        for i, ((f1, i1, o1), (f4, i4, o4)) in enumerate(zip(r1.ops, r4.ops)):
            if f1 != f4:
                _print(f"  op {i}: the op sequences part: {f1} against {f4}")
                break
            if "empty" in f1:               # uninitialised memory: no value to compare
                continue
            ins_eq = [first_rows_equal(a, b) for a, b in zip(i1, i4)]
            if any(first_rows_equal(a, b) is False for a, b in zip(o1, o4)):
                why = "inputs equal" if False not in ins_eq else "inputs differ"
                _print(f"  op {i} {f1}: output rows differ ({why}); inputs "
                       f"{[(tuple(a.shape), str(a.dtype)) for a in i4]} equal {ins_eq}")
                shown += 1
                if shown == 6:
                    break


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
