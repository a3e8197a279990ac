"""Quickstart: fold a protein with and without AAQ, compare structures
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Demonstrates the paper's headline claim at laptop scale: Token-wise
Adaptive Activation Quantization compresses every Pair-Representation
activation to ~4-8 bits (vs 16) while the predicted structure stays
essentially identical (Delta-TM ~ 0).  Runs on the card unless
``--device cpu``; exits 1 if the AAQ fold falls below TM 0.9 against the
unquantized one.  The last line counts the kernel launches (and plain
calls) of the two folds.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

from repro_torch.configs import reduce_ppm_config
from repro_torch.core import make_scheme
from repro_torch.core.policy import AAQConfig
from repro_torch.data.pipeline import ProteinSampler
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.ppm import init_ppm, ppm_forward, tm_score
from repro_torch.models.ppm.model import pair_activation_inventory

#: the three policy groups, one site each
GROUP_SITES = ("tri_mul_out.pre_ln", "tri_attn_start.post_ln", "tri_mul_out.gate")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device=dev)
    seq = ProteinSampler(seed=3).sample(0, length=40)
    aatype = torch.from_numpy(seq)[None].to(dev)
    print(f"protein: {len(seq)} residues on {dev}")

    aaq = make_scheme("lightnobel_aaq")
    with torch.inference_mode():
        out_fp = ppm_forward(params, aatype, cfg)                # the unquantized reference
        out_q = ppm_forward(params, aatype, cfg, aaq)            # the AAQ dataflow
    tm = float(tm_score(out_q["coords"][0].float().cpu(), out_fp["coords"][0].float().cpu()))
    print(f"TM-score(AAQ vs FP) = {tm:.4f}   (paper: Delta-TM < 0.001)")

    # memory story: bits per stored activation value in the pair dataflow
    inv = pair_activation_inventory(cfg, ns=len(seq))
    fp_bits = sum(math.prod(s) * 16 for _, s in inv)
    q_bits = sum(math.prod(s) * aaq.act_bits(site, s[-1]) for site, s in inv)
    print(f"pair-activation footprint: {fp_bits / 8 / 1e6:.2f} MB (fp16) -> "
          f"{q_bits / 8 / 1e6:.2f} MB (AAQ)  [{fp_bits / q_bits:.2f}x smaller]")

    # the three policy groups in action
    for site in GROUP_SITES:
        pol = AAQConfig().policy_for(site)
        print(f"  {site:28s} -> Group {pol.name}: INT{pol.bits}"
              f" + {pol.k_outliers} outliers")
    assert fp_bits > q_bits
    # the kernels the folds launched (on the card) or their plain versions ran
    print(f"# launches {json.dumps(dispatch.launch_counts())} "
          f"plain {json.dumps(dispatch.plain_counts())}")
    return 0 if tm >= 0.9 else 1


if __name__ == "__main__":
    raise SystemExit(main())
