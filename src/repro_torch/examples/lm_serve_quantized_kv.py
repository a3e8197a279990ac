"""Batched LM decode with the AAQ-quantized KV cache (port of
``examples/lm_serve_quantized_kv.py``): the KV cache is the decode
bandwidth bottleneck, and LightNobel's token-wise quantizer cuts its bytes
to the scheme's bits per value with a small logit drift.

Serves the SAME prompt trace twice through ``LMClient`` (continuous
per-token batching, admission priced in KV bytes, the fold stack's
handle/event lifecycle): once with an fp16 KV cache, once with the KV site
AAQ-quantized.  Prints per-request KV bytes for both schemes, the
compression ratio, and the max first-generated-token logit drift; exits
nonzero if the drift exceeds ``--drift-tol`` (the LM workload's gate).

    PYTHONPATH=src python -m repro_torch.examples.lm_serve_quantized_kv [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.lm_serve_quantized_kv \\
        --n 8 --tokens 24 --drift-tol 0.25

The reference example's reduced float32 config, window 64 and prompts
from ``default_rng(11)``, random weights from seed 0; on the card unless
``--device cpu``.  The last line counts the kernel launches (and plain
calls) of both runs.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import lm
from repro_torch.serving import LM_CSV_HEADER, LMClient, lm_csv_row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--n", type=int, default=6, help="requests in the trace")
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--tokens", type=int, default=16, help="max_new_tokens")
    ap.add_argument("--window", type=int, default=64, help="ring KV window")
    ap.add_argument("--drift-tol", type=float, default=0.25,
                    help="max tolerated |logits_first(AAQ) - logits_first(fp16)|")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduce_config(get_config(args.arch)).replace(dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 17))).astype(np.int32)
               for _ in range(args.n)]

    runs = {}
    for scheme in ("baseline_fp16", "lightnobel_aaq"):
        client = LMClient(params, cfg, scheme, window=args.window, max_slots=args.batch,
                          default_max_new_tokens=args.tokens, device=dev)
        adm = client.core.admission
        print(f"-- {scheme} KV cache ({adm.bits_per_value:.1f} bits/value, "
              f"{adm.bytes_per_request} KV bytes/request) --")
        results = client.run(prompts)
        print(LM_CSV_HEADER)
        for r in results:
            print(lm_csv_row(r))
        s = client.metrics.summary()
        if s["served"] != args.n:
            print(f"FAIL: {scheme} served {s['served']} of {args.n}: {s}")
            return 1
        runs[scheme] = (adm.bytes_per_request, results)

    fp16_bytes, fp16_res = runs["baseline_fp16"]
    aaq_bytes, aaq_res = runs["lightnobel_aaq"]

    # identical greedy traces modulo quantization: compare the logits of the
    # first generated position per request, the step where prompt context
    # (everything that sat in the quantized cache) fully determines the output
    drift = max(float(np.max(np.abs(a.logits_first - f.logits_first)))
                for a, f in zip(aaq_res, fp16_res))
    agree = sum(int(np.array_equal(a.tokens, f.tokens)) for a, f in zip(aaq_res, fp16_res))

    print(f"kv_bytes_per_request fp16={fp16_bytes} aaq={aaq_bytes} "
          f"ratio={fp16_bytes / aaq_bytes:.2f}x")
    print(f"max |logits_first(aaq) - logits_first(fp16)| = {drift:.4e} "
          f"(tol {args.drift_tol:.2e}); identical token streams: {agree}/{args.n}")
    ok = drift <= args.drift_tol
    print("OK" if ok else f"FAIL: quantized-KV drift {drift:.4e} exceeds tolerance")
    # the kernels both runs launched (on the card) or their plain versions ran
    print(f"# launches {json.dumps(dispatch.launch_counts())} "
          f"plain {json.dumps(dispatch.plain_counts())}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
