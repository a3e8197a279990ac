"""Fold serving, one request at a time (port of the ``--mode ppm
--no-engine`` path of ``repro/launch/serve.py``).

Each request is bucketed, padded to its bucket edge, folded under the
chosen scheme and, with fidelity on, folded again under ``baseline_fp16``
to print the TM-score between the two.  Latency is host time around the
scheme's fold, with the card synchronised before each clock read.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode ppm --no-engine
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ppm --no-engine \
        --device cpu --n 2 --buckets 32,64

The batching engine (``EngineCore``/``FoldClient``) is not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import reduce_ppm_config
from repro_torch.core import make_scheme
from repro_torch.data.pipeline import ProteinSampler
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.ppm import init_ppm, ppm_forward, tm_score
from repro_torch.models.ppm.trunk import PPMConfig
from repro_torch.serving import bucket_for, pad_to_bucket, parse_buckets

CSV_HEADER = "request,len,bucket,latency_ms,tm_vs_fp,kernel_backend"


@dataclasses.dataclass
class FoldResult:
    request: int
    length: int
    bucket: int | None            # None: rejected, longer than every bucket
    latency_ms: float | None = None
    tm_vs_fp: float | None = None
    kernel_backend: str = ""
    coords: torch.Tensor | None = None   # (length, 3) f32 on the CPU

    def csv_row(self) -> str:
        if self.bucket is None:
            return f"{self.request},{self.length},,rejected:too-long,,"
        tm = "" if self.tm_vs_fp is None else f"{self.tm_vs_fp:.4f}"
        return (f"{self.request},{self.length},{self.bucket},"
                f"{self.latency_ms:.1f},{tm},{self.kernel_backend}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_ppm_sequential(cfg: PPMConfig, params, seqs: list[np.ndarray],
                         buckets: tuple[int, ...], *, scheme: str = "lightnobel_aaq",
                         fidelity: bool = True, device=None,
                         emit=print) -> list[FoldResult]:
    """Fold ``seqs`` one at a time on ``device`` (default CUDA) under the
    current dispatch backend; ``emit`` receives the CSV header and rows."""
    dev = resolve_device(device)
    sch = make_scheme(scheme)
    fp = make_scheme("baseline_fp16")
    backend = dispatch.describe(device=dev)
    emit(CSV_HEADER)
    results = []
    with torch.inference_mode():
        for i, seq in enumerate(seqs):
            bucket = bucket_for(buckets, len(seq))
            res = FoldResult(i, len(seq), bucket, kernel_backend=backend)
            if bucket is not None:
                aat, mask = pad_to_bucket([seq], bucket)
                aat = torch.from_numpy(aat).to(dev)
                mask = torch.from_numpy(mask).to(dev)
                _sync(dev)
                t0 = time.perf_counter()
                out = ppm_forward(params, aat, cfg, sch, mask=mask)
                _sync(dev)
                res.latency_ms = (time.perf_counter() - t0) * 1e3
                res.coords = out["coords"][0, :len(seq)].float().cpu()
                if fidelity:
                    out_fp = ppm_forward(params, aat, cfg, fp, mask=mask)
                    ref = out_fp["coords"][0, :len(seq)].float().cpu()
                    res.tm_vs_fp = float(tm_score(res.coords, ref))
            emit(res.csv_row())
            results.append(res)
    return results


def _sample_trace(n: int, min_len: int, max_len: int) -> list[np.ndarray]:
    sampler = ProteinSampler(seed=11, min_len=min_len, max_len=max_len)
    return [sampler.sample(i) for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["ppm"], default="ppm")
    ap.add_argument("--no-engine", action="store_true",
                    help="sequential serving (the only path ported so far)")
    ap.add_argument("--scheme", default="lightnobel_aaq",
                    choices=["lightnobel_aaq", "baseline_fp16"])
    ap.add_argument("--kernels", choices=list(dispatch.BACKENDS),
                    default=dispatch.AUTO,
                    help="kernel backend: the CUDA kernels, the plain "
                         "references, or auto (kernels on CUDA tensors)")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--min-len", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--buckets", default="pow2",
                    help="'pow2' or comma-separated edges, e.g. '32,64,96'")
    ap.add_argument("--no-fidelity", action="store_true",
                    help="skip the baseline_fp16 TM-score pass")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for")
    args = ap.parse_args(argv)
    if not args.no_engine:
        print("error: the batching engine is not ported yet; pass --no-engine")
        return 2
    try:
        buckets = parse_buckets(args.buckets, args.min_len, args.max_len)
    except ValueError:
        print(f"error: --buckets must be 'pow2' or comma-separated ints, "
              f"got {args.buckets!r}")
        return 2
    dev = resolve_device(args.device)
    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device=dev)
    seqs = _sample_trace(args.n, args.min_len, args.max_len)
    with dispatch.use_backend(args.kernels):
        serve_ppm_sequential(cfg, params, seqs, buckets, scheme=args.scheme,
                             fidelity=not args.no_fidelity, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
