"""Fold and LM-decode serving (port of ``repro/launch/serve.py``).

By default requests are served through the request-lifecycle
``FoldClient``: ``submit()`` returns handles with priorities
(``--priority-split``) and deadlines (``--deadline-s``), and batches run on
the bucketed ``EngineCore`` (one CUDA graph per (bucket, launch batch,
scheme, placement, chunk) key on the card, a dispatch/retire ring of
``--inflight-depth``, occupancy-fitted launch sizes, token-budget batching
with fill-or-timeout ``--batch-linger-ms``, AAQ-aware admission and the
long-fold chunk planner ``--chunk-size``), pumped inline or by a
background thread (``--driver``).  ``--no-engine`` folds one request at a
time: each request is bucketed, padded to its bucket edge, folded under
the chosen scheme and, with fidelity on, again under ``baseline_fp16`` for
the TM-score between the two.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode ppm
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ppm \
        --device cpu --n 4 --buckets 32,64 --max-batch 3
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ppm --no-engine \
        --device cpu --n 2 --buckets 32,64

``--listen HOST:PORT`` switches into a network server: an HTTP front-end
(``FoldHTTPServer``) over a ``--replicas``-wide fleet of engine replicas
(one ``FoldClient`` and driver thread each, sharing one copy of the
weights) routed on live telemetry, with a per-replica restart budget
(``--max-restarts``).  It ignores ``--n``, serves until SIGTERM/SIGINT or
``--serve-for-s``, and prints the bound address as ``# listening ...``
(port 0 binds an ephemeral port):

    PYTHONPATH=src python -m repro_torch.launch.serve --mode ppm --device cpu \
        --listen 127.0.0.1:0 --replicas 2 --buckets 32,48 --no-fidelity

``--mode lm`` serves the LM decode tenant (``LMClient``: continuous
per-token batching over ``--batch`` slots, a ``--window``-row KV ring,
AAQ-quantized with ``--quant-kv``) on the ``--arch`` dense config with
random weights from seed 0: at full width on the card, reduced to float32
on the CPU.  With ``--listen`` the fleet answers ``POST /v1/generate``:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --device cpu \
        --n 6 --tokens 8 --window 64 --quant-kv --drift-tol 0.25
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --quant-kv \
        --arch qwen1.5-0.5b --window 256 --batch 4 --tokens 16

``--metrics-port`` serves the engine's Prometheus ``/metrics`` (and
``/metrics.json``, ``/healthz``) while a trace is served.

``--profile DIR`` (the counterpart of the reference's ``--jax-profile``)
writes a ``torch.profiler`` Chrome trace of the engine's serving window
into DIR: the engine's ``serve.dispatch/<bucket>`` and
``serve.retire/<bucket>`` ranges beside the kernels they launched (open it
at ui.perfetto.dev, or point TensorBoard's profiler plugin at DIR):

    PYTHONPATH=src python -m repro_torch.launch.serve --mode ppm --device cpu \
        --n 3 --profile build/profile

``--mesh DxM --shard-threshold T`` serves buckets of T and above on a
(data, model) mesh with the pair tensor split on j over the M model ranks
(``serving.placement``), and the rest on rank 0 alone; the two flags go
together.  Alone, the command starts its other ranks itself (one process
each, gloo on the CPU; on the card NCCL, one card a rank: a mesh larger
than the visible cards exits 2 with "needs N devices"); under
``torchrun`` it uses the group it is given, rank 0 serving and the others
running the worker loop:

    PYTHONPATH=src python -m repro_torch.launch.serve --mode ppm --device cpu \
        --n 4 --buckets 32,64 --mesh 1x2 --shard-threshold 64
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config, reduce_ppm_config
from repro_torch.core import SCHEMES, make_scheme
from repro_torch.data.pipeline import ProteinSampler
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import lm
from repro_torch.models.ppm import init_ppm, ppm_forward, tm_score
from repro_torch.models.ppm.trunk import PPMConfig
from repro_torch.serving import (CSV_HEADER as ENGINE_CSV_HEADER, LM_CSV_HEADER,
                                 FleetRouter, FoldClient, FoldHTTPServer, LMClient,
                                 MetricsServer, lm_csv_row,
                                 bucket_for, calibrate, csv_row, load_cost_table,
                                 pad_to_bucket, parse_buckets, parse_chunk_spec,
                                 pipeline_overlaps, profile)
from repro_torch.serving.engine import serve_worker
from repro_torch.serving.observability import parse_hostport
from repro_torch.serving.placement import make_serving_mesh

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


def priority_tiers(n: int, split: float) -> list[int]:
    """Deterministic two-tier assignment: a ``split`` fraction of requests
    (interleaved, not front-loaded) get priority 1, the rest 0."""
    split = min(max(split, 0.0), 1.0)
    return [1 if int((i + 1) * split) > int(i * split) else 0
            for i in range(n)]


def _make_client(args, cfg, params, buckets, dev, cost_model=None,
                 mesh=None) -> FoldClient:
    return FoldClient(
        params, cfg, args.scheme, buckets=buckets,
        max_tokens_per_batch=args.max_tokens_per_batch,
        max_batch=args.max_batch, mem_budget_mb=args.mem_budget_mb,
        fidelity=not args.no_fidelity, kernels=args.kernels,
        mesh=mesh, shard_threshold=None if mesh is None else args.shard_threshold,
        inflight_depth=args.inflight_depth,
        linger_ms=args.batch_linger_ms,
        adaptive_linger=not args.no_adaptive_linger,
        chunk_size=args.chunk_size, cost_model=cost_model, device=dev)


def fold_replica_factory(args, cfg, params, buckets, dev, mesh=None):
    """The fleet's replica factory (``i -> FoldClient``) of ``--listen``:
    each replica its own FoldClient on ``dev``, all on the one copy of
    ``params``.  With ``mesh`` (bound by the caller) every replica opens
    its own engine on that one mesh, as the reference's replicas all span
    the same first D*M devices: a fleet takes D*M ranks whatever
    ``--replicas`` is, and a rebuilt replica opens a new engine on the
    same ranks (the old one is closed on every rank when the fleet
    releases its client).  No client closes the mesh: its maker does, once
    the fleet has stopped."""
    def factory(i: int) -> FoldClient:
        # each replica binds its own copy of the persisted cost table (a
        # CostModel is bound to exactly one core)
        cost_model = (load_cost_table(args.cost_table)
                      if args.cost_table else None)
        client = _make_client(args, cfg, params, buckets, dev, cost_model, mesh)
        client.tracer.set_metadata(
            replica=i, scheme=args.scheme,
            kernels=dispatch.describe(args.kernels, device=dev),
            buckets=list(buckets), inflight_depth=args.inflight_depth,
            device=str(dev), **client.core.placement.describe(),
            **client.core.chunk.describe())
        if cost_model is not None:
            client.core.warmup_from_table()
        if args.warmup:
            client.warmup()
        return client

    return factory


def serve_http(args, cfg, params, buckets, dev, mesh=None) -> int:
    """Network server mode (``--listen``): a FoldHTTPServer over a
    ``--replicas``-wide FleetRouter of ``fold_replica_factory``'s clients
    (on ``mesh`` when given), up until SIGTERM/SIGINT (or
    ``--serve-for-s``); the router balances on live queue-depth/in-flight
    telemetry scraped from the replicas' registries."""
    try:
        host, port = parse_hostport(args.listen)
        if args.cost_table:
            load_cost_table(args.cost_table)   # fail loudly before binding
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}")
        return 2
    factory = fold_replica_factory(args, cfg, params, buckets, dev, mesh)
    return _run_fleet(args, factory, host, port,
                      f"replicas={args.replicas} buckets={','.join(map(str, buckets))} "
                      f"kernels={dispatch.describe(args.kernels, device=dev)}"
                      + ("" if mesh is None else f" {mesh.label}"),
                      lambda r, s: f"compiles={s['compiles']}")


def _run_fleet(args, factory, host, port, banner: str, summary) -> int:
    """Serve a ``--replicas``-wide fleet of ``factory``'s clients over HTTP
    until SIGTERM/SIGINT (or ``--serve-for-s``), then drain it and print one
    line per replica (ending in ``summary(replica, metrics summary)``)."""
    import signal
    import threading

    router = FleetRouter(factory, args.replicas, max_restarts=args.max_restarts)
    server = None
    try:
        server = FoldHTTPServer(router, port=port, host=host).start()
        # launchers scrape THIS line for the bound address (--listen HOST:0
        # binds an ephemeral port)
        print(f"# listening {server.url} {banner}", flush=True)
        done = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: done.set())
        try:
            done.wait(args.serve_for_s if args.serve_for_s > 0 else None)
        except KeyboardInterrupt:
            pass
        print("# shutting down", flush=True)
        server.stop()
        router.stop(drain=True)
        for r in router.replicas:
            s = r.client.metrics.summary()
            print(f"# replica={r.index} served={s['served']}/{s['requests']} "
                  f"rejected={s['rejected']} expired={s['expired']} "
                  f"cancelled={s['cancelled']} {summary(r, s)}")
        if args.trace_out:
            stem = args.trace_out[:-5] if args.trace_out.endswith(".json") \
                else args.trace_out
            for path in router.save_traces(stem):
                print(f"# trace -> {path}")
    finally:
        # release every replica's engine (its graphs, and on a mesh its
        # engine on every rank) before the caller closes the mesh, on every
        # way out: a communicator is not torn down under graphs that
        # captured its collectives
        if server is not None:
            server.stop()
        router.stop(drain=False)
        for r in router.replicas:
            r.client.close()
    print("# fleet shutdown complete", flush=True)
    return 0


def serve_ppm_engine(args, cfg, params, seqs, buckets, dev, mesh=None) -> int:
    """Serve ``seqs`` through ``FoldClient`` on ``dev`` (sharding buckets
    of ``--shard-threshold`` and above over ``mesh``); prints the CSV of
    every request and ``#`` summary lines."""
    cost_model = None
    if args.cost_table and not args.calibrate:
        try:
            cost_model = load_cost_table(args.cost_table)
        except (FileNotFoundError, ValueError) as e:
            print(f"error: {e}")
            return 2
    client = _make_client(args, cfg, params, buckets, dev, cost_model, mesh)
    client.tracer.set_metadata(
        scheme=args.scheme, kernels=dispatch.describe(args.kernels, device=dev),
        buckets=list(buckets), inflight_depth=args.inflight_depth,
        device=str(dev), **client.core.placement.describe(),
        **client.core.chunk.describe())
    server = None
    if args.metrics_port is not None:
        server = MetricsServer(client, port=args.metrics_port).start()
        print(f"# metrics endpoint {server.url}/metrics", flush=True)
    cm = client.core.cost_model
    if args.calibrate:
        calibrate(client.core)
        print(f"# calibrated entries={cm.entry_count}", flush=True)
    elif cost_model is not None:
        warmed = client.core.warmup_from_table()
        print(f"# cost table loaded {args.cost_table} "
              f"entries={cm.entry_count} calibrated={cm.calibrated_count} "
              f"warmed={warmed} executables", flush=True)
    if args.warmup:
        client.warmup()
    client.metrics.record_cost_table(cm.entry_count, cm.calibrated_count,
                                     cm.age_s())
    # everything the table (or warmup) captured is warm; serving on top of
    # it must add no capture
    warm_compiles = client.core.compile_count
    tiers = priority_tiers(len(seqs), args.priority_split)
    t0 = time.perf_counter()
    with profile(args.profile):
        if args.driver == "thread":
            client.start()
        handles = [client.submit(s, priority=p, deadline_s=args.deadline_s)
                   for s, p in zip(seqs, tiers)]
        if args.driver == "thread":
            for h in handles:
                if not h.done:
                    h.result(timeout=600.0)
            client.stop()
        else:
            client.drive()
    client.metrics.wall_s = time.perf_counter() - t0
    results = sorted(client.metrics.results, key=lambda r: r.request_id)
    print(ENGINE_CSV_HEADER)
    for r in results:
        print(csv_row(r))
    s = client.metrics.summary()
    chunks = sorted({r.chunk_size for r in results if r.ok})
    print(f"# served={s['served']}/{s['requests']} "
          f"rejected={s['rejected']} expired={s['expired']} "
          f"compiles={s['compiles']} "
          f"req/s={s['requests_per_s']:.2f} tok/s={s['tokens_per_s']:.1f} "
          f"kernels={dispatch.describe(args.kernels, device=dev)} "
          f"chunks={'/'.join(str(c) for c in chunks) or 'none'} "
          f"max_est_act_mb={s['max_est_act_mb']:.1f}"
          + (f" budget_mb={args.mem_budget_mb:.1f}"
             if args.mem_budget_mb else ""))
    print(f"# queue_wait_ms p50={s['queue_wait_ms']['p50']:.1f} "
          f"p95={s['queue_wait_ms']['p95']:.1f} "
          f"p99={s['queue_wait_ms']['p99']:.1f} "
          f"| run_ms p50={s['run_ms']['p50']:.1f} "
          f"p95={s['run_ms']['p95']:.1f} p99={s['run_ms']['p99']:.1f}")
    p = s["pipeline"]
    print(f"# pipeline inflight_depth={p['inflight_depth']} "
          f"max_inflight={p['max_inflight']} batches={p['batches']} "
          f"mean_occupancy={p['mean_batch_occupancy']:.3f} "
          f"linger_ms={p['linger_ms']:.0f} linger_holds={p['linger_holds']}")
    c = s["cost_model"]
    print(f"# cost_model entries={c['table_entries']} "
          f"calibrated={c['table_calibrated']} "
          f"predictions={c['predictions']} "
          f"pred_err_p50={c['prediction_error']['p50']:.2f} "
          f"bad_holds={c['linger_bad_holds']} "
          f"infeasible={sum(c['infeasible'].values())} "
          f"adaptive_linger={'off' if args.no_adaptive_linger else 'on'} "
          f"post_warmup_compiles={client.core.compile_count - warm_compiles}")
    pool = client.core.pool_reserved_bytes()
    print(f"# engine device={dev} captures={client.core.compile_count} "
          f"pool_reserved_mb="
          f"{'n/a' if pool is None else f'{pool / 2**20:.1f}'}")
    if args.calibrate:
        path = args.cost_table or "cost_table.json"
        cm.save(path)
        print(f"# cost table -> {path} entries={cm.entry_count} "
              f"calibrated={cm.calibrated_count}")
    for b in s["buckets"]:
        print(f"# bucket={b['bucket']} n={b['requests']} "
              f"compiles={b['compiles']} wait_ms={b['mean_queue_wait_ms']:.1f} "
              f"run_ms={b['mean_run_ms']:.1f} waste={b['padding_waste']:.2f}")
    if args.report:
        client.metrics.save(args.report)
        print(f"# report -> {args.report}")
    if args.trace_out:
        client.save_trace(args.trace_out)
        print(f"# trace -> {args.trace_out} "
              f"(pipeline_overlaps={pipeline_overlaps(client.tracer)})")
    if server is not None:
        # hold the scrape endpoint open (a scraper polls for this marker,
        # then reads /metrics before the process exits)
        if args.metrics_hold_s > 0:
            print(f"# metrics endpoint holding {args.metrics_hold_s:.0f}s "
                  f"at {server.url}/metrics", flush=True)
            time.sleep(args.metrics_hold_s)
        server.stop()
    client.close()
    return 0


def _lm_prompts(args, cfg) -> list[np.ndarray]:
    """Deterministic synthetic prompt trace (the reference's seed and rule)."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(args.n):
        plen = int(rng.integers(4, max(args.prompt_len, 4) + 1))
        out.append(rng.integers(0, cfg.vocab, size=plen).astype(np.int32))
    return out


def _lm_model(args, dev):
    """The ``--arch`` config and random parameters from seed 0: full width
    in the config's dtype on the card, reduced to float32 on the CPU (the
    reference's ``--mode lm`` config)."""
    cfg = get_config(args.arch)
    if dev.type == "cpu":
        cfg = reduce_config(cfg).replace(dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, lm.init_params(gen, cfg)


def _lm_client(args, cfg, params, dev, scheme: str) -> LMClient:
    return LMClient(params, cfg, scheme, window=args.window, max_slots=args.batch,
                    mem_budget_mb=args.mem_budget_mb, kernels=args.kernels,
                    default_max_new_tokens=args.tokens, device=dev)


def serve_lm_http(args, cfg, params, dev) -> int:
    """``--mode lm --listen``: the fold path's HTTP front-end and fleet
    router with an ``LMClient`` per replica.  ``POST /v1/generate``
    submits, tokens stream as SSE ``token`` events, ``/metrics`` carries
    ``workload="lm"`` series."""
    try:
        host, port = parse_hostport(args.listen)
    except ValueError as e:
        print(f"error: {e}")
        return 2
    scheme = "lightnobel_aaq" if args.quant_kv else "baseline_fp16"

    def factory(i: int) -> LMClient:
        client = _lm_client(args, cfg, params, dev, scheme)
        client.tracer.set_metadata(
            replica=i, workload="lm", arch=args.arch, scheme=scheme,
            window=args.window, max_slots=args.batch, device=str(dev),
            kernels=dispatch.describe(args.kernels, device=dev))
        if args.warmup:
            client.warmup()
        return client

    return _run_fleet(
        args, factory, host, port,
        f"workload=lm replicas={args.replicas} arch={cfg.name} scheme={scheme} "
        f"window={args.window} slots={args.batch} "
        f"kernels={dispatch.describe(args.kernels, device=dev)}",
        lambda r, s: f"tokens={s['tokens']} restarts={r.restarts}")


def serve_lm(args, dev) -> int:
    """LM decode through the serving substrate: continuous per-token
    batching over ``--batch`` slots with the KV cache AAQ-quantized when
    ``--quant-kv`` is set (admission then prices requests at the scheme's
    KV bits per value).  Only the dense decoder configs: another kind is
    refused (exit 2) before any weights are made, as the reference does."""
    kind = get_config(args.arch).kind
    if kind != "dense":
        print(f"error: --mode lm serves dense decoder archs through the "
              f"substrate; {args.arch!r} is kind={kind!r}")
        return 2
    cfg, params = _lm_model(args, dev)
    if args.listen is not None:
        return serve_lm_http(args, cfg, params, dev)
    scheme = "lightnobel_aaq" if args.quant_kv else "baseline_fp16"
    client = _lm_client(args, cfg, params, dev, scheme)
    client.tracer.set_metadata(workload="lm", arch=args.arch, scheme=scheme,
                               window=args.window, max_slots=args.batch,
                               device=str(dev),
                               kernels=dispatch.describe(args.kernels, device=dev))
    if args.warmup:
        client.warmup()
    prompts = _lm_prompts(args, cfg)
    tiers = priority_tiers(len(prompts), args.priority_split)
    t0 = time.perf_counter()
    if args.driver == "thread":
        client.start()
        handles = [client.submit(p, priority=pr, deadline_s=args.deadline_s)
                   for p, pr in zip(prompts, tiers)]
        for h in handles:
            if not h.done:
                h.result(timeout=600.0)
        client.stop()
    else:
        for p, pr in zip(prompts, tiers):
            client.submit(p, priority=pr, deadline_s=args.deadline_s)
        client.drive()
    client.metrics.wall_s = time.perf_counter() - t0
    results = sorted(client.metrics.results, key=lambda r: r.request_id)
    print(LM_CSV_HEADER)
    for r in results:
        print(lm_csv_row(r))
    s = client.metrics.summary()
    adm = client.core.admission
    print(f"# workload=lm arch={cfg.name} scheme={scheme} device={dev} "
          f"served={s['served']}/{s['requests']} rejected={s['rejected']} "
          f"expired={s['expired']} tokens={s['tokens']} "
          f"tok/s={s['tokens_per_s']:.1f} compiles={s['compiles']} "
          f"kv_bits_per_value={adm.bits_per_value:.1f} "
          f"kv_bytes_per_req={adm.bytes_per_request} "
          f"kernels={dispatch.describe(args.kernels, device=dev)}"
          + (f" budget_mb={args.mem_budget_mb:.1f}"
             if args.mem_budget_mb else ""))
    print(f"# queue_wait_ms p50={s['queue_wait_ms']['p50']:.1f} "
          f"p95={s['queue_wait_ms']['p95']:.1f} "
          f"| run_ms p50={s['run_ms']['p50']:.1f} "
          f"p95={s['run_ms']['p95']:.1f}")
    if args.report:
        client.metrics.save(args.report)
        print(f"# report -> {args.report}")
    if args.trace_out:
        client.save_trace(args.trace_out)
        print(f"# trace -> {args.trace_out}")
    if args.quant_kv and args.drift_tol is not None:
        # fp16 twin on the same prompts: the quantized-KV run must stay
        # within --drift-tol of it on first-generated-token logits
        twin = _lm_client(args, cfg, params, dev, "baseline_fp16")
        ref = {r.request_id: r for r in twin.run(prompts)}
        drift = max((float(np.max(np.abs(r.logits_first - ref[i].logits_first)))
                     for i, r in enumerate(results)
                     if r.ok and ref[i].ok and r.logits_first is not None),
                    default=0.0)
        ok = drift <= args.drift_tol
        print(f"# kv_drift max|logits_first - fp16|={drift:.4e} "
              f"tol={args.drift_tol:.4e} {'OK' if ok else 'FAIL'}")
        if not ok:
            return 1
    return 0


def parser() -> argparse.ArgumentParser:
    """The serving CLI's flags (``main``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["ppm", "lm"], default="ppm")
    ap.add_argument("--scheme", default="lightnobel_aaq", choices=list(SCHEMES))
    ap.add_argument("--kernels", choices=list(dispatch.BACKENDS),
                    default=dispatch.AUTO,
                    help="kernel backend: the CUDA kernels, the plain "
                         "references, or auto (kernels on CUDA tensors)")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--min-len", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for")
    # -- ppm engine flags --
    ap.add_argument("--no-engine", action="store_true",
                    help="sequential serving, one request at a time")
    ap.add_argument("--no-fidelity", action="store_true",
                    help="skip the baseline_fp16 TM-score pass")
    ap.add_argument("--buckets", default="pow2",
                    help="'pow2' or comma-separated edges, e.g. '32,64,96'")
    ap.add_argument("--max-tokens-per-batch", type=int, default=1024)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--mem-budget-mb", type=float, default=None,
                    help="peak-activation budget for admission control")
    ap.add_argument("--chunk-size", default="off", metavar="{off,auto,N}",
                    help="long-fold chunked trunk: 'off' (default) runs the "
                         "unchunked pair stack, an integer N runs row-chunked "
                         "loops with that chunk on buckets > N, and 'auto' "
                         "lets the memory planner pick the largest chunk per "
                         "bucket that fits --mem-budget-mb")
    ap.add_argument("--warmup", action="store_true",
                    help="capture every bucket's {1, cap/2, cap} launch sizes "
                         "before serving")
    ap.add_argument("--inflight-depth", type=int, default=2,
                    help="bounded dispatch/retire pipeline depth (1 = "
                         "synchronous)")
    ap.add_argument("--batch-linger-ms", type=float, default=0.0,
                    help="fill-or-timeout CAP: hold an underfull batch up to "
                         "this long past its most urgent arrival (0 = launch "
                         "immediately)")
    ap.add_argument("--no-adaptive-linger", action="store_true",
                    help="hold underfull batches for the full fixed "
                         "--batch-linger-ms budget")
    ap.add_argument("--calibrate", action="store_true",
                    help="replay every cached executable with synthetic "
                         "inputs, record median-of-k latencies in the cost "
                         "model and write the table to --cost-table (default "
                         "cost_table.json) after serving")
    ap.add_argument("--cost-table", default=None, metavar="PATH",
                    help="persisted cost-table JSON: with --calibrate, where "
                         "to write it; without, load it and capture its keys "
                         "before serving")
    ap.add_argument("--priority-split", type=float, default=0.0,
                    help="fraction of requests submitted at priority 1 "
                         "(interleaved); the rest run at priority 0")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request queue deadline")
    ap.add_argument("--driver", choices=["inline", "thread"], default="inline",
                    help="pump the client inline after submitting, or on the "
                         "background driver thread")
    ap.add_argument("--report", default=None,
                    help="write per-request metrics to this .csv/.json path")
    ap.add_argument("--trace-out", default=None,
                    help="write the span trace as Chrome-trace/Perfetto JSON")
    # -- network serving (HTTP front-end + fleet) --
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve the fold API over HTTP on this address "
                         "(port 0 = ephemeral; the bound address is "
                         "printed as '# listening ...'); ignores --n and "
                         "runs until SIGTERM/--serve-for-s")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the HTTP front-end; the "
                         "router balances on live queue-depth/in-flight "
                         "telemetry from each replica's registry")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="per-replica restart budget: a replica whose "
                         "driver dies is rebuilt (fresh client + driver) "
                         "at most this many times; its queued requests "
                         "requeue under their original ids (0 = mark dead "
                         "and drain, never revive)")
    ap.add_argument("--serve-for-s", type=float, default=0.0,
                    help="with --listen: exit after this many seconds "
                         "(0 = run until SIGTERM/SIGINT)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics (+ /metrics.json, "
                         "/healthz) on this port (0 = ephemeral)")
    ap.add_argument("--metrics-hold-s", type=float, default=0.0,
                    help="keep the --metrics-port endpoint up this long "
                         "after serving finishes")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="ppm engine: write a torch.profiler trace of the "
                         "serving window (submit to drain) into DIR, the "
                         "engine's serve.dispatch/serve.retire ranges beside "
                         "the card's kernels (the counterpart of the "
                         "reference's --jax-profile; no effect with --mode "
                         "lm, --listen or --no-engine)")
    # -- lm mode (decode through the substrate) --
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="lm: a dense architecture (full width on the card, "
                         "reduced float32 on the CPU)")
    ap.add_argument("--batch", type=int, default=4,
                    help="lm: decode slots (the continuous batch width)")
    ap.add_argument("--tokens", type=int, default=32,
                    help="lm: default max_new_tokens per request")
    ap.add_argument("--quant-kv", action="store_true",
                    help="lm: AAQ-quantize the KV cache (scheme "
                         "lightnobel_aaq; admission prices requests at the "
                         "scheme's KV bits-per-value)")
    ap.add_argument("--window", type=int, default=128,
                    help="lm: ring KV window (prompt+generation must fit)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="lm: max synthetic prompt length (lengths drawn "
                         "in [4, this])")
    ap.add_argument("--drift-tol", type=float, default=None,
                    help="lm + --quant-kv: run an fp16-KV twin on the same "
                         "prompts and exit 1 if max first-token logit drift "
                         "exceeds this")
    # -- mesh-sharded serving --
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="ppm: serve on a (data x model) mesh of ranks, the "
                         "pair tensor split on j over the model ranks")
    ap.add_argument("--shard-threshold", type=int, default=None,
                    help="ppm: buckets at/above this go to the mesh")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    try:
        buckets = parse_buckets(args.buckets, args.min_len, args.max_len)
    except ValueError:
        print(f"error: --buckets must be 'pow2' or comma-separated ints, "
              f"got {args.buckets!r}")
        return 2
    try:
        parse_chunk_spec(args.chunk_size)
    except ValueError as e:
        print(f"error: {e}")
        return 2
    if args.calibrate and args.listen is not None:
        print("error: --calibrate is an inline warmup mode; run it without "
              "--listen, then point the server at the table with "
              "--cost-table")
        return 2
    dev = resolve_device(args.device)
    if args.mode == "lm":
        with dispatch.use_backend(args.kernels):
            return serve_lm(args, dev)
    mesh = None
    if not args.no_engine:
        if (args.mesh is None) != (args.shard_threshold is None):
            print("error: --mesh and --shard-threshold must be given together "
                  "(one without the other shards nothing)")
            return 2
        try:
            mesh = make_serving_mesh(args.mesh, device=dev)
        except ValueError as e:
            print(f"error: {e}")
            return 2
    if mesh is not None and mesh.bind(dev).rank != 0:
        serve_worker(mesh)                 # a torchrun rank other than 0
        return 0
    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device=dev)
    seqs = _sample_trace(args.n, args.min_len, args.max_len)
    try:
        if args.listen is not None and not args.no_engine:
            return serve_http(args, cfg, params, buckets, dev, mesh)
        with dispatch.use_backend(args.kernels):
            if args.no_engine:
                serve_ppm_sequential(cfg, params, seqs, buckets, scheme=args.scheme,
                                     fidelity=not args.no_fidelity, device=dev)
                return 0
            return serve_ppm_engine(args, cfg, params, seqs, buckets, dev, mesh)
    finally:
        if mesh is not None:
            mesh.close()


if __name__ == "__main__":
    raise SystemExit(main())
