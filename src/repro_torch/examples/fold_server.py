"""End-to-end request-lifecycle serving example (port of
``examples/fold_server.py``): mixed-length protein-folding traffic through
``FoldClient``, with handles carrying priorities and cancellation, a typed
progress-event stream, and the bucketed continuous-batching ``EngineCore``
underneath (one executable per key: a CUDA graph on the card; token-budget
batching; AAQ-aware admission control), reporting each request's queue
wait, latency, TM against the unquantized fold, and the p50/p95/p99
tails.

The second act serves the SAME engine over the network: a
``FoldHTTPServer`` (stdlib HTTP, ephemeral port) over a single-replica
``FleetRouter`` wrapping the client; submit, poll and fetch over real
sockets, the coords on the wire bitwise the in-process result, the SSE
history legal, the distogram shipped only when asked for.

    PYTHONPATH=src python -m repro_torch.examples.fold_server [--device cpu]

Runs on the card unless ``--device cpu``; every check is an assertion.
The last line counts the kernel launches (and plain calls) of both acts.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import reduce_ppm_config
from repro_torch.data.pipeline import ProteinSampler
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.ppm import init_ppm, tm_score
from repro_torch.serving import (CSV_HEADER, FleetRouter, FoldClient, FoldHTTPServer,
                                 check_request_order, csv_row)
from repro_torch.serving.transport import protocol
from repro_torch.serving.transport.server import request_json


def _tails(name: str, d: dict) -> str:
    return f"{name} p50={d['p50']:.1f} p95={d['p95']:.1f} p99={d['p99']:.1f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        # with more threads MKL splits a product by its row count, and act
        # two's fold would not be bitwise act one's batch row
        torch.set_num_threads(1)

    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device=dev)
    client = FoldClient(params, cfg, "lightnobel_aaq",
                        buckets=(32, 48), max_tokens_per_batch=128,
                        max_batch=4, mem_budget_mb=256.0, fidelity=True, device=dev)
    stream = client.stream()                       # pull-side event iterator
    client.subscribe(lambda e: print(f"## event {e}")
                     if e.kind in ("cancelled", "expired") else None)

    sampler = ProteinSampler(seed=11, min_len=24, max_len=48)
    trace = [sampler.sample(i) for i in range(6)]

    # two priority tiers: even requests are latency-sensitive (priority 1)
    handles = [client.submit(seq, priority=1 - (i % 2))
               for i, seq in enumerate(trace)]
    # one caller changes its mind before anything is scheduled
    victim = client.submit(sampler.sample(99), priority=0)
    assert victim.cancel() and victim.status == "CANCELLED"

    client.drive()                                 # inline pump (threadless)
    results = [h.result() for h in handles]        # all DONE already

    print(CSV_HEADER)
    for r in results:
        print(csv_row(r))
    s = client.metrics.summary()
    print(f"# compiles={s['compiles']} (one per (bucket, launch-size, "
          f"scheme)) served={s['served']} cancelled={s['cancelled']} "
          f"occupancy={s['pipeline']['mean_batch_occupancy']:.2f}")
    latency = [r.queue_wait_ms + r.run_ms for r in results]
    lat = {f"p{q}": float(np.percentile(latency, q)) for q in (50, 95, 99)}
    print(f"# tails ms: {_tails('queue_wait', s['queue_wait_ms'])} | "
          f"{_tails('run', s['run_ms'])} | {_tails('latency', lat)}")
    tms = [r.tm_vs_fp for r in results]
    print(f"# tm_vs_fp min={min(tms):.4f} mean={sum(tms) / len(tms):.4f}")
    assert all(0.0 < t <= 1.0 + 1e-6 for t in tms)

    # the event stream tells each request's full story, in order
    events = stream.events()
    for h in handles + [victim]:
        check_request_order([e for e in events if e.request_id == h.request_id])
    kinds = {e.kind for e in events}
    assert "completed" in kinds and "cancelled" in kinds

    # handles traverse legal transitions only
    for h in handles:
        assert [st for st, _ in h.transitions] == ["QUEUED", "ADMITTED", "RUNNING", "DONE"]

    # steady state: the same arrival shape again (per-bucket request
    # counts) reuses every (bucket, launch-size, scheme) executable
    before = client.core.compile_count
    client.run([sampler.sample(i) for i in range(6)])
    print(f"# steady-state wave: new_compiles={client.core.compile_count - before}")
    assert client.core.compile_count == before
    # coords are real-token-only (padding stripped)
    for r, seq in zip(results, trace):
        assert r.coords.shape == (len(seq), 3)
        assert np.isfinite(r.coords).all()

    # -- act two: the same engine, over the network -------------------------
    router = FleetRouter.wrap(client, autostart=True)
    try:
        with FoldHTTPServer(router) as srv:
            print(f"# serving HTTP at {srv.url}")
            seq = trace[0]
            rid = request_json(f"{srv.url}/v1/fold", method="POST",
                               body={"sequence": seq.tolist(), "priority": 1})["id"]
            rec = router.get(rid)
            inproc = rec.handle.result(timeout=600.0)      # the background driver serves it
            status = request_json(f"{srv.url}/v1/fold/{rid}")
            assert status["state"] == "DONE", status
            coords = protocol.decode_array(status["result"]["coords"])
            # the wire is bitwise-lossless: network coords == in-process coords
            assert coords.tobytes() == inproc.coords.tobytes()
            # the same protein as in act one, there in a batch of 4: bitwise
            # (a float32 fold's products run a batch row at a time on the
            # card, ``device.rows_alone``)
            same = coords.tobytes() == results[0].coords.tobytes()
            tm = float(tm_score(torch.from_numpy(np.array(coords, np.float32)),
                                torch.from_numpy(np.array(results[0].coords, np.float32))))
            assert same, tm
            _, body = _get(f"{srv.url}/v1/fold/{rid}/events")
            history = protocol.parse_sse(body)
            check_request_order(history)
            assert history[-1].kind == "completed"
            # plain polls never ship (or materialize) the distogram
            assert status["result"]["distogram"] is None
            assert inproc.distogram.materialized is False
            with_dist = request_json(f"{srv.url}/v1/fold/{rid}?distogram=1")
            dist = protocol.decode_array(with_dist["result"]["distogram"])
            assert inproc.distogram.materialized is True
            np.testing.assert_array_equal(dist, np.asarray(inproc.distogram))
            hz = request_json(f"{srv.url}/healthz")
            print(f"# http fold {rid} ok coords={coords.shape} tm_vs_act_one={tm:.6f} "
                  f"bitwise_vs_act_one={same} "
                  f"events={len(history)} "
                  f"replicas_healthy={sum(r['healthy'] for r in hz['replicas'])}")
    finally:
        router.stop()
    client.close()
    # the kernels both acts launched (on the card) or their plain versions ran
    print(f"# launches {json.dumps(dispatch.launch_counts())} "
          f"plain {json.dumps(dispatch.plain_counts())}")
    return 0


def _get(url: str) -> tuple[int, bytes]:
    import urllib.request
    with urllib.request.urlopen(url, timeout=60.0) as resp:
        return resp.status, resp.read()


if __name__ == "__main__":
    raise SystemExit(main())
