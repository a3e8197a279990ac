"""The fleet on one shared mesh (``--listen`` with ``--mesh``) and the
cost model's ``prediction_error_factor``, on the CPU.

Gates:
  * ``prediction_error_factor`` gives the reference's four cases, and the
    reference's value on each;
  * two engines on one 1 x 2 gloo mesh, driven from two threads at once,
    fold bitwise what each folds alone (the mesh's lock keeps every rank's
    commands and collectives in one order);
  * the fleet of ``serve.fold_replica_factory``'s replicas on one mesh
    over HTTP: the wire bitwise an in-process single-device client (a
    sharded fold is bitwise the single placement on the CPU, one torch
    thread); a replica failed mid-burst is rebuilt on the same worker
    process, its old engine closed on every rank; the replicas' clients
    closed, no engine is left on any rank; the worker leaves when the mesh
    closes;
  * a mesh closed with engines still open on it closes them first (their
    graphs here and on every worker: NCCL does not tear a communicator
    down under graphs that captured its collectives), then its worker
    leaves cleanly;
  * ``python -m repro_torch.launch.serve --listen ... --replicas 2 --mesh
    1x2 --shard-threshold 64`` serves sharded buckets over HTTP, bitwise.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.costmodel import prediction_error_factor as jax_pef  # noqa: E402
from repro_torch.configs import reduce_ppm_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.ppm import init_ppm  # noqa: E402
from repro_torch.serving import (FleetRouter, FoldClient, FoldHTTPServer,  # noqa: E402
                                 check_request_order, make_serving_mesh,
                                 prediction_error_factor)
from repro_torch.serving import events as ev  # noqa: E402
from repro_torch.serving.transport import protocol  # noqa: E402
from repro_torch.serving.transport.server import request_json  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = reduce_ppm_config()
RNG = np.random.default_rng(21)
#: bucket 64 shards over the mesh, bucket 32 stays on rank 0
BUCKETS = (32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    return init_ppm(CFG, seed=0, device="cpu")


def _seqs(lengths) -> list[np.ndarray]:
    return [RNG.integers(0, 20, n).astype(np.int32) for n in lengths]


def _single(params, seqs, scheme="lightnobel_aaq") -> list:
    client = FoldClient(params, CFG, scheme, buckets=BUCKETS, max_batch=2, fidelity=False,
                        device="cpu")
    return client.run(seqs)


def test_prediction_error_factor_matches_the_reference():
    cases = [(100.0, 100.0, 1.0), (50.0, 100.0, 2.0), (100.0, 50.0, 2.0),
             (0.0, 50.0, float("inf"))]
    for p, a, want in cases:
        assert prediction_error_factor(p, a) == pytest.approx(want)
        assert prediction_error_factor(p, a) == jax_pef(p, a)


def test_two_engines_on_one_mesh_from_two_threads_bitwise(params):
    """Two clients on one mesh (other schemes, other traces), each run
    alone, then fresh ones run at once from two threads, builds and
    launches interleaving: every fold bitwise the one alone, every
    sharded one on the mesh."""
    mesh = make_serving_mesh("1x2", device="cpu")
    jobs = [("lightnobel_aaq", _seqs([40, 20, 60])), ("baseline_fp16", _seqs([50, 64, 30]))]

    def client(scheme):
        return FoldClient(params, CFG, scheme, buckets=BUCKETS, max_batch=2, fidelity=False,
                          mesh=mesh, shard_threshold=64, device="cpu")

    try:
        alone = [client(s).run(q) for s, q in jobs]
        both = [None, None]
        errors = []

        def run(i):
            try:
                both[i] = client(jobs[i][0]).run(jobs[i][1])
            except BaseException as e:        # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not errors and all(b is not None for b in both), errors
        for a_res, b_res in zip(alone, both):
            assert [r.placement for r in a_res] == [r.placement for r in b_res]
            assert "mesh:1x2" in {r.placement for r in a_res}
            for x, y in zip(a_res, b_res):
                assert x.status == "ok" and x.coords.tobytes() == y.coords.tobytes()
        # alone too, each is bitwise the single placement
        for (scheme, seqs), got in zip(jobs, alone):
            for x, y in zip(got, _single(params, seqs, scheme)):
                assert x.coords.tobytes() == y.coords.tobytes()
    finally:
        mesh.close()


def test_mesh_close_closes_the_engines_still_open_on_it(params):
    mesh = make_serving_mesh("1x2", device="cpu").bind("cpu")
    (worker,) = mesh._procs
    clients = [FoldClient(params, CFG, s, buckets=BUCKETS, max_batch=2, fidelity=False,
                          mesh=mesh, shard_threshold=64, device="cpu")
               for s in ("lightnobel_aaq", "baseline_fp16")]
    try:
        for c in clients:
            assert [r.placement for r in c.run(_seqs([60]))] == ["mesh:1x2"]
            assert c.core._executables
        assert [s["engines"] for s in mesh.rank_stats()] == [[0, 1], [0, 1]]
    finally:
        mesh.close()
    for c in clients:
        assert c.core.mesh_eid is None and not c.core._executables
    assert mesh.engines == set() and worker.wait(30) == 0


def _args(*extra):
    return serve.parser().parse_args(["--mode", "ppm", "--device", "cpu", "--buckets", "32,64",
                                      "--max-batch", "2", "--no-fidelity", "--mesh", "1x2",
                                      "--shard-threshold", "64", *extra])


def test_fleet_on_a_shared_mesh_rebuilds_a_failed_replica_on_the_same_ranks(params):
    args = _args()
    mesh = make_serving_mesh(args.mesh, device="cpu").bind("cpu")
    (worker,) = mesh._procs
    router = FleetRouter(serve.fold_replica_factory(args, CFG, params, BUCKETS,
                                                    torch.device("cpu"), mesh),
                         2, autostart=False, max_restarts=1)
    seqs = _seqs([44, 58, 24, 64, 36, 52])
    try:
        assert mesh.rank_stats()[1]["engines"] == [0, 1]
        with FoldHTTPServer(router) as srv:
            ids = [request_json(f"{srv.url}/v1/fold", method="POST",
                                body={"sequence": s.tolist()})["id"] for s in seqs[:4]]
            old = router.replicas[0].client
            router.replicas[0].mark_failed()          # mid-burst, before any is served
            requeued = router.check_health()
            assert requeued and router.replicas[0].client is not old
            assert router.replicas[0].restarts == 1
            ids += [request_json(f"{srv.url}/v1/fold", method="POST",
                                 body={"sequence": s.tolist()})["id"] for s in seqs[4:]]
            router.start()
            router.drain_wait(timeout=300.0)
            router.join_released(timeout=120.0)
            statuses = [request_json(f"{srv.url}/v1/fold/{rid}") for rid in ids]
            for rid in ids:
                check_request_order(router.get(rid).events)
                assert router.get(rid).events[-1].kind == ev.COMPLETED
        want = _single(params, seqs)
        placements = set()
        for st, ref in zip(statuses, want):
            assert st["state"] == "DONE"
            got = protocol.decode_array(st["result"]["coords"])
            assert got.tobytes() == ref.coords.tobytes()
            placements.add(st["result"]["placement"])
        assert placements == {"single", "mesh:1x2"}
        # the old engine (id 0) closed on both ranks; one worker throughout
        stats = mesh.rank_stats()
        assert [s["engines"] for s in stats] == [[1, 2], [1, 2]]
        assert mesh._procs == [worker] and worker.poll() is None
        router.stop()
        for r in router.replicas:          # as the CLI does before the mesh goes
            r.client.close()
        assert [s["engines"] for s in mesh.rank_stats()] == [[], []]
    finally:
        router.stop()
        mesh.close()
    assert worker.wait(30) is not None          # the rank left with the mesh


def _read_until(proc: subprocess.Popen, marker: str) -> list[str]:
    lines = []
    for line in proc.stdout:
        lines.append(line.rstrip("\n"))
        if line.startswith(marker):
            return lines
    raise AssertionError(f"no {marker!r} line; output: {lines}")


def test_cli_listen_with_mesh_serves_sharded_buckets_bitwise(params):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "ppm", "--device", "cpu",
         "--listen", "127.0.0.1:0", "--replicas", "2", "--mesh", "1x2", "--shard-threshold",
         "64", "--buckets", "32,64", "--max-batch", "2", "--no-fidelity",
         "--serve-for-s", "240"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seqs = _seqs([48, 26, 61])
    try:
        banner = _read_until(proc, "# listening ")[-1]
        url = banner.split()[2]
        assert "replicas=2" in banner and "mesh:1x2" in banner
        ids = [request_json(f"{url}/v1/fold", method="POST",
                            body={"sequence": s.tolist()})["id"] for s in seqs]
        results = []
        for rid in ids:
            deadline = time.monotonic() + 240
            while True:
                st = request_json(f"{url}/v1/fold/{rid}")
                if st["done"] or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            results.append(st["result"])
        proc.terminate()
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert out.splitlines()[-1] == "# fleet shutdown complete"
    for got, ref in zip(results, _single(params, seqs)):
        assert got["status"] == "ok"
        assert protocol.decode_array(got["coords"]).tobytes() == ref.coords.tobytes()
    assert [r["placement"] for r in results] == ["mesh:1x2", "single", "mesh:1x2"]
