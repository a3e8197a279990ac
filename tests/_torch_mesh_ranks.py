"""Spawned gloo ranks for the port's sharded-training tests
(``test_torch_train_mesh.py``, ``test_torch_pipeline_overlap.py``).

``run_ranks(world, fn, *args)`` runs ``fn(rank, world, *args)`` in
``world`` processes of one torch thread each that meet at a ``file://``
rendezvous in a fresh directory, and returns the list of what each rank's
``fn`` returned (picklable values).  A rank that raises fails the call with
its traceback; the group times out after 120 s, so a rank that dies fails
its peers instead of hanging them.  The ranks import neither JAX nor the
reference: the tests hand them numpy trees.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _main(rank, world, init, out_dir, fn, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        res = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        out = ("ok", res)
    except BaseException:
        out = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(world: int, fn, *args) -> list:
    d = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_main, args=(r, world, f"file://{d}/rdv", d, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
            if p.is_alive():
                p.kill()
        outs = []
        for r in range(world):
            path = os.path.join(d, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} left no result (exit code {procs[r].exitcode})")
            with open(path, "rb") as f:
                outs.append(pickle.load(f))
        errors = [f"rank {r}:\n{o[1]}" for r, o in enumerate(outs) if o[0] == "error"]
        if errors:
            raise RuntimeError("\n".join(errors))
        return [o[1] for o in outs]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def host(x) -> np.ndarray:
    """A tensor (a DTensor gathered whole: a collective) as numpy."""
    from repro_torch.parallel import sharding as sh
    return sh.to_global(x).detach().cpu().numpy()


# --------------------------------------------------------------------------
# rank-side scenarios
# --------------------------------------------------------------------------
def _cfg(name: str):
    from repro_torch.configs import get_config, reduce_config
    return reduce_config(get_config(name)).replace(dtype="float32")


def one_step(cfg, params, batch, aaq, mesh=None, microbatches=1):
    """One ``make_train_step`` step (lr 1e-2) of ``params`` on ``batch``
    (numpy): on one device, or sharded on ``mesh`` (parameters, moments and
    batch distributed by the reference's specs, the act rules active).
    -> (loss, params after the step as numpy, fake-quant calls routed)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import leaves, unflatten
    b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if mesh is not None:
        psh = sh.param_shardings(params, mesh, cfg)
        params = unflatten(params, [sh.distribute(t, s.mesh, s.spec)
                                    for t, s in zip(leaves(params), leaves(psh))])
        n, s = b["tokens"].shape
        bspec = sh.batch_specs(cfg, ShapeSpec("t", s, n, "train"), mesh)["batch"]
        b = {k: sh.distribute(v, mesh, bspec[k]) for k, v in b.items()}
    opt = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-2), aaq=aaq, microbatches=microbatches)
    dispatch.reset_counters()
    rules = sh.default_act_rules(mesh, "train", cfg) if mesh is not None else None
    with sh.act_rules(rules):
        params, opt, metrics = step(params, opt, b)
    fq = dispatch.counters["fakequant.ref"] + dispatch.counters["fakequant.kernel"]
    return float(host(metrics["loss"])), [host(p) for p in leaves(params)], fq


def sharded_steps(rank, world, jobs):
    """Each job (arch, numpy params, numpy batch, ste, mesh shape): one
    sharded step.  Rank 0 returns (loss, params) a job; every rank its
    fake-quant calls and the redistributions ``sharding`` counted."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.core.policy import DISABLED, AAQConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as sh
    out = []
    for arch, tree, batch, ste, shape in jobs:
        cfg = _cfg(arch)
        mesh = make_mesh(shape, ("data", "model"))
        params = lm_params_from_numpy(tree, cfg, device="cpu")
        sh.REDISTRIBUTED.clear()
        loss, ps, fq = one_step(cfg, params, batch, AAQConfig(ste=True) if ste else DISABLED,
                                mesh)
        out.append({"loss": loss, "params": ps if rank == 0 else None, "fq": fq,
                    "moved": dict(sh.REDISTRIBUTED)})
    return out


def grad_placements(rank, world, tree, batch):
    """``value_and_grad`` of the reduced qwen on a (1, world) mesh: its
    gradients on their parameters' placements, and, asked through
    ``grad_shardings`` for every leaf replicated, replicated with the same
    values; then one ``make_train_step`` step with ``grad_shardings`` the
    parameters' own shardings against the step without it."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import leaves, unflatten
    cfg = _cfg("qwen1.5-0.5b")
    mesh = make_mesh((1, world), ("data", "model"))
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    psh = sh.param_shardings(params, mesh, cfg)
    params = unflatten(params, [sh.distribute(t, s.mesh, s.spec)
                                for t, s in zip(leaves(params), leaves(psh))])
    n, s = batch["tokens"].shape
    bspec = sh.batch_specs(cfg, ShapeSpec("t", s, n, "train"), mesh)["batch"]
    b = {k: sh.distribute(torch.from_numpy(np.ascontiguousarray(v)), mesh, bspec[k])
         for k, v in batch.items()}
    rep = sh.to_shardings(mesh, sh._map_with_path(lambda _, t: sh.P(*[None] * t.dim()),
                                                  params))
    with sh.act_rules(sh.default_act_rules(mesh, "train", cfg)):
        loss, grads = value_and_grad(params, b, cfg)
        loss_r, grads_r = value_and_grad(params, b, cfg, grad_shardings=rep)
        gap = max(float((sh.to_global(x) - sh.to_global(y)).abs().max())
                  for x, y in zip(leaves(grads), leaves(grads_r)))
        steps = []
        for gs in (None, psh):
            state = (unflatten(params, [p.clone() for p in leaves(params)]), None)
            state = (state[0], adamw.init(state[0]))
            p1, _, _ = make_train_step(cfg, adamw.AdamWConfig(lr=1e-2),
                                       grad_shardings=gs)(*state, b)
            steps.append([host(x) for x in leaves(p1)])
    return {"loss": float(host(loss)), "loss_r": float(host(loss_r)), "gap": gap,
            "params": [str(x.placements) for x in leaves(params)],
            "grads": [str(x.placements) for x in leaves(grads)],
            "grads_r": [str(x.placements) for x in leaves(grads_r)],
            "steps_equal": all(np.array_equal(x, y) for x, y in zip(*steps))}


def steps_and_grad_placements(rank, world, jobs, tree, batch):
    """``sharded_steps(jobs)``, then ``grad_placements(tree, batch)``."""
    return sharded_steps(rank, world, jobs), grad_placements(rank, world, tree, batch)


def elastic_stacked(rank, world, name, ckpt_dir):
    """The reference's checkpoint of ``name``'s parameters and AdamW state
    (its layers stacked on a leading axis) resumed by ``resume_elastic``
    onto a 1 x ``world`` mesh over the port's own fresh state: the step,
    the mesh, every leaf gathered, and this rank's placements."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import plan_for_devices, resume_elastic
    from repro_torch.tree import leaves
    cfg = _cfg(name)
    params = lm.init_params(torch.Generator().manual_seed(1), cfg)
    plan = plan_for_devices(world, model_parallel=world, old_data=1)
    step, restored, mesh = resume_elastic(ckpt_dir, (params, adamw.init(params)), plan, cfg)
    return {"step": step, "mesh": tuple(mesh.shape),
            "leaves": [host(x) for x in leaves(restored)],
            "placements": [str(x.placements) for x in leaves(restored)]}


def step_collectives(rank, world, tree, batch):
    """One train step of the reduced qwen (``DISABLED``) on a (1, world)
    mesh, as ``launch.train`` lays it out: the collectives it ran, calls by
    name (DTensor's, counted by ``counting_dtensor``, and the explicit ones)."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as sh
    cfg = _cfg("qwen1.5-0.5b")
    mesh = make_mesh((1, world), ("data", "model"))
    params = sh.distribute_params(lm_params_from_numpy(tree, cfg, device="cpu"), mesh, cfg)
    n, s = batch["tokens"].shape
    bspec = sh.batch_specs(cfg, ShapeSpec("t", s, n, "train"), mesh)["batch"]
    b = {k: sh.distribute(torch.from_numpy(np.ascontiguousarray(v)), mesh, bspec[k])
         for k, v in batch.items()}
    opt = adamw.init(params)
    coll.reset_counts()
    with sh.act_rules(sh.default_act_rules(mesh, "train", cfg)), dispatch.use_backend("ref"), \
            coll.counting_dtensor():
        make_train_step(cfg)(params, opt, b)
    return {k: v["calls"] for k, v in coll.counts().items() if v["calls"]}


def _attention_shapes(dispatch, seen: list):
    """A scope in which every ``dispatch.attention`` call appends its local
    (q heads, K/V heads) to ``seen``."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        orig = dispatch.attention

        def counted(q, k, v, **kw):
            seen.append((q.shape[2], k.shape[2]))
            return orig(q, k, v, **kw)

        dispatch.attention = counted
        try:
            yield
        finally:
            dispatch.attention = orig
    return scope()


def _gathered_shapes(coll, seen: list):
    """A scope in which every all-gather, the explicit ones and DTensor's,
    appends the local shape it was handed to ``seen``."""
    import contextlib

    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Gathers(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if DTensor in types:
                return NotImplemented
            if getattr(func, "namespace", "") == "_c10d_functional" and \
                    func._opname.startswith("all_gather_into_tensor"):
                first = args[0]
                seen.extend(tuple(t.shape) for t in
                            (first if isinstance(first, (list, tuple)) else [first]))
            return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def scope():
        orig = coll.all_gather

        def gather(x, dim, group):
            seen.append(tuple(x.shape))
            return orig(x, dim, group)
        coll.all_gather = gather
        try:
            with _Gathers():
                yield
        finally:
            coll.all_gather = orig
    return scope()


def serve_steps(cfg, params, batch, cache, n_decode, quantized_kv, mesh=None, probe=None):
    """A prefill step of ``batch`` (numpy), then ``n_decode`` decode steps
    from ``cache`` (numpy leaves of ``lm.make_cache``), a column of
    ``batch['tokens']`` each: on one device, or laid out on ``mesh`` as the
    dry-run lays out a prefill and a decode cell.  -> (the prefill's
    logits, each decode step's logits, the cache's leaves after them), as
    numpy.  ``probe`` (a dict) gets the local (q heads, K/V heads) of each
    attention call of the prefill and of the decode steps, the explicit
    all-reduces of the decode steps, the local shape each all-gather of
    the decode steps was handed, and the ring's placements."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch.dryrun import _spec_leaves
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import leaves, unflatten
    probe = {} if probe is None else probe
    probe.update(prefill=[], decode=[])
    b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    n, s = b["tokens"].shape
    c = unflatten(lm.make_cache(cfg, n, s, quantized=quantized_kv, device="cpu"),
                  [torch.from_numpy(np.array(a)) for a in cache])
    prules = drules = None
    if mesh is not None:
        params = sh.distribute_params(params, mesh, cfg)
        pspec = sh.batch_specs(cfg, ShapeSpec("p", s, n, "prefill"), mesh)["batch"]
        b = {k: sh.distribute(v, mesh, pspec[k]) for k, v in b.items()}
        dspecs = sh.batch_specs(cfg, ShapeSpec("d", s, n, "decode"), mesh,
                                quantized_kv=quantized_kv)
        cspec = dspecs["cache"]
        c = unflatten(c, [sh.distribute(t, mesh, sp)
                          for t, sp in zip(leaves(c), _spec_leaves(cspec))])
        prules = sh.default_act_rules(mesh, "prefill", cfg)
        drules = sh.default_act_rules(mesh, "decode", cfg)
        if "k" in cspec:
            drules["kv_cache"] = sh.P(*cspec["k"][1:])
        tspec = dspecs["batch"]["tokens"]
    with torch.no_grad(), dispatch.use_backend("ref"), sh.mixed_ops(params):
        with sh.act_rules(prules), _attention_shapes(dispatch, probe["prefill"]):
            prefill = host(make_prefill_step(cfg)(params, b))
        logits = []
        coll.reset_counts()
        with sh.act_rules(drules), _attention_shapes(dispatch, probe["decode"]), \
                _gathered_shapes(coll, probe.setdefault("gathered", [])):
            for i in range(n_decode):
                tok = torch.from_numpy(np.ascontiguousarray(batch["tokens"][:, i:i + 1]))
                if mesh is not None:
                    tok = sh.distribute(tok, mesh, tspec)
                out, c = make_serve_step(cfg)(params, {"tokens": tok}, c)
                logits.append(host(out))
        probe["all_reduce"] = coll.counts()["all_reduce"]["calls"]
    probe["ring"] = str(c["k"].placements) if sh.is_dtensor(c.get("k")) else None
    return prefill, logits, [host(t) for t in leaves(c)]


def sharded_serve_steps(rank, world, jobs):
    """Each job (arch, numpy params, numpy batch, numpy cache leaves,
    decode steps, quantized KV): ``serve_steps`` on a (1, world) mesh;
    rank 0 returns the results."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, world), ("data", "model"))
    out = []
    for arch, tree, batch, cache, n_decode, qkv in jobs:
        # an arch, or (arch, fields of its reduced config replaced)
        cfg = _cfg(arch) if isinstance(arch, str) else _cfg(arch[0]).replace(**arch[1])
        probe = {}
        res = serve_steps(cfg, lm_params_from_numpy(tree, cfg, device="cpu"), batch, cache,
                          n_decode, qkv, mesh, probe)
        out.append((*res, probe) if rank == 0 else None)
    return out


def xent_grads(rank, world, jobs):
    """Each job (arch, numpy params, numpy batch, mesh shape): the loss and
    every parameter's gradient (``value_and_grad``, ``DISABLED``) laid out
    on the mesh as a sharded train step lays them out; rank 0 returns them
    gathered, with the mesh dim that splits the cross-entropy's vocabulary
    (``sharding.vocab_split``; None where the loss is not vocabulary-
    parallel)."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import leaves
    out = []
    for arch, tree, batch, shape in jobs:
        cfg = _cfg(arch)
        mesh = make_mesh(shape, ("data", "model"))
        params = sh.distribute_params(lm_params_from_numpy(tree, cfg, device="cpu"), mesh, cfg)
        n, s = batch["tokens"].shape
        bspec = sh.batch_specs(cfg, ShapeSpec("t", s, n, "train"), mesh)["batch"]
        b = {k: sh.distribute(torch.from_numpy(np.ascontiguousarray(v)), mesh, bspec[k])
             for k, v in batch.items()}
        w, vdim = ((params["embed"]["e"], 0) if cfg.tie_embeddings
                   else (params["lm_head"]["w"], 1))
        with sh.act_rules(sh.default_act_rules(mesh, "train", cfg)):
            split = sh.vocab_split(w, vdim)
            loss, grads = value_and_grad(params, b, cfg)
            got = {"loss": float(host(loss)), "grads": [host(g) for g in leaves(grads)],
                   "split": split}
        out.append(got if rank == 0 else None)
    return out


def steps_grads_and_elastic(rank, world, jobs, tree, batch, stacked, ckpt_dir, serve_jobs,
                            xent_jobs):
    """``steps_and_grad_placements``, then ``elastic_stacked(stacked)``,
    then ``step_collectives(tree, batch)``, then
    ``sharded_serve_steps(serve_jobs)``, then ``xent_grads(xent_jobs)``."""
    return (*steps_and_grad_placements(rank, world, jobs, tree, batch),
            elastic_stacked(rank, world, stacked, ckpt_dir),
            step_collectives(rank, world, tree, batch),
            sharded_serve_steps(rank, world, serve_jobs),
            xent_grads(rank, world, xent_jobs))


def gpipe_rings_save(rank, world, tree, batch, xw, n_micro, save_tree, ckpt_dir):
    """GPipe on a (pod=2, data=world/2) mesh: the loss, and the gradients
    of this rank's stage layers (rank 0 also the parameters every rank
    uses); then the three ring matmuls on a 1-D ``model`` mesh of every
    rank, each rank holding its k-block of x (and of w); then
    ``elastic_save`` of ``save_tree``."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import overlap
    from repro_torch.parallel.pipeline import gpipe_loss
    from repro_torch.tree import leaves
    cfg = _cfg("qwen1.5-0.5b").replace(layers=4, tie_embeddings=False)
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    mesh = make_mesh((2, world // 2), ("pod", "data"))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    coll.reset_counts()
    loss = gpipe_loss(params, b, cfg, mesh=mesh, n_micro=n_micro)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    permutes = coll.counts()["permute"]["calls"]
    stage = mesh.get_local_rank(0)
    per = cfg.layers // 2
    own = [f"blocks.{i}." for i in range(stage * per, (stage + 1) * per)]
    names = _leaf_names(params)
    keep = {n: (g.numpy() if g is not None else None) for n, g in zip(names, grads)
            if any(n.startswith(o) for o in own) or (rank == 0 and not n.startswith("blocks."))}
    out = {"loss": float(loss), "grads": keep, "permutes": permutes}
    # the ring matmuls: x (m, k) and w (k, n), rank r's k-block of each
    x, w = (torch.from_numpy(a) for a in xw)
    group = make_mesh((world,), ("model",)).get_group(0)
    kl = x.shape[1] // world
    xs, ws = x[:, rank * kl:(rank + 1) * kl].contiguous(), w[rank * kl:(rank + 1) * kl]
    coll.reset_counts()
    out["ring_ag"] = overlap.ring_ag_matmul(xs, ws.contiguous(), group).numpy()
    out["ring_ws"] = overlap.ring_ag_matmul_ws(xs, w, group).numpy()
    out["psum_scatter"] = overlap.psum_scatter_matmul(xs, ws, group).numpy()
    out["ring_counts"] = {k: v["calls"] for k, v in coll.counts().items() if v["calls"]}
    out["saved"] = elastic_save(rank, world, save_tree, ckpt_dir)
    return out


def _leaf_names(tree, path=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{path}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{path}{i}.")]
    return [path[:-1]]


def elastic_save(rank, world, tree, ckpt_dir):
    """The reduced qwen parameters distributed on a (2, 2) mesh, saved
    (rank 0 writes the host view)."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import leaves, unflatten
    cfg = _cfg("qwen1.5-0.5b")
    params = lm_params_from_numpy(tree, cfg, device="cpu")
    mesh = make_mesh((2, 2), ("data", "model"))
    psh = sh.param_shardings(params, mesh, cfg)
    dp = unflatten(params, [sh.distribute(t, s.mesh, s.spec)
                            for t, s in zip(leaves(params), leaves(psh))])
    ckpt.save(ckpt_dir, 42, dp, cfg=cfg)
    return [str(p.placements) for p in leaves(dp)][:3]


def elastic_resume(rank, world, tree, ckpt_dir):
    """``plan_for_devices`` for these ranks at model 2 (from data 2) and
    ``resume_elastic`` onto its mesh: the step, the plan, every leaf
    gathered, and this rank's placements."""
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.runtime.elastic import plan_for_devices, resume_elastic
    from repro_torch.tree import leaves
    cfg = _cfg("qwen1.5-0.5b")
    template = lm_params_from_numpy(tree, cfg, device="cpu")
    plan = plan_for_devices(world, model_parallel=2, old_data=2)
    step, restored, mesh = resume_elastic(ckpt_dir, template, plan, cfg)
    return {"step": step, "scale": plan.microbatch_scale, "mesh": tuple(mesh.shape),
            "leaves": [host(x) for x in leaves(restored)],
            "placements": [str(x.placements) for x in leaves(restored)]}


def split_attention(rank, world, jobs):
    """Each job (numpy q, k, v (B, S, H, D), numpy weights w of the
    output, causal): ``sharding.local_attention`` on a (1, world) mesh of
    q, k, v replicated on ``model`` (as ``split_heads`` leaves heads the
    axis does not divide), and the gradients of sum(out * w) in q, k, v;
    rank 0 returns (out, dq, dk, dv, the local (rows, q heads, K/V heads)
    of each attention call) a job."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as sh
    mesh = make_mesh((1, world), ("data", "model"))
    out = []
    for q, k, v, w, causal in jobs:
        seen = []

        def attend(ql, kl, vl, **kw):
            seen.append((ql.shape[1], ql.shape[2], kl.shape[2]))
            return dispatch.attention(ql, kl, vl, **kw)

        ts = [sh.distribute(torch.from_numpy(a), mesh, sh.P()).requires_grad_(True)
              for a in (q, k, v)]
        with dispatch.use_backend("ref"):
            o = sh.local_attention(attend, *ts, causal=causal)
            loss = (o * sh.distribute(torch.from_numpy(w), mesh, sh.P())).sum()
            grads = torch.autograd.grad(loss, ts)
        res = [host(o.detach())] + [host(g) for g in grads]
        out.append((*res, seen) if rank == 0 else None)
    return out


def grid_folds(rank, world, tree, aatype, schemes, chunk):
    """The reduced PPM (the reference's numpy ``tree``) folded by
    ``make_fold_step`` on a 2 x 2 ``PairGrid``, each parameter the rank's
    shard (``grid_params``), under each of ``schemes``; then on a 1 x 1
    grid (a group of this rank alone) and on a 1 x 4 grid under each; then
    the 2 x 2 grid at N - 2 under the first (triangular attention on the
    blocks, the fine rows not dividing N), and the first on a 1 x 4
    ``PairShard`` (the serving tier's j split).  Each grid and the
    ``PairShard`` also fold row-chunked at ``chunk`` under the first two
    schemes ("<grid> chunked"), and the 2 x 2 grid at N - 2 under the
    first (neither the slabs nor the fine rows dividing).  Rank 0 returns
    {(grid, scheme): (coords, distogram)}, every rank its parameter
    bytes on the 2 x 2 grid and the collectives of its first fold there."""
    import torch.distributed as dist
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import reduce_ppm_config
    from repro_torch.core import make_scheme
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_fold_step
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import leaves
    cfg = reduce_ppm_config()
    params = params_from_numpy(tree, cfg, device="cpu")
    a = torch.from_numpy(aatype)
    one, _ = dist.new_subgroups(group_size=1)
    grids = {"2x2": sh.pair_grid(make_mesh((2, 2), ("data", "model"))),
             "1x1": sh.PairGrid(one, one, 1, 1, 0, 0, ((rank,),)),
             "1x4": sh.pair_grid(make_mesh((1, 4), ("data", "model")))}
    out, nbytes, counts = {}, None, None
    for name, grid in grids.items():
        local, grid = sh.grid_params(params, grid)
        if name == "2x2":
            nbytes = sum(t.numel() * t.element_size() for t in leaves(local))
        for scheme in schemes:
            coll.reset_counts()
            with torch.no_grad():
                o = make_fold_step(cfg, make_scheme(scheme), shard=grid)(local, a)
            if counts is None:
                counts = coll.counts()
            if rank == 0:
                out[(name, scheme)] = (o["coords"].numpy(), o["distogram"].numpy())
        for scheme in schemes[:2]:
            with torch.no_grad():
                o = make_fold_step(cfg, make_scheme(scheme), shard=grid, chunk_size=chunk)(local, a)
            if rank == 0:
                out[(f"{name} chunked", scheme)] = (o["coords"].numpy(), o["distogram"].numpy())
        if name == "1x4":
            # the same fold on the serving tier's j split (the parameters whole)
            mesh = make_mesh((1, 4), ("data", "model"))
            shard = sh.PairShard(mesh.get_group("model"), 4, mesh.get_local_rank("model"))
            for scheme, c in ((schemes[0], None), *((s, chunk) for s in schemes[:2])):
                with torch.no_grad():
                    o = make_fold_step(cfg, make_scheme(scheme), shard=shard,
                                       chunk_size=c)(params, a)
                if rank == 0:
                    out[("pair shard" if c is None else "pair shard chunked", scheme)] = (
                        o["coords"].numpy(), o["distogram"].numpy())
        if name == "2x2":
            # N - 2 = 62: the grid's 4 fine rows do not divide it, so the
            # triangular attention runs on the blocks themselves; chunked,
            # a rank's 31 rows do not divide into slabs of ``chunk`` either
            for what, c in (("2x2 blocks", None), ("2x2 blocks chunked", chunk)):
                with torch.no_grad():
                    o = make_fold_step(cfg, make_scheme(schemes[0]), shard=grid,
                                       chunk_size=c)(local, a[:, :-2])
                if rank == 0:
                    out[(what, schemes[0])] = (o["coords"].numpy(), o["distogram"].numpy())
    return out if rank == 0 else None, nbytes, counts


def four_rank_jobs(rank, world, jobs, serve_jobs, attn_jobs, grid_args):
    """``sharded_steps(jobs)``, ``sharded_serve_steps(serve_jobs)``,
    ``split_attention(attn_jobs)`` and ``grid_folds(*grid_args)``, in one
    spawn."""
    return (sharded_steps(rank, world, jobs), sharded_serve_steps(rank, world, serve_jobs),
            split_attention(rank, world, attn_jobs), grid_folds(rank, world, *grid_args))
