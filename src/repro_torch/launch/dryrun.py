"""Multi-pod dry-run: trace every (architecture x shape x mesh) cell's step
against the production mesh on fake tensors, then read its per-device
memory, FLOPs, bytes and collectives and its roofline terms (port of
``repro/launch/dryrun.py``; the counting is ``launch/cost_analysis.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun.jsonl

The reference lowers and compiles each cell with XLA on 512 forced host
devices.  The port builds it without allocating anything: a ``"fake"``
process group of 256 ranks (512 for ``--mesh multi``) under
``make_production_mesh``, this process rank 0, every tensor a fake one
(``FakeTensorMode``: shapes and dtypes only), the parameters, optimizer
state, batch and cache laid out as DTensors of the reference's specs
(``parallel/sharding.py``), and the step ``launch/steps.py`` makes run
once while ``cost_analysis.CostMode`` counts rank 0's ops.  The fold cell
runs the reference's production layout, as its dry-run lays the cell out
(``param_shardings(params, mesh, None)`` under ``default_act_rules(mesh,
"train")``): the pair tensor's rows over the data axes and its columns
over ``model`` (``PairGrid``), the sequence track's rows over the data
axes, every parameter the rank's shard by ``param_spec`` (one block's
weights gathered at a time); its peak is held to the same bound as every
LM cell's (``chip_smoke.py`` phase 15).  Kernels
take their plain route (``dispatch.use_backend("ref")``): a kernel wrapper
cannot launch on a fake tensor, and off the TPU the reference's dispatch
picks its plain path too, so its dry-run lowers the same math.

Fake tensors sit on the card (``cuda``) where this build of PyTorch has
one, else on the CPU (``default_device``): autograd on fake CUDA tensors
needs a CUDA build.  Nothing runs on a card either way.

The record keeps the reference's keys, with ``fits_hbm_80g`` (the H100's
80 GB) for ``fits_hbm_16g``, ``trace_s`` for ``compile_s``, no ``xla_*``
counts, and ``cost["widen_bytes_per_dev"]``: the float32 copies of bf16
product operands that the trace makes and the card's one-device product
would not (``cost_analysis``), counted apart and inside the bytes and
peak.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_NAMES, cell_supported, get_config, get_ppm_config,
                                 shapes_for)
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.policy import DISABLED, AAQConfig
from repro_torch.kernels import dispatch
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.steps import (make_fold_step, make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh
from repro_torch.tree import leaves, tree_map

HBM_BYTES = 80e9


def count_params_from_sds(tree) -> int:
    """Elements of a tree of tensors (fake, meta or DTensors: global shapes)."""
    return ca.count_params(tree)


def block_macs(cfg, ns: int):
    """(site, macs) for every matmul in one folding block's pair dataflow
    (a copy of ``benchmarks/compute_cost.py``'s, which the port may not
    import)."""
    hz, th, f, h = cfg.hz, cfg.tri_hidden, cfg.transition_factor, cfg.pair_heads
    t = ns * ns                       # pair tokens
    macs = []
    for sc in ("tri_mul_out", "tri_mul_in"):
        macs += [(f"{sc}.post_ln", 4 * t * hz * th),      # a/b proj+gate
                 (f"{sc}.ab", ns * ns * ns * th),         # triangle einsum
                 (f"{sc}.post_ln", t * th * hz),          # out proj
                 (f"{sc}.gate", t * hz * hz)]             # out gate
    for sc in ("tri_attn_start", "tri_attn_end"):
        macs += [(f"{sc}.qkv_in", 3 * t * hz * hz),
                 (f"{sc}.post_ln", t * hz * h),           # bias proj
                 (f"{sc}.probs", 2 * ns * ns * ns * hz),  # qk + av
                 (f"{sc}.gate", t * hz * hz),
                 (f"{sc}.proj_in", t * hz * hz)]
    macs += [("pair_trans.post_ln", t * hz * f * hz),
             ("pair_trans.proj_in", t * f * hz * hz)]
    return macs


def ppm_model_flops(cfg, ns: int) -> float:
    """Analytic useful FLOPs of one PPM forward: pair-dataflow MACs (the
    Ns^2/Ns^3 terms, ``block_macs``) plus the sequence-track MACs; 2 FLOPs
    per MAC."""
    pair = sum(m for _, m in block_macs(cfg, ns))
    hm, f = cfg.hm, cfg.transition_factor
    seq = (4 * ns * hm * hm + 2 * ns * ns * hm          # seq attn + scores
           + 2 * ns * hm * f * hm                        # transition
           + ns * hm * 64 + ns * ns * 64 * cfg.hz)       # opm
    return 2.0 * cfg.blocks * (pair + seq) * cfg.recycles


def active_params(cfg, n_params: int) -> float:
    """MoE: parameters touched per token (top-k of routed experts)."""
    if getattr(cfg, "moe", None):
        moe = cfg.moe
        expert_p = 3 * cfg.d_model * moe.expert_ff          # glu expert
        inactive = (moe.n_experts - moe.top_k) * expert_p * (
            cfg.layers - (1 if moe.dense_first_layer_ff else 0))
        return n_params - inactive
    return float(n_params)


def default_device() -> torch.device:
    """Where the fake tensors sit: the card where this build has CUDA."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@contextlib.contextmanager
def fake_mesh(mesh_shape, device: torch.device):
    """A ``DeviceMesh`` over a fake process group of its size (this process
    rank 0), the production mesh for ``mesh_shape`` "single"/"multi";
    ``()`` is one device: no group, no mesh (None)."""
    if mesh_shape == ():
        yield None
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own (fake) process group")
    named = mesh_shape in ("single", "multi")
    world = {"single": 256, "multi": 512}[mesh_shape] if named else \
        int(torch.tensor(mesh_shape).prod())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        if named:
            yield make_production_mesh(multi_pod=mesh_shape == "multi",
                                       device_type=device.type)
        else:
            yield make_mesh(tuple(mesh_shape), ("data", "model"), device_type=device.type)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _index_math_on_host():
    """DTensor's ``_StridedShard`` works out a shard's size and offsets from
    an index tensor (``arange``, then ``tolist``), which a fake tensor
    cannot answer: for the trace, that arithmetic runs outside every mode,
    on the host."""
    from torch.distributed.tensor import placement_types as pt
    from torch.utils._python_dispatch import _disable_current_modes
    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def on_host(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)

    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _on(meta_tree, mesh, spec_tree, device):
    """Zeros of ``meta_tree``'s shapes on ``device`` (fake), each a DTensor
    of its spec on ``mesh`` when there is one."""
    zeros = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype, device=device), meta_tree)
    if mesh is None:
        return zeros
    from repro_torch.tree import unflatten
    flat, specs = leaves(zeros), _spec_leaves(spec_tree)
    if len(flat) != len(specs):
        raise ValueError(f"{len(flat)} tensors for {len(specs)} specs")
    return unflatten(zeros, [sh.distribute(t, mesh, s) for t, s in zip(flat, specs)])


def _spec_leaves(tree):
    """The ``P`` leaves of a spec tree in ``leaves`` order (a ``P`` is a
    tuple, which ``leaves`` would walk into)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in _spec_leaves(v)]
    return [tree]


def _lm_cell(rec, cfg, shape, mesh, aaq, quantized_kv, dev, mode):
    """Build and trace one LM cell's step under ``mode``; the model FLOPs."""
    gen = torch.Generator(device=dev).manual_seed(0)
    place = ((lambda path, part: sh.distribute_params(part, mesh, cfg, path))
             if mesh is not None else lambda path, part: part)
    params = lm.init_params(gen, cfg, place=place)
    n_params = count_params_from_sds(params)
    qkv = quantized_kv and shape.step == "decode" and cfg.kind in ("dense", "vlm")
    rec["quantized_kv"] = qkv
    specs = lm.input_specs(cfg, shape, quantized_kv=qkv)
    rules = bspecs = cspecs = None
    if mesh is not None:
        rules = sh.default_act_rules(mesh, shape.step, cfg)
        bspecs = sh.batch_specs(cfg, shape, mesh, quantized_kv=qkv)
        cspecs = bspecs.get("cache")
        if cspecs is not None and "k" in cspecs:     # dense-style KV cache archs
            rules["kv_cache"] = sh.P(*cspecs["k"][1:])   # per-layer view
        bspecs = bspecs["batch"]
    batch = _on(specs["batch"], mesh, bspecs, dev)
    with sh.act_rules(rules):
        if shape.step == "train":
            opt = adamw.init(params)
            step = make_train_step(cfg, aaq=aaq)
            inputs = (params, opt, batch)
        elif shape.step == "prefill":
            step = make_prefill_step(cfg, aaq=aaq)
            inputs = (params, batch)
        else:
            cache = _on(specs["cache"], mesh, cspecs, dev)
            step = make_serve_step(cfg, aaq=aaq)
            inputs = (params, batch, cache)
        mode.track(inputs)
        # the train step scopes its own mixed ops (``steps.value_and_grad``)
        mixed = sh.mixed_ops(params) if shape.step != "train" else contextlib.nullcontext()
        with mode, mixed:
            out = step(*inputs)
        mode.outputs(out)
    tokens = shape.global_batch * (shape.seq_len if shape.step != "decode" else 1)
    return n_params, ca.model_flops_estimate(n_params, tokens, shape.step,
                                             n_active=active_params(cfg, n_params))


def _fold_cell(shape, mesh, aaq, dev, mode, cfg=None):
    """Build and trace the fold cell on the production layout (the module
    docstring): a ``PairGrid`` over the mesh, the parameters cut to rank
    0's shards (``grid_params``; the whole ones dropped before the trace),
    the batch whole (``ppm_input_shardings``)."""
    from repro_torch.core.schemes import AAQScheme, FP16Baseline
    from repro_torch.models.ppm import init_ppm
    cfg = cfg or get_ppm_config()
    params = init_ppm(cfg, seed=0, device=dev)
    n_params = count_params_from_sds(params)
    shard = None
    if mesh is not None:
        params, shard = sh.grid_params(params, sh.pair_grid(mesh))
    aatype = torch.zeros((shape.global_batch, shape.seq_len), dtype=torch.int32, device=dev)
    step = make_fold_step(cfg, AAQScheme(cfg=aaq) if aaq.enabled else FP16Baseline(),
                          shard=shard)
    mode.track((params, aatype))
    with mode, torch.inference_mode():
        out = step(params, aatype)
    mode.outputs(out)
    return n_params, ppm_model_flops(cfg, shape.seq_len) * shape.global_batch


def lower_cell(arch: str, shape: ShapeSpec, multi_pod: bool = False,
               aaq: AAQConfig = DISABLED, quantized_kv: bool = False, *,
               cfg=None, mesh_shape=None, mode: ca.CostMode | None = None) -> dict:
    """Trace one cell on fake tensors; returns the record dict.

    ``cfg`` replaces the architecture's config (a reduced one in tests);
    ``mesh_shape`` replaces the production mesh: a (data, model) shape,
    or ``()`` for one device with no mesh (plain tensors).  ``mode``: the
    (fresh) ``CostMode`` to count with, for a caller that reads its
    diagnostics (``largest``) after."""
    dev = default_device()
    where = ("multi" if multi_pod else "single") if mesh_shape is None else mesh_shape
    t0 = time.monotonic()
    mode = mode if mode is not None else ca.CostMode()
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_mesh(where, dev) as mesh, _index_math_on_host(), FakeTensorMode(), \
            dispatch.use_backend("ref"):
        chips = 1 if mesh is None else mesh.size()
        rec = {"arch": arch, "shape": shape.name, "step": shape.step,
               "mesh": "multi" if multi_pod else "single", "chips": chips,
               "device": dev.type}
        if mesh_shape is not None:
            rec["mesh_shape"] = list(mesh_shape)
        if arch == "esmfold_ppm":
            n_params, model_flops = _fold_cell(shape, mesh, aaq, dev, mode, cfg)
        else:
            n_params, model_flops = _lm_cell(rec, cfg or get_config(arch), shape, mesh,
                                             aaq, quantized_kv, dev, mode)
    rec["trace_s"] = round(time.monotonic() - t0, 1)
    mem = mode.mem
    rec["mem"] = mem
    rec["fits_hbm_80g"] = bool(mem["peak_bytes_per_dev"] < HBM_BYTES)
    mc = mode.cost()
    rl = ca.roofline_from_module(mc, chips, model_flops)
    rec["cost"] = {"flops_per_dev": mc.flops, "bytes_per_dev": mc.bytes,
                   "widen_bytes_per_dev": mode.widen_bytes}
    rec["collectives"] = {"per_device_bytes": mc.coll, "counts": mc.coll_counts,
                          "loops": mc.loops}
    rec["roofline"] = {
        "t_compute_s": rl.t_compute, "t_memory_s": rl.t_memory,
        "t_collective_s": rl.t_collective, "bottleneck": rl.bottleneck,
        "model_flops": model_flops, "hlo_flops_global": rl.flops_global,
        "useful_fraction": (model_flops / rl.flops_global if rl.flops_global else 0.0),
        "roofline_fraction": rl.roofline_fraction,
    }
    rec["n_params"] = n_params
    return rec


def roofline_line(tag: str, rec: dict, mode: ca.CostMode | None = None) -> str:
    """The cell's line; with its ``CostMode``, the widened copies and the
    largest storage an op made (and that op) beside the peak."""
    r = rec["roofline"]
    extra = ""
    if mode is not None and mode.largest is not None:
        n, op, shape, dt = mode.largest
        extra = (f" widened={rec['cost']['widen_bytes_per_dev'] / 1e9:.3f}GB "
                 f"largest={n / 1e9:.3f}GB {op}{list(shape)} {dt}")
    return (f"[ok]   {tag}: peak/dev={rec['mem']['peak_bytes_per_dev'] / 1e9:.2f}GB "
            f"t=(c {r['t_compute_s']:.3e}, m {r['t_memory_s']:.3e}, "
            f"l {r['t_collective_s']:.3e}) bound={r['bottleneck']} "
            f"trace={rec['trace_s']}s{extra}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quant", action="store_true",
                    help="enable AAQ in the traced dataflow")
    ap.add_argument("--quant-kv", action="store_true",
                    help="decode cells use the INT8 AAQ KV cache")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) + ["esmfold_ppm"] if args.all else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    aaq = AAQConfig(enabled=True) if args.quant else DISABLED

    rows = []
    out_f = None
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        out_f = open(args.out, "a")

    def record(r):
        rows.append(r)
        if out_f:
            out_f.write(json.dumps(r) + "\n")
            out_f.flush()

    for arch in archs:
        cfg = get_config(arch) if arch != "esmfold_ppm" else get_ppm_config()
        for shape in shapes_for(arch):
            if args.shape and shape.name != args.shape:
                continue
            ok, reason = cell_supported(cfg, shape)
            for mp in meshes:
                tag = f"{arch} x {shape.name} x {'multi' if mp else 'single'}"
                if not ok:
                    record({"arch": arch, "shape": shape.name,
                            "mesh": "multi" if mp else "single", "skipped": reason})
                    print(f"[skip] {tag}: {reason}", flush=True)
                    continue
                try:
                    mode = ca.CostMode()
                    rec = lower_cell(arch, shape, mp, aaq=aaq, quantized_kv=args.quant_kv,
                                     mode=mode)
                    print(roofline_line(tag, rec, mode), flush=True)
                    record(rec)
                except Exception as e:
                    traceback.print_exc()
                    record({"arch": arch, "shape": shape.name,
                            "mesh": "multi" if mp else "single", "error": str(e)[:500]})
                    print(f"[FAIL] {tag}: {e}", flush=True)
    if out_f:
        out_f.close()
    n_fail = sum(1 for r in rows if "error" in r)
    print(f"done: {len(rows)} cells, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
