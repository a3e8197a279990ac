#!/usr/bin/env python3
"""Four diagnostics of the port, on the card (or, smaller, on the CPU).

    python3 chip_diag.py batch     # where a fold stops being batch-invariant
    python3 chip_diag.py dryrun    # a dry-run cell's FLOPs by aten op
    python3 chip_diag.py profile   # where the 2,000-residue fold's replay goes
    python3 chip_diag.py f32plans  # float32 flash above head dim 256: two plans

``batch``: the two float32 kernel variants alone (``aaq_matmul_f32`` on
batch 1's rows against batch 4's, ``flash_mha_f32`` on batch row 0),
then the reduced config's fold of ``examples/fold_server``'s first protein
(26 residues, bucket 32) alone against the same protein in act one's
batch of 4, under AAQ and the unquantized scheme, on the kernel route
(``auto``) and the plain route (``ref``): bitwise or not, the largest
coordinate gap and the TM; the protein folded alone twice (bitwise, or
the fold is not deterministic) and in a batch of four copies of itself;
under the unquantized scheme each trunk stage's first row (the
embedding, every op of every block, the structure module) between the
protein alone and the four copies, naming the stages that differ with
equal inputs, and inside the first such trunk op every aten op's first
row the same way (the rows of a ``per_row`` after its first left out, so
the two runs align op for op); and for each, every op of the batch-4
fold run again on the first quarter of its inputs' rows: dim 0 where an
input's dim 0 is the output's, else, for products, ``torch.linalg`` and
elementwise ops, the first dim d whose size the inputs of the output's
rank share and four divides (a batch that a permute moved off dim 0): an
op whose output's first quarter then differs follows the row count in
itself, whatever its inputs.  Ops run through a kernel wrapper (ctypes)
do not pass the dispatcher, so each wrapper's launches in the batch-4 fold
are run again on their first batch quarter too (q, k, v, the key lengths
and the bias's rows of the first protein: triangular attention's B x N
rows as batch; the float32 matmul's first quarter of tokens) and compared
on it.  All of it twice: with the fold's float32 products a batch row at a
time (``device.rows_alone``, as the fold runs) and without.

``dryrun``: ``launch.dryrun.lower_cell`` of qwen1.5-0.5b x train_4k on the
fake 16 x 16 mesh at 1 and 2 layers (vocabulary 4,096) and at 1 layer
(vocabulary 32,768), each device's FLOPs by aten op: the count is exactly
linear in both, which gives the whole cell's; with a card, the whole cell
(24 layers, 151,936) traced as well.  The fake tensors sit on the card
where there is one, so it compares the card's PyTorch with the CPU's.

``profile``: ``launch.serve``'s engine path with ``--profile`` (the
CLI's ``serve_ppm_engine``, handed the full esmfold_ppm config on the card)
on one 2,000-residue request in bucket 2,048 at ``--chunk-size 64`` under
the 4,096 MB budget (phase 6 of ``chip_smoke.py``'s long fold) with
``--warmup``, so that the profiled window holds the graph's replay and not
its capture; then the trace read back: the window, the device's busy time
and the idle gaps (in the window and between the first and the last device
event), and the device time by family (flash by head dim: D = 32 is the
triangular attention's (64, 2048, 4, 32) slab; the quantize forms;
``aaq_matmul_wg`` and ``aaq_matmul``; cuBLAS's products; PyTorch's elementwise and reduction
kernels; copies) and by kernel.  On the CPU: the reduced config, 60
residues in bucket 64 at chunk 16, no device time.

``f32plans`` (the card only): a causal (2, 512, 8, 320) prefill in f32
and in bf16 (widened as the wrapper widens it) through
``flash_mha_f32_launch`` under the plan ``f32_plan`` gives (one panel of
320 columns, the block's warps in pairs) and under two panels of 160
columns (each recomputing the logits), each held to ``flash_mha_plain``
by ``chip_smoke._flash_close`` and timed with ``chip_smoke.time_ms``,
with the plain version's time.

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
        _print(f"flash_mha_f32 D={hd}: batch 1 bitwise batch 4's row: "
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

    # ops whose batch may ride a dim other than 0 (after a permute)
    elsewhere = ("mm", "bmm", "addmm", "baddbmm", "linalg", "add", "sub", "mul", "div",
                 "where", "exp", "sigmoid", "relu", "rsqrt", "neg", "pow", "clamp",
                 "maximum", "minimum", "_to_copy", "clone")

    class Intrinsic(TorchDispatchMode):
        """Each op again on the first quarter of its rows: dim 0, or for
        the ops of ``elsewhere`` the first dim the inputs share that four
        divides."""

        def __init__(self):
            super().__init__()
            self.ops, self.moved, self.variant = 0, 0, {}

        def _dim(self, name, out, args):
            """(the dim the batch rides, which args to cut there), or
            (None, None).  Past dim 0 every input of the output's rank
            must hold that dim whole or broadcast it."""
            op = getattr(self._func, "_opname", name)
            dims = out.dim() if out.shape[0] != 1 and any(e in op for e in elsewhere) else 1
            for d in range(dims):
                if out.shape[d] % 4:
                    continue
                if d == 0:
                    rows = [isinstance(a, torch.Tensor) and a.dim() > 0
                            and a.shape[0] == out.shape[0] for a in args]
                else:
                    same = [isinstance(a, torch.Tensor) and a.dim() == out.dim() for a in args]
                    if any(s_ and a.shape[d] not in (1, out.shape[d])
                           for a, s_ in zip(args, same)):
                        continue
                    rows = [s_ and a.shape[d] == out.shape[d] for a, s_ in zip(args, same)]
                if any(rows):
                    return d, rows
            return None, None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = str(func)
            if (not isinstance(out, torch.Tensor) or not out.is_floating_point()
                    or out.dim() == 0 or "empty" in name
                    or func._schema.is_mutable or any(r.alias_info is not None
                                                      for r in func._schema.returns)):
                return out
            self._func = func
            d, rows = self._dim(name, out, args)
            if d is None:
                return out
            q = out.shape[d] // 4
            self.ops += 1
            self.moved += d > 0
            part = func(*(a.narrow(d, 0, q) if r else a for a, r in zip(args, rows)), **kwargs)
            if not torch.equal(part, out.narrow(d, 0, q)):
                key = (f"{name} (batch on dim {d})",
                       tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)),
                       str(out.dtype))
                self.variant[key] = self.variant.get(key, 0) + 1
            return out

    @contextlib.contextmanager
    def wrappers_on_first_row(variant: dict, calls: list):
        """Each kernel wrapper's launch again on its first batch quarter,
        compared there."""
        from repro_torch.kernels.aaq_matmul import ops as mm_ops
        fl, mm = dispatch.flash_mha_kernel, mm_ops.aaq_matmul_kernel

        def quarter(t):
            return t if t is None or t.shape[0] % 4 else t[:t.shape[0] // 4]

        def fl_checked(q, k, v, bias=None, kvl=None, **kw):
            o = fl(q, k, v, bias, kvl, **kw)
            calls[0] += 1
            if q.shape[0] % 4 == 0:
                part = fl(quarter(q), quarter(k), quarter(v),
                          bias if bias is None or bias.shape[0] % 4 else quarter(bias),
                          quarter(kvl), **kw)
                if not torch.equal(part, o[:q.shape[0] // 4]):
                    key = ("flash_mha_kernel", (tuple(q.shape), None if bias is None
                                                else tuple(bias.shape)), str(q.dtype))
                    variant[key] = variant.get(key, 0) + 1
            return o

        def mm_checked(q, s, ov, oi, w, **kw):
            y = mm(q, s, ov, oi, w, **kw)
            calls[1] += 1
            if q.shape[0] % 4 == 0:
                part = mm(quarter(q), quarter(s), quarter(ov), quarter(oi), w, **kw)
                if not torch.equal(part, y[:q.shape[0] // 4]):
                    key = ("aaq_matmul_kernel", (tuple(q.shape), tuple(w.shape)), str(y.dtype))
                    variant[key] = variant.get(key, 0) + 1
            return y

        dispatch.flash_mha_kernel, mm_ops.aaq_matmul_kernel = fl_checked, mm_checked
        try:
            yield
        finally:
            dispatch.flash_mha_kernel, mm_ops.aaq_matmul_kernel = fl, mm

    from repro_torch import device as dev_mod
    from repro_torch.models.ppm import model as ppm_model
    from repro_torch.models.ppm import trunk as ppm_trunk
    n0 = len(trace[0])

    @contextlib.contextmanager
    def stages(record: list):
        """Each trunk op's, the embedding's and the structure module's
        first batch row in and out, in call order."""
        names = [(ppm_trunk, f) for f in ("seq_attn_apply", "seq_transition_apply", "opm_apply",
                                          "tri_mul_apply", "tri_attn_apply",
                                          "pair_transition_apply")]
        names += [(ppm_model, "input_embedding"), (ppm_model.st, "structure_apply")]
        saved = [(m, f, getattr(m, f)) for m, f in names]

        def first(x):
            if isinstance(x, torch.Tensor):
                return x[:1].detach().float().cpu().clone()
            if isinstance(x, tuple):
                return tuple(first(t) for t in x)
            return None

        def wrap(f, fn):
            def run(*args, **kw):
                out = fn(*args, **kw)
                record.append((f, [first(a) for a in args if isinstance(a, torch.Tensor)],
                               first(out)))
                return out
            return run
        for m, f, fn in saved:
            setattr(m, f, wrap(f, fn))
        try:
            yield
        finally:
            for m, f, fn in saved:
                setattr(m, f, fn)

    def same(a, b):
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        return a is None or torch.equal(a, b)

    class Ops(TorchDispatchMode):
        """Every op's output (its first row) in call order, views and
        ``cat`` left out, outside the rows after the first of a
        ``per_row`` (so a batch of 4 and a batch of 1 align op for op)."""

        def __init__(self):
            super().__init__()
            self.rows, self.skip = [], False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not self.skip and isinstance(out, torch.Tensor) and out.is_floating_point() \
                    and out.dim() and "cat" not in str(func) and \
                    not any(r.alias_info is not None for r in func._schema.returns):
                ins = [a[:1].detach().float().cpu().clone() for a in args
                       if isinstance(a, torch.Tensor) and a.dim() and a.is_floating_point()]
                self.rows.append((str(func), tuple(out.shape),
                                  out[:1].detach().float().cpu().clone(), ins))
            return out

    @contextlib.contextmanager
    def ops_of(stage: str, call: int, mode: Ops):
        """``mode`` on the ``call``-th call of the trunk op ``stage`` only;
        each ``per_row`` records its first row alone."""
        from repro_torch import device as dmod
        from repro_torch.core import schemes as smod
        from repro_torch.models import common as cmod
        fn, pr, seen = getattr(ppm_trunk, stage), dmod.per_row, [0]
        users = (ppm_trunk, smod, cmod)

        def per_row(f, *xs):
            if not (getattr(dmod._ROWS, "on", False) and xs[0].is_cuda and xs[0].dim() >= 3
                    and xs[0].shape[0] > 1):
                return f(*xs)
            outs = []
            for i in range(xs[0].shape[0]):
                rows = [t[i:i + 1] for t in xs]
                prev, mode.skip = mode.skip, mode.skip or i > 0
                outs.append(f(*rows))
                mode.skip = prev
            return torch.cat(outs)

        def run(*a, **kw):
            seen[0] += 1
            if seen[0] != call:
                return fn(*a, **kw)
            with mode:
                return fn(*a, **kw)
        setattr(ppm_trunk, stage, run)
        for m in users:
            m.per_row = per_row
        try:
            yield
        finally:
            setattr(ppm_trunk, stage, fn)
            for m in users:
                m.per_row = pr

    def first_ops(route, scheme, stage, call):
        """The ops inside the ``call``-th call of ``stage`` whose first row
        differs between batch 1 and four copies while their inputs' do
        not."""
        one, four = Ops(), Ops()
        with ops_of(stage, call, one):
            fold([trace[0]], route, scheme)
        with ops_of(stage, call, four):
            fold([trace[0]] * 4, route, scheme)
        found = []
        for i, ((f, sh1, o1, i1), (_, sh4, o4, i4)) in enumerate(zip(one.rows, four.rows)):
            if o1.shape == o4.shape and not torch.equal(o1, o4) and \
                    all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(i1, i4)):
                found.append(f"#{i} {f} out {sh1} / {sh4} inputs "
                             f"{[tuple(a.shape) for a in i1]} max |d| "
                             f"{float((o1 - o4).abs().max()):.3e}")
        return len(one.rows), len(four.rows), found

    def first_stages(route, scheme):
        """The stages whose first row differs between batch 1 and batch 4,
        those with equal inputs first (the op itself follows the batch)."""
        one, four = [], []
        with stages(one):
            fold([trace[0]], route, scheme)
        with stages(four):
            fold([trace[0]] * 4, route, scheme)
        own, carried = [], 0
        for i, ((f, ins1, out1), (_, ins4, out4)) in enumerate(zip(one, four)):
            if same(out1, out4):
                continue
            if all(same(a, b) for a, b in zip(ins1, ins4)):
                gap = max(float((x - y).abs().max()) for x, y in
                          zip(out1 if isinstance(out1, tuple) else (out1,),
                              out4 if isinstance(out4, tuple) else (out4,)))
                # (stage, which call of it, the line)
                own.append((f, sum(1 for g, _, _ in one[:i + 1] if g == f),
                            f"#{i} {f} (max |d| {gap:.3e})"))
            else:
                carried += 1
        return len(one), own, carried
    for alone in (True, False):
        ppm_model.rows_alone = dev_mod.rows_alone if alone else contextlib.nullcontext
        _print(f"-- a float32 fold's products a batch row at a time (rows_alone): {alone}")
        for route in ("auto", "ref"):
            for name, scheme in schemes.items():
                c1 = fold([trace[0]], route, scheme)[0, :n0].float().cpu()
                c4 = fold(batch4, route, scheme)[0, :n0].float().cpu()
                c1b = fold([trace[0]], route, scheme)[0, :n0].float().cpu()
                copies = fold([trace[0]] * 4, route, scheme)[:, :n0].float().cpu()
                _print(f"fold {route} {name}: batch-1 coords bitwise batch-4's: "
                       f"{torch.equal(c1, c4)}, max |d| {(c1 - c4).abs().max().item():.3e}, "
                       f"TM {float(tm_score(c1, c4)):.6f}; batch 1 twice bitwise: "
                       f"{torch.equal(c1, c1b)}; four copies bitwise batch 1: "
                       f"{[torch.equal(c1, c) for c in copies]}")
                if name == "fp":
                    n_st, own, carried = first_stages(route, scheme)
                    _print(f"  {route} {name}, four copies against one: of {n_st} stages "
                           f"{len(own)} differ with equal inputs {[o[2] for o in own[:6]]}, "
                           f"{carried} more carry a difference in")
                    if own and hasattr(ppm_trunk, own[0][0]):
                        stage, nth, _ = own[0]
                        n1, n4, found = first_ops(route, scheme, stage, nth)
                        _print(f"    inside {stage} call {nth}: {n1} / {n4} ops recorded; "
                               f"{len(found)} differ with equal inputs: {found[:8]}")
                mode = Intrinsic()
                wrapped, calls = {}, [0, 0]
                with wrappers_on_first_row(wrapped, calls):
                    fold(batch4, route, scheme, mode)
                _print(f"  {route} {name}, batch 4: {mode.ops} ops run again on their first "
                       f"quarter ({mode.moved} with the batch off dim 0); "
                       f"{len(mode.variant)} kinds of op differ in themselves"
                       + "".join(f"\n    {op} {dt} inputs {shapes}: {n} calls"
                                 for (op, shapes, dt), n in sorted(mode.variant.items()))
                       + f"\n  wrappers: {calls[0]} flash and {calls[1]} aaq_matmul launches "
                       f"run again on their first quarter; {len(wrapped)} kinds differ"
                       + "".join(f"\n    {op} {dt} {shapes}: {n} calls"
                                 for (op, shapes, dt), n in sorted(wrapped.items())))
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


def profile_fold(torch) -> None:
    import contextlib
    import io
    import shutil
    import chip_smoke as cs                     # the trace reader, phase 17's
    from repro_torch.configs import get_ppm_config, reduce_ppm_config
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.launch import serve
    from repro_torch.models.ppm import init_ppm
    card = torch.cuda.is_available()
    dev = torch.device("cuda" if card else "cpu")
    cfg = get_ppm_config() if card else reduce_ppm_config()
    residues, bucket, chunk = (2000, 2048, 64) if card else (60, 64, 16)
    params = init_ppm(cfg, seed=0, device=dev)
    seq = ProteinSampler(seed=11).sample(300, length=residues)   # phase 6's long request
    log_dir = ROOT / "build" / "profile_long"
    shutil.rmtree(log_dir, ignore_errors=True)
    args = serve.parser().parse_args(
        ["--mode", "ppm", "--device", dev.type, "--buckets", str(bucket), "--max-batch", "1",
         "--chunk-size", str(chunk), "--mem-budget-mb", "4096", "--no-fidelity", "--warmup",
         "--profile", str(log_dir)])
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve.serve_ppm_engine(args, cfg, params, [seq], (bucket,), dev)
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    _print("\n".join(ln for ln in lines if not ln.startswith("# bucket=")))
    if rc != 0:
        raise SystemExit(f"serve_ppm_engine returned {rc}")
    (path,) = sorted(log_dir.glob("*.pt.trace.json"))
    t1 = time.perf_counter()
    tr = cs.trace_summary(path)
    _print(f"profile: {residues} residues in bucket {bucket}, chunk {chunk}, {cfg.blocks} blocks "
           f"hz {cfg.hz} on {dev}: serve_ppm_engine {wall:.1f} s with warm-up; trace "
           f"{path.stat().st_size / 2**20:.1f} MiB read in {time.perf_counter() - t1:.1f} s; "
           f"ranges {dict(tr['ranges'])}")
    window, busy, span = tr["window_us"], tr["busy_us"], tr["device_span_us"]
    _print(f"profile: window {window / 1e3:.1f} ms; host time inside the engine's ranges "
           + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in sorted(tr["range_us"].items())))
    if not tr["kernels"]:
        _print("profile: the profiler recorded no device time (device busy: not measured)")
        return
    _print(f"profile: {tr['kernels']} kernels; device busy {busy / 1e3:.1f} ms "
           f"({100 * busy / window:.1f}% of the window); first to last device event "
           f"{span / 1e3:.1f} ms, idle gaps inside it {(span - busy) / 1e3:.1f} ms "
           f"({100 * (span - busy) / span:.1f}%); idle in the window "
           f"{(window - busy) / 1e3:.1f} ms")
    for fam, us in tr["by_family"].most_common():
        _print(f"  {us / 1e3:10.1f} ms  {100 * us / span:5.1f}% of the device span  "
               f"{tr['family_calls'][fam]:7d}x  {fam}")
    _print(f"  {(span - busy) / 1e3:10.1f} ms  {100 * (span - busy) / span:5.1f}% of the "
           f"device span           idle gaps")
    for name, us in tr["by_name"].most_common(15):
        _print(f"  {us / 1e3:10.1f} ms  {tr['calls'][name]:7d}x  {name[:120]}")


def f32_plans(torch) -> None:
    if not torch.cuda.is_available():
        _print("f32plans: needs the card")
        return
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    lib = build.library()
    g = torch.Generator(device="cuda").manual_seed(5)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((2, 512, 8, 320), generator=g, device="cuda").to(dt)
                   for _ in range(3))
        args, qw, kw, vw = fa._flash_launch(q, k, v, causal=True)
        want = fa.flash_mha_plain(q, k, v, causal=True)
        one = args.plan
        bk, q_smem, smem = fa._f32_layout(320, 192, fa.F32_ROWS)
        two = fa.F32Plan(dv=160, cols=192, rows=fa.F32_ROWS, bk=bk, q_smem=q_smem, smem=smem,
                         panels=2, blocks=2 * one.blocks)
        for label, plan in (("f32_plan's", one), ("two panels of 160", two)):
            o = torch.empty(q.shape, device="cuda")

            def run(plan=plan, o=o):
                build.check(lib.flash_mha_f32_launch(
                    qw.data_ptr(), kw.data_ptr(), vw.data_ptr(), None, None, o.data_ptr(),
                    *args.c_args(), *plan.c_args(), torch.cuda.current_stream().cuda_stream),
                    "flash_mha_f32")
            run()
            err = cs._flash_close(torch, o.to(dt), want, v, f"D 320 {dt} {label}")
            _print(f"D 320 {dt} causal (2, 512, 8, 320), {label} plan {plan}: kernel_ms "
                   f"{cs.time_ms(torch, run):.4f}, max |err| {err:.3e}")
        plain = cs.time_ms(torch, lambda: fa.flash_mha_plain(q, k, v, causal=True), iters=3)
        _print(f"D 320 {dt}: plain_ms {plain:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="diagnostics of the port")
    ap.add_argument("what", choices=("batch", "dryrun", "profile", "f32plans"))
    args = ap.parse_args(argv)
    import torch
    if torch.cuda.is_available():
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        _print(f"card: {smi}; torch {torch.__version__}")
    {"batch": batch, "dryrun": dryrun_flops, "profile": profile_fold,
     "f32plans": f32_plans}[args.what](torch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
