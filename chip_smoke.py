#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-only   # phases 1, 2, 11, 12, 13 and 16 alone
    python3 chip_smoke.py --mesh-only --phases 11,13

``--mesh-only`` runs the build, the mesh tier, multi-device training,
the fleet on a mesh and the grid fold alone: on a host of two cards or
more that is the run of phases 11(c), 12(b) and 13 (two replicas on a 1x2
mesh) across them, and on four 16(c), without the phases that need one
card.  ``--phases`` picks some of 11, 12, 13 and 16.

Phases, each fatal on failure:
  1. environment: the card (nvidia-smi name and power limit), torch, CUDA
     and nvcc versions; no CUDA device -> exit 1;
  2. build: the CUDA kernels from ``src/repro_torch/csrc``; ptxas's
     registers and spills of every flash instantiation, the tensor-core
     kernel's, the fold's Hopper kernel's (``flash_wg_kernel``), the decode
     kernel's (``flash_dec_kernel``) and the prefill kernel's
     (``flash_pf_kernel``), printed, and a spill fails;
  3. each kernel variant against its plain PyTorch version on the card at
     the main path's shapes and at long N (seq attention at N = 1024 and
     2048, triangular attention at N = 1024), with its time at every
     main-path shape, the plain version's, the least time the card could
     take (``bound_ms``) and one PyTorch library call's; the fold's
     attention on the Hopper kernel (``flash_mha_wg``: tri at N = 200 and
     256 with padding, seq, structure, N = 1024 on 8 rows, seq N = 2048,
     the engine's batch-4 and slab shapes, a mesh rank's rows, also with a
     bias gathered keys outermost, and a grid rank's block; the last ones
     timed in phases 6, 11 and 16), each also bitwise between two launches
     and, row by row, against the row launched alone, with the tensor-core
     kernel's time at the same shape through its C entry point
     (``tc_ms``); both forms of the
     AAQ quantize kernel (``aaq_quantize`` for the linears, the fake-quant
     ``aaq_fake_quant`` for the ``act`` sites) bitwise; and the LM decode
     tenant's shapes: both quantize forms at the LM zoo's residual widths
     (1,024 to 6,144, bf16 and f32, bits 4 and 8, k 0 and 4) bitwise and
     timed, and at the training run's (phase 10) shapes; flash with one
     query row a slot against a 256-row
     KV ring (``kv_valid_len`` 1, 17, 255, 256; GQA 16/2 at head dim 128)
     on the decode kernel (``flash_mha_dec``), a causal prefill on the
     prefill kernel (``flash_mha_pf``), ``aaq_quantize`` on KV rows
     bitwise; and flash at the model zoo's shapes (phase 9's): phi-3's head
     dim 96, DeepSeek's MLA at 192 with v at 128 padded, RecurrentGemma's
     256 with MQA and a 2,048 window and its decode row against a
     2,048-row ring, whisper's 1,500 encoder frames, the cross attention
     onto them and its decoder's causal prefill, mixtral's GQA 48/8 with a
     4,096 window, and every other decode step of phase 9 (MLA, phi-3,
     whisper's self and cross, mixtral), each timed against SDPA; every
     shape on the decode or prefill kernel also bitwise between two
     launches and, row by row, against the row launched alone, with the
     tensor-core kernel's time at the same shape (``tc_ms``); and flash in
     float32 on the float32 kernels (``flash_mha_f32``, decode steps on
     ``flash_mha_f32_dec``: 3xTF32 on the tensor cores) at head dims 96, 192
     and 256 (phi-3's prefill and decode at phase 12(c)'s shapes, MLA's and
     RecurrentGemma's at phase 9's), at head dim 48 and at 320 (above 256:
     the float32 kernel in either type), the same checks, the float32 rows'
     bound at the CUDA cores' float32 rate;
  4. whole forward, kernels vs the plain references, 2 blocks at full
     esmfold_ppm width, one padded request, with two controls that the
     lightnobel_aaq gate must reject;
  5. the sequential server at full esmfold_ppm width (48 blocks, bf16,
     seeded random weights): 4 short requests, then one of 1,000 residues
     in bucket 1,024; in each run every main-path kernel launched and no
     plain version ran; then one profiled fold per scheme at N = 250
     (device-busy share, top kernels, each kernel's device time) and the
     main-path launches per fold at each kernel shape, with one
     ``aaq_fake_quant`` launch for each enabled ``AAQScheme.act`` call;
  6. the batching engine at full esmfold_ppm width: first the kernels at
     its new shapes (batch 4 in bucket 256, where triangular, seq and
     structure attention each get every protein's own key length, and the
     chunked bucket-2,048 slabs), each against its plain version and timed;
     then ``FoldClient`` (ring depth 2, batches up to 4,
     ``chunk_size="auto"`` at the default 4,096 MB budget, fidelity on)
     serves 8 requests in buckets 96/192/256, one
     launch at batch 4, every batch a replay of the CUDA graph captured
     once for its key; each request held to TM >= 0.9995 against the same
     request folded at batch 1 by the sequential server; captures equal to
     the distinct keys, and a second pass of the same requests captures
     nothing and gives the same coords; a graph replay against the eager
     forward of the same key and inputs; main-path launches read from the
     capture pass (replays run no wrapper); every main-path kernel launched
     and no plain version; the chunked path's slabbed input embedding,
     structure pair bias and distogram head against their unslabbed forms
     at bucket 1,024; then one 2,000-residue request in bucket 2,048
     through the chunked key (chunk, wall, the memory reserved, the graph's
     capture time and node count), whose peak above what was held before
     it must stay within the 4,096 MB budget it was admitted under, through
     its graph and eager (the planner's estimate, the budget and both peaks
     on one line), and so must its key's graph pool and the peak of
     ``memory_reserved`` above its level before the request (warm-up,
     capture and replay; pool/peak printed, and the segments outside the
     pool that came with the key), with the peak of each stage;
  7. the fleet: ``FoldHTTPServer`` over a ``FleetRouter`` of 2 engine
     replicas at full width on 127.0.0.1:0 (phase 6's short settings,
     fidelity on, each replica warmed with one graph per key): two passes
     of the 8 requests posted concurrently over HTTP, each followed over
     SSE (legal order), decoded off the wire bitwise equal to its
     replica's own result and TM >= 0.9995 against the sequential batch-1
     fold; /healthz, /v1/fleet, /metrics and /metrics/replica/<i> scraped
     (one capture per key per replica, none while serving); then replica 0
     failed under a burst of 16 requests with ``max_restarts=1``: every
     request ok, the requeued ones with one SUBMITTED, the rebuilt replica
     capturing while replica 1 only replays, the old engine's graph pool
     released; then one N = 250 fold under each of the five comparison
     schemes through the sequential server (fold time, TM against
     baseline_fp16; finite coords gated);
  8. the LM decode tenant: qwen1.5-0.5b at full width (24 layers, d_model
     1,024, bf16, random weights from seed 0) through
     ``LMClient(window=256, max_slots=4)`` over 6 prompts of 4-16 tokens,
     16 new tokens each, under ``baseline_fp16`` and then
     ``lightnobel_aaq``: all served, one CUDA graph captured at warm-up
     and none after, 24 decode-kernel launches (``flash_mha_dec``) a
     captured step and no other flash variant, and under AAQ 48
     ``aaq_quantize``, no plain version, KV bytes a request exactly the
     reference's formula, layer 0's ring rows against the rows they came
     from (raw: bitwise; AAQ: within half a quantization step), a graph
     replay against the eager step bitwise (logits and ring), one request
     alone against the same request in the batch bitwise; the served
     step against the plain path on the card (``kernels="ref"``, same
     weights): first logits within a limit set from readings, the first
     token equal wherever the top-2 gap rules out a flip, under fp16 each
     prompt's full-sequence prefill against the served first logits, and
     ``unembed`` against the widened float32 product; the AAQ-vs-fp16
     first-token logit drift printed, not gated; ``/v1/generate`` over
     HTTP to 2 replicas (SSE token events in order, wire tokens bitwise
     the in-process client's, ``workload="lm"`` series); then qwen2.5-3b
     at full width (GQA 16/2, head dim 128) under AAQ on 2 prompts, also
     against the plain path;
  9. the rest of the model zoo through ``models.lm``: deepseek-v2-lite-16b
     (27 layers, MLA + MoE), recurrentgemma-9b (38), mamba2-780m (48),
     whisper-base (6 + 6, 1,500 frames), phi-3-vision-4.2b (32, 256 image
     embeddings) at full width and mixtral-8x22b at full width and 2 of its
     56 layers (one card cannot hold the rest), each alone, bf16, random
     weights from seed 0 made on the card, its memory released before the
     next.  Each: ``prefill_fn`` on 2 prompts of 512 positions (2,560 for
     recurrentgemma, 1 x 4,608 for mixtral, so that their windows engage;
     whisper's decoder 64 tokens) on the kernel route against the plain
     route (same weights) within a limit set from readings, and for the
     MoE models the top-k choices that differ between the routes counted
     layer by layer and the kernel route rerun with the plain route's
     choices forced, within a tighter limit; 16 tokens
     decoded from an empty ``make_cache`` against ``prefill_fn`` on the same
     16 tokens within a limit set from readings; flash launches a prefill
     and a decode step equal to the attention calls the config implies (0
     for mamba2), each on the variant the rule gives its operands (the
     prefill kernel for a prefill, the decode kernel for a step), no plain
     attention on the kernel route; ``AAQConfig()``
     against ``DISABLED`` finite, its drift printed; prefill ms, decode-step
     ms and peak memory printed; the ``AAQConfig()`` prefill launches
     ``aaq_fake_quant`` once for each act call the config implies (residual
     rows up to 6,144 wide) and runs no plain fake-quant, and its logits are
     bitwise those of the same prefill with only the act sites on the plain
     version;
 10. training (float32, ``deterministic algorithms`` on): (a) qwen1.5-0.5b
     at full width through ``repro_torch.launch.train.main`` (``--batch 8
     --seq 64 --lr 1e-3 --aaq-ste``, 8 steps) uninterrupted, then with
     ``--ckpt-every 4 --fail-at 6``: losses finite, a held-out batch
     scoring better under the final weights than the initial, one restart
     from the step-3 checkpoint, final parameters and optimizer state
     bitwise the uninterrupted run's, ``aaq_fake_quant`` launched once an
     act call (4 a layer, twice: the remat recomputes each block), no flash
     launch and the attention's plain version counted (``ref_grad``) once a
     call; step ms, checkpoint snapshot and write ms and bytes, peak
     memory; (b) one step's loss and gradients on the kernel route against
     the plain route (same weights and batch) within a limit, which a
     control (a straight-through estimator whose backward zeroes the first
     act site's gradient) must exceed; (c) one ``make_train_step`` step
     (loss, backward, AdamW) of deepseek-v2-lite-16b, recurrentgemma-9b
     (3 layers: one period, so that its attention layer runs), mamba2-780m,
     whisper-base and phi-3-vision-4.2b at full width and 2 layers and
     mixtral-8x22b at full width and 1 layer (2 would need 87 GB of
     parameters, gradients and moments in float32) under ``--aaq-ste``'s
     config: loss and gradient norm finite, the norm above 0, the kernel at
     every act site, no plain fake-quant; step ms and peak memory;
 11. the mesh-sharded fold tier (``FoldClient(mesh=..., shard_threshold=256)``,
     full esmfold_ppm width, random weights from seed 0): (a) a 1x1 mesh
     over NCCL through the engine, the batch-1 and batch-4 keys of bucket
     256 captured as graphs with their collectives, coords bitwise or TM
     >= 0.9995 against the single placement, the second pass capturing
     nothing, the collectives a fold (calls and bytes) printed; (b) 2 and 4
     ranks on this card over the host-staged gloo route (started
     processes, eager; 8 blocks), the N = 250 fold under AAQ and FP: TM >=
     0.9995 against the single placement, each rank's launches those of
     the single fold variant by variant, each rank's pinned pair shard
     1/W of the pair tensor, each rank's peak printed beside the admission
     estimate; at W = 2 also the AAQ fold at chunk 64 against the same
     chunked fold on one device (TM >= 0.9995; each rank the kernels only,
     every rank the same launches, printed beside the single fold's); (c)
     with two cards or more, W = min(cards, 4) over NCCL across them, the
     chunked fold too; then the pair kernels at a rank's shapes (W = 2,
     4), against their plain versions and timed;
 12. multi-device training (``launch.train --model-parallel``, the
     reference's GSPMD step as DTensors; qwen1.5-0.5b at full width,
     float32, 8 x 64 tokens, deterministic algorithms): ``--model-parallel``
     with more ranks than cards refused ("needs N devices"); (a) three
     ``--aaq-ste`` steps on a 1x1 mesh over NCCL against the same steps
     unsharded: losses, parameters and AdamW state bitwise or within 1e-6
     relative, ``aaq_fake_quant`` once an act call, no plain fake-quant;
     (b) with two cards or more, one rank a card: ``--model-parallel 2``
     (and 4 on four cards) under ``DISABLED`` within 1e-4 relative of one
     card's losses and under ``--aaq-ste`` within a sanity bound (1e-3:
     the loss moves ~2e-4 for any change of fake-quant bins at these
     weights), the first act site's output on rank 0's rows bitwise one
     card's (its input is), which a control (rank 0 skips its act sites)
     must fail; on every
     rank one ``aaq_fake_quant`` launch an act call and no plain
     fake-quant; each rank's peak memory, collectives a step (calls,
     bytes) and step times printed; a run failed at step 3 and restarted
     bitwise the uninterrupted one; on four cards the 2x2 run's checkpoint
     resumed on a 1x2 mesh bitwise (``resume_elastic``), ``gpipe_loss`` at
     pod 4 (24 layers, 6 a stage) within 2e-4 of ``loss_fn``, and
     ``ring_ag_matmul_ws`` on 4 ranks within 2e-4 of ``x @ w`` (every
     gate of (b) read, then the phase fails if any failed); (c) a sharded
     prefill and 4 decode steps (phi-3-vision-4.2b, its ring sharded on
     its K/V heads; chatglm3-6b, on the head dim; full width at 2 layers,
     float32, 4 rows, a 256-row ring; both on the kernels, the float32
     flash on the float32 kernels, ``flash_mha_f32`` launched by each
     one-card run and no other flash variant) on a
     1x1 mesh over NCCL bitwise the same steps on one card, and with two
     cards or more on a 1xW mesh (W up to 4) across them within 1e-4
     relative on the logits; then
     ``aaq_fake_quant`` at a rank's training shapes, bitwise and timed;
 13. the fleet on one shared mesh (``--listen`` with ``--mesh``): two
     replicas of ``launch.serve``'s own factory, warmed, at full
     esmfold_ppm width on one 1x1 mesh over NCCL (1x2 across two cards
     under ``--mesh-only``), threshold 256, behind ``FoldHTTPServer``: 6
     requests of 226-250 residues posted, replica 0 failed with them
     queued (requeued, rebuilt on the same rank processes), served, then a
     second pass; each request TM >= 0.9995 against its single-device
     sequential fold, the wire bitwise in-process, every rank holding only
     the live engines, captures equal to keys and none in the second
     pass, every main-path kernel launched, the rank processes gone once
     the mesh closes;
 14. the four examples (``python -m repro_torch.examples.quickstart``,
     ``fold_server``, ``train_lm`` and ``lm_serve_quantized_kv``, each at
     its reduced config) as processes on the card, all at once: each exits
     0 after its own assertions with every kernel its path runs launched
     and no plain version;
 15. the dry-run: ``python -m repro_torch.launch.dryrun`` on the fake
     16 x 16 production mesh, a process a cell, all at once, for
     qwen1.5-0.5b x train_4k, qwen1.5-0.5b x decode_32k with the INT8 KV
     cache, deepseek-v2-lite-16b x decode_32k and x train_4k, esmfold_ppm
     x ns256, phi-3-vision-4.2b and chatglm3-6b x decode_32k and
     qwen2.5-3b x prefill_32k, each roofline line with the card's
     constants, the widened copies and the largest storage beside the
     peak, which must be at or under the cell's bound (twice the
     reference's own dry-run peak, at least it plus 1 GB); then phase 10's
     qwen step traced on one device and run for real under
     ``FlopCounterMode``: the FLOP counts equal, the trace's peak beside
     ``max_memory_allocated``;
 16. the fold on the reference's production layout (``sharding.PairGrid``:
     pair rows over ``data``, columns over ``model``, every parameter the
     rank's ``param_spec`` shard): esmfold_ppm at full width, 8 of its 48
     blocks, a 250-residue protein in bucket 256, under lightnobel_aaq and
     baseline_fp16, through ``make_fold_step``, unchunked and row-chunked
     at chunk 64: (a) a 1x1 grid over NCCL bitwise one card's fold (the
     chunked one one card's chunked fold), every main-path kernel
     launched; (b) a 2x2 grid of 4 processes on this card over the
     host-staged gloo route, TM >= 0.9995 against one card's fold of the
     same kind, no plain version, each rank's peak printed beside one
     card's; then the three kernels at a grid rank's shapes against their
     plain versions, timed; with ``--mesh-only`` on four cards (c) the 2x2
     grid a card a rank over NCCL at all 48 blocks, unchunked at N = 1,024
     and chunked at 2,000 residues in bucket 2,048, TM >= 0.995 against
     one card's fold of the same kind, each rank's peak printed beside one
     card's and a quarter of it (printed, not gated);
 17. a profiled serve: ``launch.serve``'s engine path with ``--profile
     DIR`` at full esmfold_ppm width, 8 requests of 200-256 residues under
     lightnobel_aaq (batches of 4 in bucket 256), (a) with ``--warmup`` (only
     replays in the profiled window), (b) without (the captures in it) and
     (c) as (a) under ``--driver thread`` (the ranges on the client's thread):
     all served, every main-path kernel launched, one trace file holding
     the engine's ``serve.dispatch/<bucket>`` and ``serve.retire/<bucket>``
     ranges for every bucket served and, where the profiler recorded device
     time, device events of all three hand-written kernels by their symbols;
     the ten device operations with the most time, the device-busy share
     of the window, the kernel count and the host time inside the engine's
     ranges printed;
 18. summary: one JSON line of the kernels, the card, and the last line
     ``{"ok": true, "device": {...}}``.

Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of one H100 SXM (dense): bf16 tensor cores, float32 on the
# CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

SERVE_BUCKETS = (96, 192, 256, 1024)
# the engine phase: 8 requests, four of them in bucket 256 (one batch of 4)
ENGINE_BUCKETS = (96, 192, 256)
ENGINE_LENGTHS = (250, 241, 233, 226, 180, 150, 90, 70)
ENGINE_MAX_BATCH = 4
# TM floor of each request served batched through graphs against the same
# request folded at batch 1 by the sequential server (eager): the phase-4
# floor, since only the batch size and the launch route differ
ENGINE_TM_GATE = 0.9995
ENGINE_LONG_LEN = 2000
ENGINE_LONG_BUCKET = 2048
SERVE_N = 4
LONG_LEN = 1000             # one long request, served alone in bucket 1024
FWD_BUCKET = 256
FWD_LEN = 230
# TM floor of the kernels against the plain references over a 2-block
# full-width forward, under either scheme.  The bucket is 256 because there
# both routes take triangular attention's rows-as-batch dataflow; below 256
# the ref route takes the einsum one, which also fake-quantizes the
# probabilities, and the comparison would read that route difference, not
# the kernels.  The floor sits between the kernels' readings and two
# controls that must fall below it: a fold whose flash launches drop the
# bias, and one whose aaq_matmul launches drop the outlier term (readings
# in PERF.md).
TM_GATE = 0.9995

# lengths of the spin kernel that holds the stream while time_ms enqueues
# its calls, in clock cycles (2**26 is about 34 ms at 1.98 GHz), longest last
SPIN_CYCLES = (2 ** 26, 2 ** 28, 2 ** 30)

# kernel variant -> (CUDA source, the Pallas kernel it replaces)
VARIANTS = {
    "aaq_quantize": ("aaq_quant.cu", "src/repro/kernels/aaq_quant/aaq_quant.py:53"),
    "aaq_matmul": ("aaq_matmul.cu", "src/repro/kernels/aaq_matmul/aaq_matmul.py:47"),
    "flash_mha": ("flash_attention.cu", "src/repro/kernels/flash_attention/flash_attention.py:93"),
}
VARIANTS.update(aaq_fake_quant=VARIANTS["aaq_quantize"],
                aaq_matmul_f32=VARIANTS["aaq_matmul"], aaq_matmul_wg=VARIANTS["aaq_matmul"],
                aaq_matmul_wide=VARIANTS["aaq_matmul"], flash_mha_wg=VARIANTS["flash_mha"],
                flash_mha_dec=("flash_decode.cu", VARIANTS["flash_mha"][1]),
                flash_mha_pf=("flash_prefill.cu", VARIANTS["flash_mha"][1]),
                flash_mha_f32=("flash_f32.cu", VARIANTS["flash_mha"][1]),
                flash_mha_f32_dec=("flash_f32.cu", VARIANTS["flash_mha"][1]))
#: the flash variants, each counted apart
FLASH_VARIANTS = ("flash_mha", "flash_mha_wg", "flash_mha_dec", "flash_mha_pf", "flash_mha_f32",
                  "flash_mha_f32_dec")
#: the float32 flash variants (and every head dim above 256)
F32_FLASH = ("flash_mha_f32", "flash_mha_f32_dec")
#: the reduced float32 fold of phase 14's quickstart and fold_server (40
#: residues, ``reduce_ppm_config``): its tokens a pair product, and its
#: AAQ-linear products as (H, D, k): the tri-attention bias (D = 4), the pair
#: projections, tri-attention's qkv, tri-mul's packed projection and the pair
#: transition's down projection
FOLD_LEN = 40
FOLD_TOKENS = FOLD_LEN * FOLD_LEN
FOLD_MATMULS = ((32, 4, 4), (32, 32, 0), (32, 32, 4), (32, 96, 4), (32, 128, 4), (128, 32, 0))
#: (row, tally key) of the kernel rows at the reduced float32 fold's shapes
FOLD_F32_ROWS: list = []
# (H, D) of every aaq_matmul call of a fold: the tri-attention bias, the
# pair projections, tri-attention's qkv, tri-mul's packed projection,
# the pair transition's down projection
MATMUL_SHAPES = ((128, 4), (128, 128), (128, 384), (128, 512), (512, 128))
# (H, bits, k) of every quantize call of a fold: group B (post-LayerNorm, the
# linears' and acts' most common), group C at H = 128 and at the pair
# transition's H = 512, group A (acts only)
QUANT_SHAPES = ((128, 4, 4), (128, 4, 0), (512, 4, 0), (128, 8, 4))
# the LM zoo's residual-stream widths above 512 (lm.pre_ln rows: qwen1.5-0.5b,
# mamba2, qwen2.5/deepseek, phi-3, chatglm3/recurrentgemma, mistral-nemo,
# mixtral), each at about 64k tokens of 1,024 columns' worth
QUANT_WIDE = (1024, 1536, 2048, 3072, 4096, 5120, 6144)
QUANT_WIDE_ELEMS = 65536 * 1024
# phase 10's fake-quant shapes on qwen1.5-0.5b (batch 8 x 64 tokens, f32):
# the residual rows (group A) and the K/V head rows (group C)
TRAIN_QUANT_SHAPES = ((512, 1024, 8, 4), (8192, 64, 4, 0))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def call_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA events
    (includes the gaps where the device waits for the host to launch)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events, with
    no host launch gap counted: the calls are enqueued behind a spin kernel
    (``torch.cuda._sleep``) that holds the stream until the host has
    enqueued them all, so they run back to back.  If the spin ended before
    the host was done (the start event had already passed), it is made four
    times longer and the calls are timed again.  Not ``torch.profiler``: on
    the card it has recorded no device time in some runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for cycles in SPIN_CYCLES:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()            # the stream still spinning
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        log(f"time_ms: a spin of {cycles} cycles ended before the host had enqueued "
            f"{iters} calls; timing again behind a longer one")
    fail(f"time_ms: the host took longer to enqueue {iters} calls than a spin of "
         f"{SPIN_CYCLES[-1]} cycles")


def bound_ms(n_bytes: float, n_ops: float, f32: bool = False) -> tuple[float, str]:
    """The least time for ``n_bytes`` moved and ``n_ops`` done: bf16 on the
    tensor cores, or ``f32`` on the CUDA cores."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@dataclasses.dataclass
class KernelRow:
    """One kernel variant at one shape: the JSON row of a variant is its
    first (timed) shape; ``shapes`` keeps every main-path shape."""
    name: str
    source: str
    replaces: str
    shape: str = ""
    max_abs_err: float = 0.0
    ms: float = 0.0
    plain_ms: float | None = 0.0
    bound_ms: float = 0.0
    bound_by: str = ""
    library_ms: float | None = None
    launches: int = 0
    call_ms: float = 0.0        # CUDA-event time of back-to-back calls (log only)
    tc_ms: float | None = None  # the Hopper variants' rows: the tc kernel at the same shape

    def record(self) -> dict:
        rec = {"name": self.name, "route": "cuda", "source": self.source,
               "replaces": self.replaces, "shape": self.shape,
               "launches": self.launches, "max_abs_err": self.max_abs_err,
               "ms": self.ms, "plain_ms": self.plain_ms,
               "bound_ms": self.bound_ms, "bound_by": self.bound_by,
               "library_ms": self.library_ms}
        return rec if self.tc_ms is None else dict(rec, tc_ms=self.tc_ms)

    def line(self) -> str:
        lib = "none" if self.library_ms is None else f"{self.library_ms:.4f}"
        plain = "not timed" if self.plain_ms is None else f"{self.plain_ms:.4f}"
        tc = "" if self.tc_ms is None else f" tc_ms={self.tc_ms:.4f}"
        return (f"{self.name} [{self.shape}]: kernel_ms={self.ms:.4f} "
                f"call_ms={self.call_ms:.4f} "
                f"bound_ms={self.bound_ms:.4f} ({self.bound_by}, "
                f"{100 * self.bound_ms / self.ms:.1f}% of bound) plain_ms={plain} "
                f"library_ms={lib} max_abs_err={self.max_abs_err:.3e}{tc}")


def _row(name: str, shape: str) -> KernelRow:
    src, pallas = VARIANTS[name]
    return KernelRow(name, f"src/repro_torch/csrc/{src}", pallas, shape)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def _bitwise(torch, a, b) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _linear_input(torch, g, t: int, h: int):
    """A quantized linear's input as the fold makes it: a fake-quantized
    activation (group B at H = 128, group C after a ReLU at H = 512)."""
    from repro_torch.kernels.aaq_quant.aaq_quant import aaq_fake_quant_kernel
    x = torch.randn((t, h), generator=g, device="cuda").to(torch.bfloat16)
    return aaq_fake_quant_kernel(x, 4, 4) if h == 128 else aaq_fake_quant_kernel(x.relu(), 4, 0)


def check_quantize(torch, rows: dict) -> None:
    """Both forms of the quantize kernel, bitwise against their plain
    versions, then timed at every quantize shape of the main path."""
    from repro_torch.kernels.aaq_quant.aaq_quant import (aaq_fake_quant_kernel,
                                                         aaq_quantize_kernel)
    from repro_torch.kernels.aaq_quant.ref import aaq_fake_quant_ref, aaq_quantize_ref
    g = torch.Generator(device="cuda").manual_seed(1)
    t = 256 * 256
    cases = [(h, bits, k, dt) for h in (128, 512) for bits in (4, 8)
             for k in (0, 4) for dt in (torch.bfloat16,)]
    cases += [(128, 4, 4, torch.float32), (32, 4, 4, torch.float32)]
    for h, bits, k, dt in cases:
        for tt in (t, t - 1):                                    # odd T too
            x = (torch.randn((tt, h), generator=g, device="cuda") * 2).to(dt)
            x[:64] = 0                                          # all-zero (padded) tokens
            x[64:128, : h // 2] = 1.5                           # ties on many lanes
            x[128, 5] = 60.0
            x[129] = 0.25                                       # 16 equal maxima across
            x[129, 8:24] = torch.tensor([5.0, -5.0] * 8, device="cuda").to(dt)  # two lanes
            x[130, 16:20] = torch.tensor([50.0, -50.0, 40.0, -40.0], device="cuda").to(dt)
            got = aaq_quantize_kernel(x, bits=bits, k_outliers=k)
            want = aaq_quantize_ref(x, bits, k)
            torch.cuda.synchronize()
            for name, a, b in zip(("inliers", "scales", "ovals", "oidx"), got, want):
                if not _bitwise(torch, a, b):
                    fail(f"aaq_quantize {name} not bitwise equal at T={tt} H={h} "
                         f"bits={bits} k={k} {dt}")
            got = aaq_fake_quant_kernel(x, bits, k)
            want = aaq_fake_quant_ref(x, bits, k)
            torch.cuda.synchronize()
            if got.dtype != dt or not _bitwise(torch, got, want):
                fail(f"aaq_fake_quant x_hat not bitwise equal at T={tt} H={h} "
                     f"bits={bits} k={k} {dt}")
    # the linears' inputs on the fold are fake-quantized activations (many
    # exact zeros, values on a grid); the pair transition's follow a ReLU
    for h, bits, k in QUANT_SHAPES[:3]:
        x = _linear_input(torch, g, t, h)
        for name, a, b in zip(("inliers", "scales", "ovals", "oidx"),
                              aaq_quantize_kernel(x, bits=bits, k_outliers=k),
                              aaq_quantize_ref(x, bits, k)):
            if not _bitwise(torch, a, b):
                fail(f"aaq_quantize {name} not bitwise equal on a fake-quantized input "
                     f"H={h} bits={bits} k={k}")
    log(f"aaq_quantize, aaq_fake_quant: bitwise equal to their plain versions on "
        f"{2 * len(cases)} cases each (T = 65536 and 65535, all-zero rows, ties, 16 equal "
        "maxima across two lanes, all outliers in one lane); aaq_quantize also on 3 "
        "fake-quantized inputs")
    timed = ([("aaq_quantize", shape, False) for shape in QUANT_SHAPES]
             + [("aaq_quantize", shape, True) for shape in QUANT_SHAPES[:3]]
             + [("aaq_fake_quant", shape, False) for shape in QUANT_SHAPES])
    for name, (h, bits, k), linear_input in timed:   # the main path's shapes, bf16
        x = (_linear_input(torch, g, t, h) if linear_input else
             torch.randn((t, h), generator=g, device="cuda").to(torch.bfloat16))
        if name == "aaq_quantize":
            kern = lambda: aaq_quantize_kernel(x, bits=bits, k_outliers=k)  # noqa: E731
            plain = lambda: aaq_quantize_ref(x, bits, k)                    # noqa: E731
        else:
            kern = lambda: aaq_fake_quant_kernel(x, bits, k)                # noqa: E731
            plain = lambda: aaq_fake_quant_ref(x, bits, k)                  # noqa: E731
        out = kern()
        row = _row(name, f"x ({t}, {h}) bf16{' fake-quantized' if linear_input else ''}, "
                         f"bits {bits}, k {k}")
        row.ms = time_ms(torch, kern)
        row.call_ms = call_ms(torch, kern)
        row.plain_ms = time_ms(torch, plain, iters=5)
        row.bound_ms, row.bound_by = bound_ms(
            nbytes(x, *(out if isinstance(out, tuple) else (out,))), 0)
        rows.setdefault(name, []).append(row)
        log(row.line())


def _quant_pair(torch, x, bits, k, what) -> None:
    """Both quantize forms on ``x``, bitwise against their plain versions."""
    from repro_torch.kernels.aaq_quant.aaq_quant import (aaq_fake_quant_kernel,
                                                         aaq_quantize_kernel)
    from repro_torch.kernels.aaq_quant.ref import aaq_fake_quant_ref, aaq_quantize_ref
    for name, a, b in zip(("inliers", "scales", "ovals", "oidx"),
                          aaq_quantize_kernel(x, bits=bits, k_outliers=k),
                          aaq_quantize_ref(x, bits, k)):
        if not _bitwise(torch, a, b):
            fail(f"aaq_quantize {name} not bitwise equal at {what}")
    got = aaq_fake_quant_kernel(x, bits, k)
    if got.dtype != x.dtype or not _bitwise(torch, got, aaq_fake_quant_ref(x, bits, k)):
        fail(f"aaq_fake_quant x_hat not bitwise equal at {what}")


def _timed_quant_row(torch, name, x, bits, k, shape) -> KernelRow:
    from repro_torch.kernels.aaq_quant.aaq_quant import (aaq_fake_quant_kernel,
                                                         aaq_quantize_kernel)
    from repro_torch.kernels.aaq_quant.ref import aaq_fake_quant_ref, aaq_quantize_ref
    if name == "aaq_quantize":
        kern = lambda: aaq_quantize_kernel(x, bits=bits, k_outliers=k)  # noqa: E731
        plain = lambda: aaq_quantize_ref(x, bits, k)                    # noqa: E731
    else:
        kern = lambda: aaq_fake_quant_kernel(x, bits, k)                # noqa: E731
        plain = lambda: aaq_fake_quant_ref(x, bits, k)                  # noqa: E731
    out = kern()
    row = _row(name, shape)
    row.ms = time_ms(torch, kern)
    row.call_ms = call_ms(torch, kern)
    row.plain_ms = time_ms(torch, plain, iters=2, warmup=1)
    row.bound_ms, row.bound_by = bound_ms(
        nbytes(x, *(out if isinstance(out, tuple) else (out,))), 0)
    return row


def check_quantize_wide(torch) -> list:
    """Both quantize forms at the LM zoo's residual widths (``QUANT_WIDE``,
    one warp a token, chunks strided by 512) in bf16 and f32, bits 4 and 8,
    k 0 and 4, about 64M values a call, bitwise against their plain versions
    (with all-zero rows, ties across lanes, equal maxima on both sides of a
    512-column chunk boundary, more than 4 equal maxima in a row) and
    timed; then at phase 10's training shapes.  No PyTorch call computes
    this function (``library_ms`` none).  Returns two lists of (row, tally
    key) for the kernels JSON: each width's bf16 bits-8 k-4 rows of both
    forms (the residual site's group A: phase 9's AAQ prefills launch the
    fake-quant form there, and nothing launches ``aaq_quantize`` at these
    widths), and the training rows (phase 10's launches)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    pending = []
    n = 0
    for h in QUANT_WIDE:
        t = QUANT_WIDE_ELEMS // h
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn((t, h), generator=g, device="cuda") * 2).to(dt)
            x[:8] = 0                                               # all-zero rows
            x[8:16, : h // 2] = 1.5                                 # ties on every lane
            x[16, 5], x[17, h - 1] = 60.0, -60.0
            x[18, 511], x[18, 512], x[18, h - 1] = 9.0, -9.0, 9.0   # across a chunk edge
            x[19, ::97] = 50.0                                      # > 4 equal maxima
            dname = str(dt).removeprefix("torch.")
            for bits in (4, 8):
                for k in (0, 4):
                    _quant_pair(torch, x, bits, k, f"T={t} H={h} bits={bits} k={k} {dname}")
                    n += 2
                    for name in ("aaq_quantize", "aaq_fake_quant"):
                        row = _timed_quant_row(torch, name, x, bits, k,
                                               f"x ({t}, {h}) {dname}, bits {bits}, k {k}")
                        log(row.line())
                        if dt == torch.bfloat16 and bits == 8 and k == 4:
                            pending.append((row, (name, h, "bfloat16", bits, k)))
            del x
    log(f"aaq_quantize, aaq_fake_quant: bitwise equal to their plain versions at the "
        f"{len(QUANT_WIDE)} wide widths ({n} calls: bf16 and f32, bits 4/8, k 0/4)")
    train_pending = []
    for t, h, bits, k in TRAIN_QUANT_SHAPES:
        x = torch.randn((t, h), generator=g, device="cuda")
        _quant_pair(torch, x, bits, k, f"the training shape T={t} H={h} f32")
        row = _timed_quant_row(torch, "aaq_fake_quant", x, bits, k,
                               f"x ({t}, {h}) float32, bits {bits}, k {k} (training)")
        log(row.line())
        train_pending.append((row, (t, h, "float32", bits, k)))
    return pending, train_pending


def _mm_name(w, bits: int) -> str:
    """The launch-count name of the matmul variant a call takes (the
    wrapper's fixed rule on W's type, H, D and the bits)."""
    from repro_torch.kernels.aaq_matmul.aaq_matmul import VARIANT_NAMES, variant_for
    return VARIANT_NAMES[variant_for(w.dtype, *w.shape, bits)]


def _mm_close(torch, got, want, what) -> float:
    """Both sides sum the same exact float32 products in different orders
    and round once to the output type: one ulp of it (2^-7 bf16, 1e-5 f32)
    relative, plus float32 reassociation of H terms (1e-4 of max|y|)."""
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-5
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= rtol * want.abs() + 1e-4 * want.abs().max()).all()) \
            or not bool(torch.isfinite(got).all()):
        fail(f"{what}: max err {float(err.max()):.3e} over tolerance")
    return float(err.max())


def _mm_bitwise(torch, q, s, ov, oi, w, got, what, bits=4) -> None:
    """The Hopper and split-W matmuls' determinism gates: a second launch
    bitwise the first, and the first, a middle and the last tile (64 tokens
    on the Hopper kernel, 128 on the split-W one) each launched alone
    bitwise its rows of the full launch (a token's sum does not depend on
    the tile or launch it falls in)."""
    from repro_torch.kernels.aaq_matmul.aaq_matmul import WG_BT, aaq_matmul_kernel
    name = _mm_name(w, bits)
    bt = WG_BT if name == "aaq_matmul_wg" else 128
    t = q.shape[0]
    if not _bitwise(torch, aaq_matmul_kernel(q, s, ov, oi, w, bits=bits, out_dtype=w.dtype), got):
        fail(f"{name} {what}: two launches differ")
    for r0 in sorted({0, bt * ((t // bt) // 2), bt * ((t - 1) // bt)}):
        r1 = min(r0 + bt, t)
        one = aaq_matmul_kernel(q[r0:r1], s[r0:r1], ov[r0:r1], oi[r0:r1], w, bits=bits,
                                out_dtype=w.dtype)
        if not _bitwise(torch, one, got[r0:r1]):
            fail(f"{name} {what}: tokens {r0}..{r1 - 1} launched alone differ from "
                 "their rows of the full launch")


def _mm_tc_ms(torch, q, s, ov, oi, w) -> float:
    """Time of the tensor-core (mma.sync) kernel on a launch the rule sends
    to the Hopper kernel, through its C entry point."""
    from repro_torch.kernels import build
    t, (h, d), k = q.shape[0], w.shape, ov.shape[-1]
    y = torch.empty((t, d), dtype=w.dtype, device=w.device)
    lib, stream = build.library(), torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), s.data_ptr(), ov.data_ptr(), oi.data_ptr(), w.data_ptr(), y.data_ptr())

    def tc():
        build.check(lib.aaq_matmul_launch(*ptrs, t, h, d, 4, k, max(k, 1), stream), "aaq_matmul")
    return time_ms(torch, tc)


def check_matmul(torch, rows: dict) -> None:
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel
    from repro_torch.kernels.aaq_matmul.ref import aaq_matmul_ref
    from repro_torch.kernels.aaq_quant.ref import aaq_quantize_ref
    g = torch.Generator(device="cuda").manual_seed(2)
    t = 256 * 256
    # (H, D, bits); H = 640 and 48 are bf16 calls neither bf16 kernel takes
    # (the split-W kernel, one part)
    cases = [(128, 4, 4), (128, 128, 4), (128, 384, 4), (128, 512, 4), (512, 128, 4),
             (128, 128, 8), (512, 128, 8), (640, 128, 4), (48, 128, 4)]
    worst, n_cases, on_wg = 0.0, 0, []
    for h, d, bits in cases:
        for k in (0, 4):
            for dt in (torch.bfloat16, torch.float32) if (h, d) == (128, 128) else (torch.bfloat16,):
                w = (torch.randn((h, d), generator=g, device="cuda") / math.sqrt(h)).to(dt)
                name = _mm_name(w, bits)
                # the Hopper kernel also at a token alone and ragged last
                # tiles just under and over two 64-token tiles
                for n in (t - 3, 1, 127, 129) if name == "aaq_matmul_wg" else (t - 3,):
                    x = torch.randn((n, h), generator=g, device="cuda").to(dt)
                    x[:min(64, n // 4)] = 0
                    q, s, ov, oi = aaq_quantize_ref(x, bits, k)
                    before = dispatch.launch_counts()
                    got = aaq_matmul_kernel(q, s, ov, oi, w, bits=bits, out_dtype=dt)
                    after = dispatch.launch_counts()
                    if {v: after[v] - before[v] for v in after if after[v] != before[v]} \
                            != {name: 1}:
                        fail(f"aaq_matmul H={h} D={d} bits={bits} k={k} {dt}: launched "
                             f"{ {v: after[v] - before[v] for v in after} }, not {name}")
                    want = aaq_matmul_ref(q, s, ov, oi, w, bits=bits, out_dtype=dt)
                    what = f"H={h} D={d} bits={bits} k={k} T={n} {dt}"
                    worst = max(worst, _mm_close(torch, got, want, f"{name} {what}"))
                    if name != "aaq_matmul" and n == t - 3:
                        _mm_bitwise(torch, q, s, ov, oi, w, got, what, bits)
                        on_wg.append(what)
                    n_cases += 1
    # the split-W kernel's other paths: the reduced float32 fold's products
    # (phase 14's: T = 1,600, its (H, D) and k, D down to 4), W streamed in
    # 128-column panels (float32 above H = 384, bf16 above 1,408) and an odd
    # D (its scalar stores), each with the same gates
    f32, bf = torch.float32, torch.bfloat16
    split_cases = [(h, d, k, f32, FOLD_TOKENS) for h, d, k in FOLD_MATMULS]
    split_cases += [(640, 128, 4, f32, t - 3), (2048, 128, 4, bf, t - 3),
                    (32, 33, 4, f32, FOLD_TOKENS), (48, 33, 4, bf, FOLD_TOKENS)]
    for h, d, k, dt, n in split_cases:
        w = (torch.randn((h, d), generator=g, device="cuda") / math.sqrt(h)).to(dt)
        name = _mm_name(w, 4)
        x = torch.randn((n, h), generator=g, device="cuda").to(dt)
        x[:min(64, n // 4)] = 0
        q, s, ov, oi = aaq_quantize_ref(x, 4, k)
        before = dispatch.launch_counts()
        got = aaq_matmul_kernel(q, s, ov, oi, w, bits=4, out_dtype=dt)
        after = dispatch.launch_counts()
        if {v: after[v] - before[v] for v in after if after[v] != before[v]} != {name: 1} \
                or name not in ("aaq_matmul_f32", "aaq_matmul_wide"):
            fail(f"aaq_matmul H={h} D={d} k={k} {dt}: launched "
                 f"{ {v: after[v] - before[v] for v in after} }, not {name} (split-W)")
        what = f"H={h} D={d} bits=4 k={k} T={n} {dt}"
        worst = max(worst, _mm_close(torch, got, aaq_matmul_ref(q, s, ov, oi, w, bits=4,
                                                                 out_dtype=dt), f"{name} {what}"))
        _mm_bitwise(torch, q, s, ov, oi, w, got, what)
        on_wg.append(what)
        n_cases += 1
    log(f"aaq_matmul: allclose (rtol one bf16 ulp 2^-7 / 1e-5 for f32, atol 1e-4*max|y|) "
        f"on {n_cases} cases (T = 65533, and 1, 127, 129 on the Hopper kernel; bf16 W at "
        f"bits 4 and H, D multiples of 128 on aaq_matmul_wg, D = 4 and bits 8 on the "
        f"tensor-core kernel, f32 W on aaq_matmul_f32 and bf16 at H = 640 and 48 on "
        f"aaq_matmul_wide, the split-W kernel, also at the reduced f32 fold's shapes (T = "
        f"{FOLD_TOKENS}, (H, D, k) {FOLD_MATMULS}), W streamed (f32 H = 640, bf16 H = 2048) "
        f"and D = 33), worst max|err| {worst:.3e}; on "
        f"aaq_matmul_wg, aaq_matmul_f32 and aaq_matmul_wide two launches and the first, a "
        f"middle and the last tile alone bitwise: {on_wg}")
    # timing at every main-path shape (bf16, bits 4, k 4; k 0 at the two
    # shapes whose fold calls take no outliers), then the f32 variant (k 4
    # and 0: library_ms is cuBLAS's float32 x @ W), then bf16 at H = 640
    # and 48 (the split-W kernel, one part)
    timed = [(torch.bfloat16, hd, 4) for hd in MATMUL_SHAPES]
    timed += [(torch.bfloat16, hd, 0) for hd in ((128, 128), (512, 128))]
    timed += [(torch.float32, (128, 128), 4), (torch.float32, (128, 128), 0),
              (torch.bfloat16, (640, 128), 4), (torch.bfloat16, (48, 128), 4)]
    for dt, (h, d), k in timed:
        x = torch.randn((t, h), generator=g, device="cuda").to(dt)
        w = (torch.randn((h, d), generator=g, device="cuda") / math.sqrt(h)).to(dt)
        q, s, ov, oi = aaq_quantize_ref(x, 4, k)
        name = _mm_name(w, 4)
        y = aaq_matmul_kernel(q, s, ov, oi, w, bits=4, out_dtype=dt)
        want = aaq_matmul_ref(q, s, ov, oi, w, bits=4, out_dtype=dt)
        row = _row(name, f"q ({t}, {h // 2}) int4 packed, W ({h}, {d}) "
                         f"{'bf16' if dt == torch.bfloat16 else 'f32'}, bits 4, k {k}")
        row.max_abs_err = float((y.float() - want.float()).abs().max())
        row.ms = time_ms(torch, lambda: aaq_matmul_kernel(q, s, ov, oi, w, bits=4,
                                                          out_dtype=dt))
        if name == "aaq_matmul_wg":
            row.tc_ms = _mm_tc_ms(torch, q, s, ov, oi, w)
        row.call_ms = call_ms(torch, lambda: aaq_matmul_kernel(q, s, ov, oi, w, bits=4,
                                                               out_dtype=dt))
        row.plain_ms = time_ms(torch, lambda: aaq_matmul_ref(q, s, ov, oi, w, bits=4,
                                                             out_dtype=dt), iters=5)
        row.library_ms = time_ms(torch, lambda: x @ w)       # unquantized x @ W
        row.bound_ms, row.bound_by = bound_ms(nbytes(q, s, ov, oi, w, y), 2 * t * h * d)
        rows.setdefault(name, []).append(row)
        log(row.line())
    # the reduced float32 fold's products, each timed at its own shape; their
    # launches are phase 14's (fold_f32_launches)
    for h, d, k in FOLD_MATMULS:
        x = torch.randn((FOLD_TOKENS, h), generator=g, device="cuda")
        w = torch.randn((h, d), generator=g, device="cuda") / math.sqrt(h)
        q, s, ov, oi = aaq_quantize_ref(x, 4, k)
        y = aaq_matmul_kernel(q, s, ov, oi, w, bits=4, out_dtype=torch.float32)
        want = aaq_matmul_ref(q, s, ov, oi, w, bits=4, out_dtype=torch.float32)
        row = _row(_mm_name(w, 4), f"reduced f32 fold: q ({FOLD_TOKENS}, {h // 2}) int4 packed, "
                                   f"W ({h}, {d}) f32, bits 4, k {k}")
        row.max_abs_err = float((y - want).abs().max())
        row.ms = time_ms(torch, lambda: aaq_matmul_kernel(q, s, ov, oi, w, bits=4))
        row.call_ms = call_ms(torch, lambda: aaq_matmul_kernel(q, s, ov, oi, w, bits=4))
        row.plain_ms = time_ms(torch, lambda: aaq_matmul_ref(q, s, ov, oi, w, bits=4), iters=5)
        row.library_ms = time_ms(torch, lambda: x @ w)
        row.bound_ms, row.bound_by = bound_ms(nbytes(q, s, ov, oi, w, y),
                                              2 * FOLD_TOKENS * h * d, f32=True)
        FOLD_F32_ROWS.append((row, ("mm", h, d, k)))
        log(row.line())


def _attn_case(torch, g, name, b, n, hq, hkv, d, dt, *, bias=None, causal=False,
               window=None, rows_as_batch=False, pad=0, tri_bias=None):
    """Inputs of one attention case.  ``bias="f32"``: a contiguous
    (B, H, N, N) f32 bias (the structure module's); ``bias="seq"``: seq
    attention's, an f32 bias permuted from (B, N, N, H).  ``rows_as_batch``:
    triangular attention's (B*N, N, H, D) views of a (B, N, N, 3*H*D)
    projection and a transposed (B, H, N, N) bias, bf16 unless ``tri_bias``
    names its type; ``pad`` trailing keys are padding."""
    kvlen = None
    if rows_as_batch:
        qkv = torch.randn((1, n, n, 3 * hq * d), generator=g, device="cuda").to(dt)
        q, k, v = (a.reshape(n, n, hq, d) for a in torch.split(qkv, hq * d, dim=-1))
        v = v * (torch.arange(n, device="cuda") < n - pad)[None, :, None, None].to(dt)
        bias = torch.randn((1, n, n, hq), generator=g, device="cuda")
        bias = bias.to(tri_bias or torch.bfloat16).permute(0, 3, 1, 2)
        kvlen = torch.full((n,), n - pad, dtype=torch.int32, device="cuda")
    else:
        q = torch.randn((b, n, hq, d), generator=g, device="cuda").to(dt)
        k = torch.randn((b, n, hkv, d), generator=g, device="cuda").to(dt)
        v = torch.randn((b, n, hkv, d), generator=g, device="cuda").to(dt)
        if bias == "f32":
            bias = torch.randn((b, hq, n, n), generator=g, device="cuda")
        elif bias == "seq":
            bias = torch.randn((b, n, n, hq), generator=g, device="cuda").permute(0, 3, 1, 2)
        if bias is not None and pad:
            bias[..., n - pad:] += -1e9                     # key-padding fold
    return dict(name=name, q=q, k=k, v=v, bias=bias, kvlen=kvlen, causal=causal,
                window=window)


def _flash_close(torch, got, want, v, name):
    """Same float32 online softmax as the plain version, summed in another
    order: one ulp of the output type (2^-7 bf16, 1e-5 f32) relative, plus
    1e-4 of max|v| for reassociation and expf/torch.exp differences."""
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    rtol = 2.0 ** -7 if v.dtype == torch.bfloat16 else 1e-5
    err = (got - want).abs()
    tol = rtol * want.abs() + 1e-4 * v.float().abs().max()
    if not bool((err <= tol).all()) or not bool(torch.isfinite(got).all()):
        fail(f"flash_mha {name}: max err {float(err.max()):.3e} over tolerance")
    return float(err.max())


def _flash_name(q, k, bias, v=None, **kw) -> str:
    """The launch-count name of the flash variant a call takes (the wrapper's
    fixed rule, with a bias no TMA box takes or a scale <= 0 off the Hopper
    kernel)."""
    from repro_torch.kernels.flash_attention.flash_attention import (VARIANT_NAMES,
                                                                     _flash_launch_args)
    return VARIANT_NAMES[_flash_launch_args(q, k, k if v is None else v, bias, **kw).variant]


def _flash_bitwise(torch, args, got, name, **kw) -> None:
    """A Hopper or decode kernel's determinism gates: a second launch
    bitwise the first, and the first, a middle and the last batch row each
    launched alone bitwise its row of the full launch (a row's output does
    not depend on which rows share its block, or, at decode, on the other
    slots' key lengths)."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_mha_kernel
    q, k, v, bias, kvl = args
    what = _flash_name(q, k, bias, v, **kw)
    if not _bitwise(torch, flash_mha_kernel(*args, **kw), got):
        fail(f"{what} {name}: two launches differ")
    b = q.shape[0]
    per = b if bias is None else b // bias.shape[0]
    for r in sorted({0, min(b // 2 + 1, b - 1), b - 1}):
        one = flash_mha_kernel(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                               None if bias is None else bias[r // per:r // per + 1],
                               None if kvl is None else kvl[r:r + 1], **kw)
        if not _bitwise(torch, one, got[r:r + 1]):
            fail(f"{what} {name}: row {r} launched alone differs from its row of the "
                 "full launch")


def _tc_ms(torch, args, **kw) -> float:
    """Time of the tensor-core (mma.sync) kernel on a launch the rule sends
    to another variant, through its C entry point."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import _flash_launch_args
    q, k, v, bias, kvl = args
    la = _flash_launch_args(*args, **kw)
    b, sq, _, hq, _, d, _ = la.sizes
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lib, stream = build.library(), torch.cuda.current_stream().cuda_stream

    def tc():
        build.check(lib.flash_mha_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         None if bias is None else bias.data_ptr(),
                                         None if kvl is None else kvl.data_ptr(),
                                         o.data_ptr(), *la.c_args(), stream), "flash_mha")
    return time_ms(torch, tc)


def check_flash(torch, rows: dict) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention.flash_attention import (flash_mha_kernel,
                                                                     flash_mha_plain,
                                                                     variant_for)
    g = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    cases = []
    for n in (200, 256):
        cases += [
            _attn_case(torch, g, f"seq N={n}", 1, n, 16, 16, 64, bf, bias="seq", pad=n // 10),
            _attn_case(torch, g, f"tri N={n}", 1, n, 4, 4, 32, bf, rows_as_batch=True, pad=n // 10),
            _attn_case(torch, g, f"structure N={n}", 1, n, 16, 16, 64, bf, bias="f32"),
        ]
    cases += [
        _attn_case(torch, g, "seq N=1024", 1, 1024, 16, 16, 64, bf, bias="seq", pad=24),
        _attn_case(torch, g, "seq N=2048", 1, 2048, 16, 16, 64, bf, bias="seq", pad=48),
        _attn_case(torch, g, "causal", 2, 100, 4, 4, 64, torch.float32, causal=True),
        _attn_case(torch, g, "window", 2, 100, 4, 4, 32, torch.float32, causal=True, window=16),
        _attn_case(torch, g, "gqa", 2, 77, 8, 2, 16, torch.float32, bias="f32"),
        _attn_case(torch, g, "d8", 3, 70, 2, 2, 8, bf),
        _attn_case(torch, g, "d128", 1, 130, 2, 2, 128, bf, bias="f32"),
        _attn_case(torch, g, "bf16 causal window gqa", 2, 150, 8, 2, 64, bf, causal=True,
                   window=70),
        _attn_case(torch, g, "bf16 d16", 3, 90, 4, 4, 16, bf, bias="f32", pad=9),
    ]
    # the reduced float32 fold's attention (phase 14's): triangular at D = 8,
    # rows as batch, its bias heads innermost (f32 as the fold makes it, and
    # bf16), and sequence attention at D = 16 with its permuted f32 bias, at
    # the examples' 40 residues and at 200 with padded keys
    f32 = torch.float32
    cases += [
        _attn_case(torch, g, f"tri fold f32 N={FOLD_LEN}", 1, FOLD_LEN, 4, 4, 8, f32,
                   rows_as_batch=True, tri_bias=f32),
        _attn_case(torch, g, "tri fold f32 N=200", 1, 200, 4, 4, 8, f32, rows_as_batch=True,
                   tri_bias=f32, pad=20),
        _attn_case(torch, g, "tri fold f32 N=200, bf16 bias", 1, 200, 4, 4, 8, f32,
                   rows_as_batch=True, pad=20),
        _attn_case(torch, g, f"seq fold f32 N={FOLD_LEN}", 1, FOLD_LEN, 4, 4, 16, f32,
                   bias="seq"),
        _attn_case(torch, g, "seq fold f32 N=200", 1, 200, 4, 4, 16, f32, bias="seq", pad=20),
        # above head dim 256 with every mask: D = 304 on the one-panel
        # 320-column instance (its warps in pairs, the second pair's columns
        # cut short), D = 328 on two panels
        _attn_case(torch, g, "f32 d304 bias causal window gqa", 2, 150, 4, 2, 304, f32,
                   bias="f32", causal=True, window=60, pad=15),
        _attn_case(torch, g, "f32 d328 bias causal", 2, 90, 4, 4, 328, f32, bias="f32",
                   causal=True, pad=9),
    ]
    worst, on_wg, on_f32 = 0.0, [], []
    for c in cases:
        args = (c["q"], c["k"], c["v"], c["bias"], c["kvlen"])
        kw = dict(causal=c["causal"], window=c["window"])
        got = flash_mha_kernel(*args, **kw)
        worst = max(worst, _flash_close(torch, got, flash_mha_plain(*args, **kw), c["v"],
                                        c["name"]))
        name = _flash_name(c["q"], c["k"], c["bias"], **kw)
        if name == "flash_mha_wg" or name in F32_FLASH:
            _flash_bitwise(torch, args, got, c["name"], **kw)
            (on_wg if name == "flash_mha_wg" else on_f32).append(c["name"])
    # triangular attention at N = 1024: the kernel over all rows, the plain
    # version on 8 of them with the same shared bias (over all rows it would
    # materialize (N, 4, N, N) f32 logits, 17 GB)
    tri = _attn_case(torch, g, "tri N=1024", 1, 1024, 4, 4, 32, bf, rows_as_batch=True, pad=24)
    got = flash_mha_kernel(tri["q"], tri["k"], tri["v"], tri["bias"], tri["kvlen"])
    sub = torch.tensor([0, 1, 137, 500, 511, 512, 999, 1023], device="cuda")
    want = flash_mha_plain(tri["q"][sub], tri["k"][sub], tri["v"][sub], tri["bias"],
                           tri["kvlen"][sub])
    tri_err = _flash_close(torch, got[sub], want, tri["v"], "tri N=1024 (8 rows)")
    _flash_bitwise(torch, (tri["q"], tri["k"], tri["v"], tri["bias"], tri["kvlen"]), got,
                "tri N=1024")
    worst = max(worst, tri_err)
    # the fold's other shapes on the Hopper kernel (timed in the phases that
    # run them: 6, 11, 16): batch 4 in bucket 256, the chunk-64 slab, a mesh
    # rank's N/W rows and a 2x2 grid rank's 64 rows and 128 query rows
    lens4 = ENGINE_LENGTHS[:ENGINE_MAX_BATCH]
    fold = [("tri, batch 4, bucket 256", _tri_rows(torch, g, lens4, 256, 256)),
            ("seq, batch 4, bucket 256", _seq_rows(torch, g, lens4, 256, structure=False)),
            ("structure, batch 4, bucket 256", _seq_rows(torch, g, lens4, 256, structure=True)),
            ("tri, bucket 2048, chunk 64", _tri_rows(torch, g, (ENGINE_LONG_LEN,), 64,
                                                     ENGINE_LONG_BUCKET))]
    fold += [(f"tri, mesh 1x{w} rank", _tri_rows(torch, g, (MESH_LENGTHS[0],), 256 // w, 256))
             for w in MESH_WIDTHS]
    # a chunked slab on a mesh rank: the bias gathered on its keys, laid out
    # (1, keys, queries, 4)
    outer = torch.randn((1, 256, 256, 4), generator=g, device="cuda").to(bf).permute(0, 3, 2, 1)
    fold.append(("tri, mesh rank chunk 64, bias keys outermost",
                 dict(_tri_rows(torch, g, (MESH_LENGTHS[0],), 64, 256), bias=outer)))
    grid = _seq_rows(torch, g, (GRID_LEN,), GRID_BUCKET, structure=False)
    fold.append(("seq, grid 2x2 rank", dict(grid, q=grid["q"][:, :GRID_BUCKET // 2],
                                             bias=grid["bias"][:, :, :GRID_BUCKET // 2])))
    for name, c in fold:
        args = (c["q"], c["k"], c["v"], c["bias"], c["kvlen"])
        got = flash_mha_kernel(*args)
        b = c["q"].shape[0]
        # rows of one shared bias: a few of them; a bias a block: every row
        sub = sorted({i for i in (0, 1, b // 3, b // 2 + 1, b - 1) if i < b}) \
            if c["bias"].shape[0] == 1 else range(b)
        sub = torch.tensor(list(sub), device="cuda")
        want = flash_mha_plain(c["q"][sub], c["k"][sub], c["v"][sub], c["bias"],
                               None if c["kvlen"] is None else c["kvlen"][sub])
        worst = max(worst, _flash_close(torch, got[sub], want, c["v"], name))
        _flash_bitwise(torch, args, got, name)
        on_wg.append(name)
        del got, want
    # calls the Hopper rule would take but no TMA box does (or a scale of 0):
    # the tensor-core kernel, held to the plain version
    rerouted = []
    q8 = torch.randn((64, 64, 8, 32), generator=g, device="cuda").to(bf)
    b8 = torch.randn((1, 64, 64, 8), generator=g, device="cuda").to(bf).permute(0, 3, 1, 2)
    rerouted.append(("8 heads a key, bf16 bias heads innermost", (q8, q8, q8, b8), {}))
    q4 = torch.randn((64, 64, 4, 32), generator=g, device="cuda").to(bf)
    odd = torch.randn((1, 64, 4, 64), generator=g, device="cuda").to(bf).permute(0, 2, 1, 3)
    rerouted.append(("bias with neither heads nor keys innermost", (q4, q4, q4,
                                                                    odd.transpose(2, 3)), {}))
    wide = torch.randn((1, 64, 66, 4), generator=g, device="cuda").to(bf)
    rerouted.append(("bias rows 66 keys apart (not 16-byte aligned)",
                     (q4, q4, q4, wide[:, :, 1:65].permute(0, 3, 1, 2)), {}))
    tri64 = _attn_case(torch, g, "tri N=64", 1, 64, 4, 4, 32, bf, rows_as_batch=True, pad=6)
    rerouted.append(("softmax scale 0", (tri64["q"], tri64["k"], tri64["v"], tri64["bias"],
                                         tri64["kvlen"]), {"softmax_scale": 0.0}))
    for name, args, kw in rerouted:
        if _flash_name(args[0], args[1], args[3], args[2], **kw) != "flash_mha":
            fail(f"flash_mha {name}: the rule does not send it to the tensor-core kernel")
        before = dispatch.launch_counts()
        got = flash_mha_kernel(*args, **kw)
        after = dispatch.launch_counts()
        if {v: after[v] - before[v] for v in after if after[v] != before[v]} != {"flash_mha": 1}:
            fail(f"flash_mha {name}: launched {after} from {before}, not flash_mha once")
        worst = max(worst, _flash_close(torch, got, flash_mha_plain(*args, **kw), args[2], name))
    log(f"flash_mha: the calls no TMA box takes ({[n for n, _, _ in rerouted]}) launched "
        f"flash_mha (the tensor-core kernel), allclose to flash_mha_plain")
    log(f"flash_mha: allclose on {len(cases) + 1 + len(fold)} cases (seq/tri/structure at "
        f"N=200,256, seq at N=1024 and 2048, tri at N=1024 on 8 rows, the batch-4, slab, mesh "
        f"and grid rank shapes; causal, window, GQA, D=8/16/128; "
        f"the fold's shapes on the Hopper kernel, other bf16 on the tensor cores (D=8 padded "
        f"to 16), f32 "
        f"on the float32 kernel, the reduced f32 fold's tri D=8 and seq D=16 among them), worst max|err| {worst:.3e}; on flash_mha_wg, two launches and "
        f"each row alone bitwise: {on_wg + ['tri N=1024']}; on flash_mha_f32 the same: "
        f"{on_f32}")

    def timed(c, name, shape, *, plain=True, library=True, err=0.0, keep=True):
        args = (c["q"], c["k"], c["v"], c["bias"], c["kvlen"])
        o = flash_mha_kernel(*args)
        b, n, h, d = c["q"].shape
        name = _flash_name(c["q"], c["k"], c["bias"]) if name == "flash_mha" else name
        row = _row(name, shape)
        row.max_abs_err = err
        row.ms = time_ms(torch, lambda: flash_mha_kernel(*args))
        if name == "flash_mha_wg":
            row.tc_ms = _tc_ms(torch, args)
        row.call_ms = call_ms(torch, lambda: flash_mha_kernel(*args))
        row.plain_ms = time_ms(torch, lambda: flash_mha_plain(*args), iters=3) if plain else None
        if plain:
            row.max_abs_err = float((o.float() - flash_mha_plain(*args).float()).abs().max())
        if library:
            # the library yardstick gets the bias expanded over the rows and
            # the key-length mask folded in (SDPA has no block broadcast)
            mask = c["bias"].float().expand(b, h, n, n).clone()
            if c["kvlen"] is not None:
                mask[..., int(c["kvlen"][0]):] = -1e30
            mask = mask.to(c["q"].dtype)
            qt, kt, vt = (a.transpose(1, 2) for a in (c["q"], c["k"], c["v"]))
            row.library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            del mask
        row.bound_ms, row.bound_by = bound_ms(nbytes(*args, o), 4 * b * h * n * n * d,
                                              f32=c["q"].dtype == torch.float32)
        if keep:
            rows.setdefault(name, []).append(row)
        log(row.line())
        return row

    by_name = {c["name"]: c for c in cases}
    timed(by_name["tri N=256"], "flash_mha", "tri: q,k,v (256, 256, 4, 32) bf16 views, "
          "bias (1, 4, 256, 256) bf16 transposed")
    timed(by_name["seq N=256"], "flash_mha", "seq: q,k,v (1, 256, 16, 64) bf16, "
          "bias (1, 16, 256, 256) f32 permuted")
    timed(by_name["structure N=256"], "flash_mha", "structure: q,k,v (1, 256, 16, 64) bf16, "
          "bias (1, 16, 256, 256) f32")
    timed(tri, "flash_mha", "tri: q,k,v (1024, 1024, 4, 32) bf16 views, "
          "bias (1, 4, 1024, 1024) bf16 transposed; error on 8 rows, plain and library "
          "over the 1,024 rows a quarter at a time", plain=False,
          library=False, err=tri_err)
    # its plain version and library yardstick over all 1,024 rows, one call
    # a quarter of them, each timed run doing all four: at once the plain
    # version's (N, 4, N, N) f32 logits would take 17 GB and SDPA's bias
    # expanded over the rows 8.6 GB in bf16.  One quarter's expanded mask
    # serves every quarter (the bias is the same for every row)
    quarters = [slice(i, i + 256) for i in range(0, 1024, 256)]
    mask = tri["bias"].expand(256, 4, 1024, 1024).clone()
    mask[..., 1024 - 24:] = -1e30
    qkv_t = [tuple(a[sub].transpose(1, 2) for a in (tri["q"], tri["k"], tri["v"]))
             for sub in quarters]
    rows["flash_mha_wg"][-1].library_ms = time_ms(torch, lambda: [
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask) for qt, kt, vt in qkv_t],
        iters=5)
    del mask, qkv_t
    qkvl = [tuple(a[sub] for a in (tri["q"], tri["k"], tri["v"], tri["kvlen"]))
            for sub in quarters]
    rows["flash_mha_wg"][-1].plain_ms = time_ms(torch, lambda: [
        flash_mha_plain(qs, ks, vs, tri["bias"], ls) for qs, ks, vs, ls in qkvl], iters=3)
    del qkvl
    log(f"flash_mha_wg tri N=1024: library_ms {rows['flash_mha_wg'][-1].library_ms:.4f} (SDPA, "
        f"the bias expanded over 256 rows, four calls), plain_ms "
        f"{rows['flash_mha_wg'][-1].plain_ms:.4f} (the plain version, four calls of 256 rows)")
    timed(by_name["seq N=2048"], "flash_mha", "seq: q,k,v (1, 2048, 16, 64) bf16, "
          "bias (1, 16, 2048, 2048) f32 permuted")
    c = by_name["tri N=256"]
    f32 = dict(c, q=c["q"].float(), k=c["k"].float(), v=c["v"].float())
    assert variant_for(f32["q"].dtype, 32, sq=256, hq=4, hkv=4, has_bias=True) == "f32"
    f32_args = (f32["q"], f32["k"], f32["v"], f32["bias"], f32["kvlen"])
    got = flash_mha_kernel(*f32_args)
    _flash_close(torch, got, flash_mha_plain(*f32_args), f32["v"], "tri N=256 f32")
    _flash_bitwise(torch, f32_args, got, "tri N=256 f32")
    del got
    timed(f32, "flash_mha_f32", "tri: q,k,v (256, 256, 4, 32) f32, bias (1, 4, 256, 256) bf16")
    # the reduced float32 fold's two attention shapes, their launches phase
    # 14's (fold_f32_launches)
    n = FOLD_LEN
    for c, shape in ((by_name[f"tri fold f32 N={n}"],
                      f"reduced f32 fold, tri: q,k,v ({n}, {n}, 4, 8) f32 views, bias (1, 4, "
                      f"{n}, {n}) f32 heads innermost"),
                     (by_name[f"seq fold f32 N={n}"],
                      f"reduced f32 fold, seq: q,k,v (1, {n}, 4, 16) f32, bias (1, 4, {n}, {n}) "
                      f"f32 permuted")):
        FOLD_F32_ROWS.append((timed(c, "flash_mha_f32", shape, keep=False),
                              ("flash", tuple(c["q"].shape))))


def check_lm_kernels(torch, rows: dict) -> list:
    """The flash and quantize kernels at the LM decode tenant's shapes
    (phase 8's): decode attention, one query row against a 256-row KV ring
    with a key length per slot (the first step's 1, a full ring), also with
    GQA at head dim 128, on the decode kernel: held to its plain version,
    two launches and a slot launched alone bitwise, timed beside the
    tensor-core kernel (``tc_ms``) and SDPA; a causal prefill; the KV-row
    quantize, bitwise.  Returns (row, launch tally key) for the rows phase
    8's run counts."""
    import torch.nn.functional as F
    from repro_torch.kernels.aaq_quant.aaq_quant import aaq_quantize_kernel
    from repro_torch.kernels.aaq_quant.ref import aaq_quantize_ref
    from repro_torch.kernels.flash_attention.flash_attention import (flash_mha_kernel,
                                                                     flash_mha_plain)
    g = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16
    pending = []

    def kv_case(hq, hkv, d, kvlen):
        q = torch.randn((4, 1, hq, d), generator=g, device="cuda").to(bf)
        k = torch.randn((4, 256, hkv, d), generator=g, device="cuda").to(bf)
        v = torch.randn((4, 256, hkv, d), generator=g, device="cuda").to(bf)
        return q, k, v, torch.tensor(kvlen, dtype=torch.int32, device="cuda")

    cases = [("lm decode", "qwen1.5-0.5b", 16, 16, 64, [1, 17, 255, 256]),
             ("lm decode GQA", "qwen2.5-3b", 16, 2, 128, [256, 100, 1, 37])]
    for label, arch, hq, hkv, d, kvlen in cases:
        q, k, v, kvl = kv_case(hq, hkv, d, kvlen)
        o = flash_mha_kernel(q, k, v, None, kvl)
        err = _flash_close(torch, o, flash_mha_plain(q, k, v, None, kvl), v, label)
        name = _flash_name(q, k, None)
        if name != "flash_mha":
            _flash_bitwise(torch, (q, k, v, None, kvl), o, label)
        row = _row(name, f"{label} ({arch}): q (4, 1, {hq}, {d}), k,v ring "
                         f"(4, 256, {hkv}, {d}) bf16, kv_valid_len {kvlen}")
        row.max_abs_err = err
        fn = lambda: flash_mha_kernel(q, k, v, None, kvl)  # noqa: E731
        row.ms, row.call_ms = time_ms(torch, fn), call_ms(torch, fn)
        if name != "flash_mha":
            row.tc_ms = _tc_ms(torch, (q, k, v, None, kvl))
        row.plain_ms = time_ms(torch, lambda: flash_mha_plain(q, k, v, None, kvl), iters=5)
        # SDPA with the key lengths as a boolean mask and the KV heads repeated
        keep = (torch.arange(256, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
        kt, vt = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2) for a in (k, v))
        qt = q.transpose(1, 2)
        row.library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep))
        # what these key lengths need: their K/V rows read once, q and o
        valid = int(kvl.sum())
        row.bound_ms, row.bound_by = bound_ms(
            nbytes(q, o, kvl) + 2 * valid * hkv * d * 2, 4 * valid * hq * d)
        pending.append((row, (name, ("lm", 4, 1, hq, d, None))))
        log(row.line())
    # a causal prefill (not on the served path: the tenant teacher-forces
    # prompts through decode steps), held to its plain version only
    q = torch.randn((2, 100, 16, 64), generator=g, device="cuda").to(bf)
    k = torch.randn((2, 100, 16, 64), generator=g, device="cuda").to(bf)
    v = torch.randn((2, 100, 16, 64), generator=g, device="cuda").to(bf)
    o = flash_mha_kernel(q, k, v, causal=True)
    err = _flash_close(torch, o, flash_mha_plain(q, k, v, causal=True), v, "lm causal prefill")
    _flash_bitwise(torch, (q, k, v, None, None), o, "lm causal prefill", causal=True)
    log(f"{_flash_name(q, k, None, causal=True)} lm causal prefill q,k,v (2, 100, 16, 64) bf16: "
        f"max|err| {err:.3e}, two launches and a row alone bitwise")
    # the KV rows: (slots x KV heads, head dim), group C (4 bits, no outliers)
    for t, h, arch in ((64, 64, "qwen1.5-0.5b"), (8, 128, "qwen2.5-3b")):
        x = torch.randn((t, h), generator=g, device="cuda").to(bf)
        x[0] = 0                                      # an all-zero row
        got = aaq_quantize_kernel(x, bits=4, k_outliers=0)
        want = aaq_quantize_ref(x, 4, 0)
        torch.cuda.synchronize()
        for name, a, b in zip(("inliers", "scales", "ovals", "oidx"), got, want):
            if not _bitwise(torch, a, b):
                fail(f"aaq_quantize {name} not bitwise equal on KV rows ({t}, {h})")
        row = _row("aaq_quantize", f"lm KV rows ({arch}): x ({t}, {h}) bf16, bits 4, k 0")
        fn = lambda: aaq_quantize_kernel(x, bits=4, k_outliers=0)  # noqa: E731
        row.ms, row.call_ms = time_ms(torch, fn), call_ms(torch, fn)
        row.plain_ms = time_ms(torch, lambda: aaq_quantize_ref(x, 4, 0), iters=5)
        row.bound_ms, row.bound_by = bound_ms(nbytes(x, *got), 0)
        pending.append((row, ("aaq_quantize", (t, h, 4, 0))))
        log(row.line())
    log("lm kernels: flash decode (Sq = 1 against a 256-row ring, kv_valid_len 1..256, "
        "GQA 16/2 at D = 128) and a causal prefill held to flash_mha_plain, two launches and "
        "a slot alone bitwise; KV-row aaq_quantize bitwise at (64, 64) and (8, 128)")
    return pending


# ---------------------------------------------------------------------------
# phases 4 and 5: the model
# ---------------------------------------------------------------------------
def _linear_outliers_dropped(x, w, *, bits, k_outliers):
    """The kernel route of an AAQ linear with the outlier term zeroed before
    the matmul kernel: the control a broken outlier gather would read."""
    from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel
    from repro_torch.kernels.aaq_quant.aaq_quant import aaq_quantize_kernel
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    q, s, ov, oi = aaq_quantize_kernel(flat, bits=bits, k_outliers=k_outliers)
    y = aaq_matmul_kernel(q, s, ov.zero_(), oi, w.contiguous(), bits=bits,
                          out_dtype=x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _flash_bias_dropped(q, k, v, bias, kv_valid_len, **kw):
    """The flash kernel launched without its additive bias: the control a
    kernel that lost the bias would read."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_mha_kernel
    return flash_mha_kernel(q, k, v, None, kv_valid_len, **kw)


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """Replace ``module.name`` by ``fn`` for the duration of a control fold."""
    sound = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, sound)


def check_forward(torch) -> None:
    from repro_torch.configs import get_ppm_config
    from repro_torch.core import make_scheme
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.kernels import dispatch
    from repro_torch.models.ppm import init_ppm, ppm_forward, tm_score
    from repro_torch.serving import pad_to_bucket
    cfg = dataclasses.replace(get_ppm_config(), blocks=2)
    params = init_ppm(cfg, seed=0, device="cuda")
    seq = ProteinSampler(seed=11).sample(0, length=FWD_LEN)
    aat, mask = pad_to_bucket([seq], FWD_BUCKET)
    aat, mask = torch.from_numpy(aat).cuda(), torch.from_numpy(mask).cuda()

    def fold(scheme, be):
        with torch.inference_mode(), dispatch.use_backend(be):
            out = ppm_forward(params, aat, cfg, make_scheme(scheme), mask=mask)
        c = out["coords"][0, :len(seq)].float().cpu()
        if not bool(torch.isfinite(c).all()):
            fail(f"forward {scheme} {be}: non-finite coords")
        return c

    fp, aaq = "baseline_fp16", "lightnobel_aaq"
    coords = {(s, be): fold(s, be) for s in (fp, aaq) for be in ("kernel", "ref")}
    with swapped(dispatch, "flash_mha_kernel", _flash_bias_dropped):
        bias_dropped = fold(fp, "kernel")
    with swapped(dispatch, "aaq_linear", _linear_outliers_dropped):
        before = dispatch.launch_counts()["aaq_matmul_wg"]
        outliers_dropped = fold(aaq, "kernel")
        if dispatch.launch_counts()["aaq_matmul_wg"] == before:
            fail("forward control aaq_matmul outlier term dropped: no aaq_matmul_wg launch")

    def tm_vs(c, scheme):
        ref = coords[scheme, "ref"]
        tm = float(tm_score(c, ref))
        rms = float((c - ref).pow(2).sum(-1).mean().sqrt())
        return tm, f"vs {scheme} ref: TM={tm:.5f} coord rms diff={rms:.4e}"

    where = f"forward 2 blocks full width, len {len(seq)} in bucket {FWD_BUCKET}"
    faults = []
    for scheme in (fp, aaq):
        tm, text = tm_vs(coords[scheme, "kernel"], scheme)
        log(f"{where}, {scheme} kernels {text} gate >= {TM_GATE}")
        if not tm >= TM_GATE:
            faults.append(f"forward {scheme}: TM {tm:.5f} < {TM_GATE}")
    for name, c, scheme in (("flash bias dropped", bias_dropped, fp),
                            ("aaq_matmul outlier term dropped", outliers_dropped, aaq)):
        tm, text = tm_vs(c, scheme)
        log(f"{where}, control {name} {text} must be < {TM_GATE}")
        if not tm < TM_GATE:
            faults.append(f"forward control {name}: TM {tm:.5f} passes the gate")
    _, text = tm_vs(coords[fp, "kernel"], aaq)
    log(f"{where}, no quantization ({fp} kernels) {text} (not gated)")
    if faults:
        fail("; ".join(faults))


def _serve_run(torch, cfg, params, seqs, what):
    """One run of the sequential server at full width: counters zeroed just
    before, read just after; every main-path kernel launched, no plain
    version, finite coords."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_ppm_sequential
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counters()
    results = serve_ppm_sequential(cfg, params, seqs, SERVE_BUCKETS,
                                   scheme="lightnobel_aaq", fidelity=True,
                                   device="cuda", emit=log)
    launches, plain = dispatch.launch_counts(), dispatch.plain_counts()
    routed = dict(dispatch.counters)
    peak = torch.cuda.max_memory_allocated()
    log(f"{what}: served {len(results)} requests; lengths {[r.length for r in results]} "
        f"in buckets {[r.bucket for r in results]}; latency_ms "
        f"{[round(r.latency_ms, 1) for r in results if r.latency_ms is not None]}; TM vs "
        f"baseline_fp16 {[round(r.tm_vs_fp, 4) for r in results if r.tm_vs_fp is not None]}; "
        f"peak memory {peak / 2**30:.2f} GiB on {torch.cuda.get_device_name(0)}")
    log(f"{what}: launches {launches}; plain versions {plain}; routed {routed}")
    for r in results:
        if r.bucket is None or r.coords is None or not bool(torch.isfinite(r.coords).all()):
            fail(f"{what} request {r.request}: no finite coords")
    _check_main_path(what, launches, plain, routed)
    if launches["aaq_fake_quant"] != routed["fakequant.kernel"]:
        fail(f"{what}: {routed['fakequant.kernel']} fake-quant calls routed to the kernel "
             f"but {launches['aaq_fake_quant']} launches")
    return results, launches


def serve_full_width(torch):
    from repro_torch.configs import get_ppm_config
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.models.ppm import init_ppm
    from repro_torch.models import common as cm
    cfg = get_ppm_config()
    t0 = time.perf_counter()
    params = init_ppm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"esmfold_ppm: {cfg.blocks} blocks, hm {cfg.hm}, hz {cfg.hz}, {cfg.dtype}, "
        f"{cm.count_params(params) / 1e6:.1f}M params ({cm.param_bytes(params) / 2**30:.2f} GiB) "
        f"made in {time.perf_counter() - t0:.1f}s")
    sampler = ProteinSampler(seed=11, min_len=64, max_len=256)
    seqs = [sampler.sample(i) for i in range(SERVE_N)]
    results, launches = _serve_run(torch, cfg, params, seqs, "short requests")
    folds = len(results)
    log(f"launches per fold: aaq_quantize {launches['aaq_quantize'] / folds:.0f}, "
        f"aaq_fake_quant {launches['aaq_fake_quant'] / folds:.0f}, "
        f"aaq_matmul_wg {launches['aaq_matmul_wg'] / folds:.0f} and aaq_matmul "
        f"{launches['aaq_matmul'] / folds:.0f} (D = 4) (lightnobel_aaq folds), "
        f"flash_mha_wg {launches['flash_mha_wg'] / (2 * folds):.0f} (every fold)")
    long_seq = ProteinSampler(seed=11).sample(SERVE_N, length=LONG_LEN)
    (res,), long_launches = _serve_run(torch, cfg, params, [long_seq], "long request")
    if res.bucket != 1024:
        fail(f"long request of {LONG_LEN} residues went to bucket {res.bucket}")
    log(f"long request: {LONG_LEN} residues in bucket {res.bucket}: latency "
        f"{res.latency_ms:.1f} ms, TM vs baseline_fp16 {res.tm_vs_fp:.4f}")
    total = {k: launches[k] + long_launches[k] for k in launches}
    return total, cfg, params


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


# the function that hands dispatch.attention its operands -> the attention it is
_ATTN_CALLERS = {"seq_attn_apply": "seq", "structure_apply": "structure", "attn_apply": "lm"}
# what may stand between that function and dispatch.attention: the LM's
# attention reaches it through the sharding layer's local_attention
_ATTN_RELAYS = ("local_attention",)


@contextlib.contextmanager
def launch_tally(full: bool = False):
    """Tally the launches a run hands each kernel wrapper, by variant and
    shape, and the ``AAQScheme.act`` calls with an enabled policy.  Wraps the
    ops' references to the wrappers, not their launch counts, so a launch
    captured into a CUDA graph passes through once and its replays never.
    Keys: the operands' last dims (``full=False``) or their whole shapes
    (``full=True``); flash launches also by attention (seq, structure, or
    tri for the triangular rows, chunked or not) and bias rows."""
    from repro_torch.core.schemes import AAQScheme
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.aaq_matmul import ops
    from repro_torch.kernels.aaq_quant import ops as qops
    tally = Counter()
    mm, fl = ops.aaq_matmul_kernel, dispatch.flash_mha_kernel
    qk, fq, act = qops.aaq_quantize_kernel, qops.aaq_fake_quant_kernel, AAQScheme.act

    def mm_counted(q, s, ov, oi, w, **kw):
        tally[("aaq_matmul", (q.shape[0], *w.shape) if full else tuple(w.shape))] += 1
        return mm(q, s, ov, oi, w, **kw)

    def qk_counted(x, *, bits, k_outliers):
        tally[("aaq_quantize", (*(x.shape if full else x.shape[-1:]), bits, k_outliers))] += 1
        return qk(x, bits=bits, k_outliers=k_outliers)

    def fq_counted(x, bits, k_outliers):
        tally[("aaq_fake_quant", (*(x.shape if full else x.shape[-1:]), bits, k_outliers))] += 1
        return fq(x, bits, k_outliers)

    def act_counted(self, x, site):
        if self.cfg.policy_for(site).enabled:
            tally[("act", "enabled")] += 1
        return act(self, x, site)

    def fl_counted(q, k, v, bias=None, kvl=None, **kw):
        # frame 1 is dispatch.attention, then the model code that called it
        frame = sys._getframe(2)
        while frame.f_code.co_name in _ATTN_RELAYS:
            frame = frame.f_back
        kind = _ATTN_CALLERS.get(frame.f_code.co_name, "tri")
        rows = None if bias is None else bias.shape[0]
        tally[(_flash_name(q, k, bias, v, **kw), (kind, *q.shape, rows) if full else kind)] += 1
        return fl(q, k, v, bias, kvl, **kw)

    with swapped(ops, "aaq_matmul_kernel", mm_counted), \
            swapped(dispatch, "flash_mha_kernel", fl_counted), \
            swapped(qops, "aaq_quantize_kernel", qk_counted), \
            swapped(qops, "aaq_fake_quant_kernel", fq_counted), \
            swapped(AAQScheme, "act", act_counted):
        yield tally


def profile_folds(torch, cfg, params) -> None:
    """Where a full-width fold's time goes: one fold per scheme at bucket
    256 under torch.profiler; device-busy share of the wall time, the
    kernels that take the most device time, and each kernel's device time.
    The profiler's own overhead lengthens the wall time, so the busy share
    is a lower bound.  The census fold before it must launch aaq_fake_quant
    once for each enabled ``AAQScheme.act`` call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import make_scheme
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.kernels import dispatch
    from repro_torch.models.ppm import ppm_forward
    from repro_torch.serving import pad_to_bucket
    seq = ProteinSampler(seed=11).sample(99, length=250)
    aat, mask = pad_to_bucket([seq], 256)
    aat, mask = torch.from_numpy(aat).cuda(), torch.from_numpy(mask).cuda()
    for scheme in ("lightnobel_aaq", "baseline_fp16"):
        with torch.inference_mode():
            before = dispatch.launch_counts()["aaq_fake_quant"]
            with launch_tally() as tally:                                    # warm
                ppm_forward(params, aat, cfg, make_scheme(scheme), mask=mask)
            torch.cuda.synchronize()
            fake = dispatch.launch_counts()["aaq_fake_quant"] - before
            log(f"launches per {scheme} fold by shape: "
                f"{ {f'{k[0]} {k[1]}': v for k, v in sorted(tally.items(), key=str)} }")
            acts = tally[("act", "enabled")]
            log(f"{scheme} fold: {acts} AAQScheme.act calls with an enabled policy "
                f"({acts / cfg.blocks:g} a block), {fake} aaq_fake_quant launches")
            if fake != acts or (scheme == "lightnobel_aaq" and not acts):
                fail(f"{scheme} fold: {fake} aaq_fake_quant launches for {acts} act calls")
            t0 = time.perf_counter()
            ppm_forward(params, aat, cfg, make_scheme(scheme), mask=mask)
            torch.cuda.synchronize()
            plain_wall = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ppm_forward(params, aat, cfg, make_scheme(scheme), mask=mask)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
                   if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            log(f"profile {scheme} N=250 in bucket 256: wall {plain_wall:.1f} ms unprofiled; "
                "the profiler recorded no device time (device busy: not measured)")
            continue
        busy = sum(us for _, us, _ in kernels) / 1e3
        n_launch = sum(c for _, _, c in kernels)
        log(f"profile {scheme} N=250 in bucket 256: wall {plain_wall:.1f} ms unprofiled, "
            f"{wall:.1f} ms profiled; device busy {busy:.1f} ms "
            f"({100 * busy / wall:.1f}% of the profiled wall); {n_launch} device kernels")
        for tag in ("aaq_quantize_lanes", "aaq_fake_quant_lanes", "aaq_matmul_tc",
                    "aaq_matmul_wg", "flash_wg",
                    "flash_tc"):
            hits = [(us, n) for name, us, n in kernels if tag in name]
            log(f"  {tag}: {sum(us for us, _ in hits) / 1e3:.2f} ms device time per fold "
                f"over {sum(n for _, n in hits)} launches")
        for name, us, count in sorted(kernels, key=lambda k: -k[1])[:8]:
            log(f"  {us / 1e3:8.2f} ms  {count:5d}x  {name[:100]}")


# ---------------------------------------------------------------------------
# phase 6: the batching engine, one CUDA graph per executable key
# ---------------------------------------------------------------------------
#: flash variants a bf16 fold never launches: its attention is the Hopper kernel's
OFF_FOLD_FLASH = ("flash_mha", "flash_mha_dec", "flash_mha_pf", "flash_mha_f32",
                  "flash_mha_f32_dec")
#: bf16 AAQ-linear matmuls on the card by the variant they launched, and the
#: calls whose launch broke the rule (D >= 8: aaq_matmul_wg, D < 8: the
#: tensor-core kernel) as (W's shape, launches of aaq_matmul and
#: aaq_matmul_wg)
MM_ROUTES: Counter = Counter()
MM_ROUTE_FAULTS: list = []


def _watch_matmul_routes() -> None:
    """Wrap the AAQ linear's matmul (``ops.aaq_matmul_kernel``, which every
    fold's ``dispatch.quantized_linear`` reaches) for the rest of the
    process: each bf16 call on the card records the variant its launch
    took.  ``_check_main_path`` fails a fold phase on any call that broke
    the rule."""
    import torch
    from repro_torch.kernels.aaq_matmul import aaq_matmul as mod
    from repro_torch.kernels.aaq_matmul import ops
    real = ops.aaq_matmul_kernel

    def watched(q, s, ov, oi, w, **kw):
        before = (mod.launches, mod.wg_launches)
        y = real(q, s, ov, oi, w, **kw)
        if w.is_cuda and w.dtype == torch.bfloat16:
            got = (mod.launches - before[0], mod.wg_launches - before[1])
            MM_ROUTES["aaq_matmul_wg" if got == (0, 1) else
                      "aaq_matmul" if got == (1, 0) else "other"] += 1
            if got != ((0, 1) if w.shape[1] >= 8 else (1, 0)):
                MM_ROUTE_FAULTS.append((tuple(w.shape), got))
        return y
    ops.aaq_matmul_kernel = watched


def _check_main_path(what, launches, plain, routed) -> None:
    from repro_torch.kernels import dispatch
    if any(launches[name] == 0 for name in dispatch.MAIN_PATH):
        fail(f"{what}: a main-path kernel was never launched: {launches}")
    if MM_ROUTE_FAULTS:
        fail(f"{what}: AAQ-linear calls whose launch broke the matmul rule (D >= 8 on "
             f"aaq_matmul_wg, D < 8 on aaq_matmul), as (W, launches of aaq_matmul and "
             f"aaq_matmul_wg): {MM_ROUTE_FAULTS[:8]}")
    if any(launches[name] for name in OFF_FOLD_FLASH):
        fail(f"{what}: the fold's attention launched another flash variant than "
             f"flash_mha_wg: {launches}")
    if any(plain.values()) or any(routed[f"{op}.ref"] for op in ("attention", "qmatmul",
                                                                    "fakequant")):
        fail(f"{what}: a plain version ran on the main path: {plain} {routed}")


def _counts():
    from repro_torch.kernels import dispatch
    return dispatch.launch_counts(), dispatch.plain_counts(), dict(dispatch.counters)


def _bitwise_out(torch, a, b) -> bool:
    return all(_bitwise(torch, a[k].contiguous(), b[k].contiguous())
               for k in ("coords", "distogram"))


def serve_engine(torch, cfg, params):
    """The engine phase (see the module docstring).  Returns the launches
    of its counted runs by variant and by shape, and the readings; each
    part's engine (and its graphs' memory pool) is gone when it returns."""
    import gc
    from repro_torch.data.pipeline import ProteinSampler
    sampler = ProteinSampler(seed=11)
    launches, tally, readings = _engine_short(torch, cfg, params, sampler)
    gc.collect()
    torch.cuda.empty_cache()
    llaunch, ltally, long_readings = _engine_long(torch, cfg, params, sampler)
    gc.collect()
    torch.cuda.empty_cache()
    readings.update(long_readings)
    return {k: launches[k] + llaunch[k] for k in launches}, tally, ltally, readings


def _engine_short(torch, cfg, params, sampler):
    from repro_torch.core import make_scheme
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_ppm_sequential
    from repro_torch.models.ppm import ppm_forward, tm_score
    from repro_torch.serving import (DEFAULT_LONGFOLD_BUDGET_MB, CompileWatcher,
                                     FoldClient, check_request_order, pad_to_bucket)
    card = f"{torch.cuda.get_device_name(0)}"
    seqs = [sampler.sample(200 + i, length=n) for i, n in enumerate(ENGINE_LENGTHS)]
    aaq = "lightnobel_aaq"
    client = FoldClient(params, cfg, aaq, buckets=ENGINE_BUCKETS,
                        max_batch=ENGINE_MAX_BATCH, inflight_depth=2, chunk_size="auto",
                        mem_budget_mb=DEFAULT_LONGFOLD_BUDGET_MB, fidelity=True,
                        device="cuda")
    core = client.core
    events = []
    client.subscribe(events.append)

    def serve_pass():
        t0 = time.perf_counter()
        handles = [client.submit(s) for s in seqs]
        client.drive()
        torch.cuda.synchronize()
        return [h.result() for h in handles], (time.perf_counter() - t0) * 1e3

    # the counted main-path run: cold, every key captured in it
    torch.cuda.reset_peak_memory_stats()
    watch = CompileWatcher()
    dispatch.reset_counters()
    with launch_tally(full=True) as tally:
        first, wall = serve_pass()
    launches, plain, routed = _counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"engine first pass: {len(first)} requests, lengths {[r.length for r in first]}, "
        f"buckets {[r.bucket for r in first]}, batches {[r.batch_size for r in first]} "
        f"(launched {[r.launched_batch for r in first]}), chunks "
        f"{sorted({r.chunk_size for r in first})}; wall {wall:.1f} ms with captures; "
        f"peak memory {peak / 2**30:.2f} GiB on {card}")
    log(f"engine first pass: launches {launches} (warm-up and capture of each key; "
        f"replays run no wrapper); plain versions {plain}; routed {routed}")
    _check_main_path("engine first pass", launches, plain, routed)
    for r in first:
        if not r.ok or r.coords is None or not np_finite(r.coords):
            fail(f"engine request {r.request_id}: status {r.status} {r.reason}")
    if max(r.batch_size for r in first) < 3:
        fail(f"engine: no launch at batch >= 3: {[r.batch_size for r in first]}")
    by_req = {}
    for e in events:
        by_req.setdefault(e.request_id, []).append(e)
    for rid, evs in by_req.items():
        check_request_order(evs)
    keys = {(r.bucket, r.launched_batch, s, r.placement, r.chunk_size)
            for r in first for s in (aaq, "baseline_fp16")}
    if not (core.compile_count == len(keys) == len(core._executables) == watch.delta()):
        fail(f"engine: {core.compile_count} captures, watcher {watch.delta()}, for "
             f"{len(keys)} distinct keys {sorted(keys)}")
    for exe in core._executables.values():
        d = exe.describe()
        log(f"  key {d['key']}: capture {d['capture_ms']:.1f} ms (with its eager warm-up), "
            f"instantiate {d['instantiate_ms']:.1f} ms, {d['nodes']} graph nodes, "
            f"kernel launches in the graph {d['kernel_launches']}")
    log(f"engine: {core.compile_count} captures for {len(keys)} distinct keys; graph pool "
        f"reserved {core.pool_reserved_bytes() / 2**30:.3f} GiB, memory_reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB (all pools, with the outputs)")

    # the same requests at batch 1 through the sequential server (eager)
    seq_res = serve_ppm_sequential(cfg, params, seqs, ENGINE_BUCKETS, scheme=aaq,
                                   fidelity=False, device="cuda", emit=lambda *_: None)
    tms = [float(tm_score(torch.from_numpy(r.coords), s.coords)) for r, s in zip(first, seq_res)]
    log(f"engine vs sequential batch 1: TM {[round(t, 5) for t in tms]} gate >= {ENGINE_TM_GATE}; "
        f"TM vs baseline_fp16 {[round(r.tm_vs_fp, 4) for r in first]}; run_ms "
        f"{[round(r.run_ms, 1) for r in first]}; queue_wait_ms "
        f"{[round(r.queue_wait_ms, 1) for r in first]}; compile_ms "
        f"{[round(r.compile_ms, 1) for r in first]}")
    if min(tms) < ENGINE_TM_GATE:
        fail(f"engine vs sequential: TM {min(tms):.5f} < {ENGINE_TM_GATE}")

    # steady state: the same requests again, no capture, the same coords
    watch.mark()
    replayed0 = dict(core.replayed_launches)
    dispatch.reset_counters()
    second, wall2 = serve_pass()
    launches2 = dispatch.launch_counts()
    replayed = {k: core.replayed_launches[k] - replayed0[k] for k in replayed0}
    same = all(np_equal(a.coords, b.coords) for a, b in zip(first, second))
    log(f"engine second pass: wall {wall2:.1f} ms, {watch.delta()} new captures, wrapper "
        f"launches {launches2}, kernel launches replayed by graphs {replayed}; coords "
        f"bitwise equal to the first pass: {same}; run_ms {[round(r.run_ms, 1) for r in second]}")
    if watch.delta() or core.compile_count != len(keys) or any(launches2.values()):
        fail(f"engine second pass captured again or launched outside a graph: "
             f"{watch.delta()} {launches2}")
    if not same or any(replayed[k] == 0 for k in dispatch.MAIN_PATH):
        fail(f"engine second pass: coords differ or a kernel was not replayed: {replayed}")

    # a graph replay against the eager forward of the same key and inputs
    b4 = [r for r in first if r.batch_size >= 3][0]
    rows = [s for s, r in zip(seqs, first) if r.bucket == b4.bucket][:b4.launched_batch]
    aat, mask = pad_to_bucket(rows, b4.bucket, b4.launched_batch)
    aat, mask = torch.from_numpy(aat).cuda(), torch.from_numpy(mask).cuda()
    exe = core._executables[(b4.bucket, b4.launched_batch, aaq, "single", b4.chunk_size)]
    graph_out = exe.launch(aat, mask)
    with torch.inference_mode():
        eager = ppm_forward(params, aat, cfg, make_scheme(aaq), mask=mask)
    torch.cuda.synchronize()
    bitwise = _bitwise_out(torch, graph_out, eager)
    geq_tm = min(float(tm_score(graph_out["coords"][i, :len(q)].float().cpu(),
                                eager["coords"][i, :len(q)].float().cpu()))
                 for i, q in enumerate(rows))
    log(f"graph vs eager, key {exe.describe()['key']}: coords and distogram bitwise equal: "
        f"{bitwise}; min TM {geq_tm:.6f}")
    if not bitwise and geq_tm < ENGINE_TM_GATE:
        fail(f"graph vs eager: not bitwise and TM {geq_tm:.5f} < {ENGINE_TM_GATE}")
    del graph_out, eager

    # time per request at batch 4 in bucket 256, and a batch-1 fold of
    # N = 250 through a graph under each scheme (timed after the counted
    # runs; these keys are captured here, outside them)
    ms4 = sorted(exe.timed_ms(aat, mask, clock=time.perf_counter) for _ in range(5))[2]
    readings = {"batch4_ms": ms4, "per_request_ms": ms4 / b4.launched_batch}
    one = sampler.sample(99, length=250)
    a1, m1 = pad_to_bucket([one], 256)
    a1, m1 = torch.from_numpy(a1).cuda(), torch.from_numpy(m1).cuda()
    for name in (aaq, "baseline_fp16"):
        e1, cap_s = core._executable(256, 1, make_scheme(name))
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = e1.launch(a1, m1)
            out["ready"].synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        dev_ms = sorted(e1.timed_ms(a1, m1, clock=time.perf_counter) for _ in range(5))[2]
        readings[f"{name}_b1_wall_ms"] = sorted(walls)[2]
        log(f"graph fold N=250 bucket 256 batch 1 {name}: wall {sorted(walls)[2]:.1f} ms "
            f"(median of 5, host clock around the replay), {dev_ms:.1f} ms by CUDA events; "
            f"capture {cap_s * 1e3:.1f} ms, {e1.nodes} graph nodes")
    log(f"batch 4 in bucket 256 ({aaq}): {ms4:.1f} ms a launch by CUDA events, "
        f"{ms4 / b4.launched_batch:.1f} ms a request; "
        f"graph pool {core.pool_reserved_bytes() / 2**30:.3f} GiB")
    readings["sequential"] = [(s, r.coords) for s, r in zip(seqs, seq_res)]
    return launches, dict(tally), readings


def _engine_long(torch, cfg, params, sampler):
    """One 2,000-residue request in bucket 2,048 through the chunked key."""
    import gc
    from repro_torch.kernels import dispatch
    from repro_torch.serving import DEFAULT_LONGFOLD_BUDGET_MB, FoldClient
    aaq = "lightnobel_aaq"
    long_client = FoldClient(params, cfg, aaq, buckets=(ENGINE_LONG_BUCKET,), max_batch=1,
                             chunk_size="auto", mem_budget_mb=DEFAULT_LONGFOLD_BUDGET_MB,
                             fidelity=False, device="cuda")
    lcore = long_client.core
    long_seq = sampler.sample(300, length=ENGINE_LONG_LEN)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reserved0 = torch.cuda.memory_reserved()
    segments0 = {sg["address"] for sg in torch.cuda.memory_snapshot()}
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counters()
    with launch_tally(full=True) as ltally:
        t0 = time.perf_counter()
        res = long_client.submit(long_seq).result()
        torch.cuda.synchronize()
        lwall = (time.perf_counter() - t0) * 1e3
    llaunch, lplain, lrouted = _counts()
    lpeak = torch.cuda.max_memory_allocated()
    lreserved = torch.cuda.memory_reserved()
    growth = torch.cuda.max_memory_reserved() - reserved0
    est = lcore.admission.estimate_bytes(ENGINE_LONG_BUCKET, 1)
    (lexe,) = lcore._executables.values()
    d = lexe.describe()
    log(f"long request: {res.length} residues in bucket {res.bucket}, chunk {res.chunk_size} "
        f"(ChunkPolicy auto at {DEFAULT_LONGFOLD_BUDGET_MB:.0f} MB), status {res.status}; "
        f"first pass {lwall:.1f} ms (capture {d['capture_ms']:.1f} ms with its eager warm-up, "
        f"instantiate {d['instantiate_ms']:.1f} ms, {d['nodes']} graph nodes), replay run_ms "
        f"{res.run_ms:.1f}")
    budget = DEFAULT_LONGFOLD_BUDGET_MB * 1e6
    log(f"long request: the planner's estimate {est / 1e6:.0f} MB, the budget it was admitted "
        f"under {budget / 1e6:.0f} MB, the graph pass's peak {(lpeak - base) / 1e6:.0f} MB above "
        f"the {base / 2**30:.2f} GiB held before it ({lpeak / 2**30:.2f} GiB allocated); graph "
        f"pool {lcore.pool_reserved_bytes() / 2**30:.3f} GiB, memory_reserved "
        f"{lreserved / 2**30:.3f} GiB after the key")
    if lpeak - base > budget:
        fail(f"long request: the graph pass peaked {(lpeak - base) / 1e6:.0f} MB above what was "
             f"held before it, over the {budget / 1e6:.0f} MB budget it was admitted under")
    # what the card holds for the key beyond the fold's peak: the graph pool,
    # and memory_reserved's growth from before the request (its peak over
    # the eager warm-up, the capture and the replay), both in admission's MB
    pool = lcore.pool_reserved_bytes()
    log(f"long request: graph pool {pool / 1e6:.0f} MB for a fold peak of "
        f"{(lpeak - base) / 1e6:.0f} MB: pool/peak {pool / (lpeak - base):.3f}; "
        f"memory_reserved grew by at most {growth / 1e6:.0f} MB ({reserved0 / 2**30:.3f} GiB "
        f"before the request, {lreserved / 2**30:.3f} GiB after it); budget "
        f"{budget / 1e6:.0f} MB; on {torch.cuda.get_device_name(0)}")
    pool_id = tuple(lcore.graph_pool)
    outside = [sg for sg in torch.cuda.memory_snapshot() if sg["address"] not in segments0
               and tuple(sg["segment_pool_id"]) != pool_id]
    log(f"long request: {len(outside)} segments outside the graph pool appeared with the key, "
        f"{sum(sg['total_size'] for sg in outside) / 1e6:.0f} MB: "
        + "; ".join(f"{sg['total_size'] / 1e6:.1f} MB segment, {sg['allocated_size'] / 1e6:.1f} "
                    f"MB allocated in blocks of "
                    f"{[round(bl['size'] / 1e6, 1) for bl in sg['blocks'] if bl['state'] == 'active_allocated']} MB"
                    for sg in sorted(outside, key=lambda sg: -sg["total_size"])[:6])
        + f" (the replay's distogram copy is {res.length}² x 64 padded to {ENGINE_LONG_BUCKET}²: "
        f"{ENGINE_LONG_BUCKET ** 2 * 64 * 2 / 1e6:.0f} MB in bf16)")
    if pool > budget or growth > budget:
        fail(f"long request: graph pool {pool / 1e6:.0f} MB or memory_reserved growth "
             f"{growth / 1e6:.0f} MB over the {budget / 1e6:.0f} MB budget it was admitted under")
    log(f"long request: launches {llaunch}; plain versions {lplain}; routed {lrouted}")
    _check_main_path("long request", llaunch, lplain, lrouted)
    if res.bucket != ENGINE_LONG_BUCKET or not res.chunk_size or not res.ok \
            or not np_finite(res.coords):
        fail(f"long request: bucket {res.bucket} chunk {res.chunk_size} status {res.status}")
    t0 = time.perf_counter()
    res2 = long_client.submit(long_seq).result()
    lwall2 = (time.perf_counter() - t0) * 1e3
    if lcore.compile_count != 1 or not np_equal(res.coords, res2.coords):
        fail("long request: the second fold captured again or changed its coords")
    log(f"long request, second fold (a replay): {lwall2:.1f} ms wall, run_ms {res2.run_ms:.1f}")
    readings = dict(long_chunk=res.chunk_size, long_wall_ms=lwall2, long_peak=lpeak - base,
                    long_est=est, long_capture_ms=d["capture_ms"], long_nodes=d["nodes"],
                    long_pool=pool, long_reserved=lreserved, long_reserved_growth=growth,
                    long_pool_over_peak=pool / (lpeak - base))
    chunk = res.chunk_size
    del long_client, lcore, lexe, res, res2
    gc.collect()
    torch.cuda.empty_cache()
    # what sets the peaks: the 1,000-residue fold unchunked in bucket 1,024
    # and the 2,000-residue fold chunked in bucket 2,048, eager, by stage
    memory_by_op(torch, cfg, params, sampler.sample(SERVE_N, length=LONG_LEN), 1024)
    eager_peak = memory_by_op(torch, cfg, params, long_seq, ENGINE_LONG_BUCKET, chunk)
    readings["long_eager_peak"] = eager_peak
    log(f"long request, eager: the planner's estimate {est / 1e6:.0f} MB, the budget "
        f"{budget / 1e6:.0f} MB, the whole fold's peak {eager_peak / 1e6:.0f} MB above what was "
        f"held before it")
    if eager_peak > budget:
        fail(f"long request, eager: the fold peaked {eager_peak / 1e6:.0f} MB above what was held "
             f"before it, over the {budget / 1e6:.0f} MB budget")
    return llaunch, dict(ltally), readings


def memory_by_op(torch, cfg, params, seq, bucket, chunk=None) -> int:
    """One eager lightnobel_aaq fold with the peak device memory of each
    stage: the input embedding, each trunk op (the largest over the 48
    blocks), the structure module and the distogram head.  Each reading is
    the peak allocation during the call, as an absolute and above what was
    held when the call began.  Returns the whole fold's peak above what was
    held before it (read apart, in a second fold with no stage reset)."""
    from repro_torch.core import make_scheme
    from repro_torch.models.ppm import chunking as ck
    from repro_torch.models.ppm import model as md
    from repro_torch.models.ppm import structure as st
    from repro_torch.models.ppm import trunk as tk
    from repro_torch.serving import pad_to_bucket
    rec: dict[str, tuple[int, int]] = {}
    depth = [0]

    def wrap(name, fn):
        def measured(*a, **k):
            if depth[0]:                  # inside a measured stage: its part
                return fn(*a, **k)
            depth[0] += 1
            try:
                return _measure(name, fn, a, k)
            finally:
                depth[0] -= 1
        return measured

    def _measure(name, fn, a, k):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        old = rec.get(name, (0, 0))
        rec[name] = (max(old[0], peak), max(old[1], peak - held))
        torch.cuda.reset_peak_memory_stats()
        return out

    targets = [(md, "input_embedding"), (st, "structure_apply"), (md, "distogram_head")]
    targets += [(tk, n) for n in ("seq_attn_apply", "seq_transition_apply", "opm_apply",
                                  "tri_mul_apply", "tri_attn_apply", "pair_transition_apply")]
    targets += [(ck, n) for n in ("seq_pair_bias_chunked", "opm_chunked", "tri_mul_chunked",
                                  "tri_attn_chunked", "pair_transition_chunked")]
    aat, mask = pad_to_bucket([seq], bucket)
    aat, mask = torch.from_numpy(aat).cuda(), torch.from_numpy(mask).cuda()
    with contextlib.ExitStack() as stack:
        for mod, name in targets:
            stack.enter_context(swapped(mod, name, wrap(name, getattr(mod, name))))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out = md.ppm_forward(params, aat, cfg, make_scheme("lightnobel_aaq"), mask=mask,
                                 chunk_size=chunk)
        torch.cuda.synchronize()
        del out
    # the whole fold: no stage resets the peak here
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = md.ppm_forward(params, aat, cfg, make_scheme("lightnobel_aaq"), mask=mask,
                             chunk_size=chunk)
    torch.cuda.synchronize()
    whole = torch.cuda.max_memory_allocated() - base
    del out
    order = sorted(rec.items(), key=lambda kv: -kv[1][0])
    log(f"peak memory by stage, eager lightnobel_aaq fold of {len(seq)} residues in bucket "
        f"{bucket}, chunk {chunk or 'none'} ({base / 2**30:.2f} GiB held before it): "
        + "; ".join(f"{name} {a / 2**30:.2f} GiB (+{d / 2**30:.2f})" for name, (a, d) in order)
        + f"; the whole fold +{whole / 2**30:.2f} GiB ({whole / 1e6:.0f} MB)")
    return whole


def check_slabbed_stages(torch, cfg, params) -> None:
    """The chunked path's slabbed input embedding, structure pair bias and
    distogram head against their unslabbed forms on the card, at bucket
    1,024 and chunk 64 on a pair tensor of the fold's scale: the embedding
    (sums and a gather, no product) and each slab's LayerNorm and
    symmetrization bitwise; the pair bias and the distogram, whose
    projections cuBLAS may block differently for fewer rows, within one
    bf16 ulp (2^-7 relative) plus 1e-3 of the largest output."""
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.models import common as cm
    from repro_torch.models.ppm import model as md
    from repro_torch.models.ppm import structure as st
    n, chunk = 1024, 64
    aat = torch.from_numpy(ProteinSampler(seed=11).sample(7, length=n)[None]).cuda()
    g = torch.Generator(device="cuda").manual_seed(8)
    z = torch.randn((1, n, n, cfg.hz), generator=g, device="cuda").to(cfg.torch_dtype)
    ps, pd = params["structure"], params["distogram"]
    with torch.inference_mode():
        want, got = md.input_embedding(params, aat, cfg), md.input_embedding(params, aat, cfg, chunk)
        if not all(_bitwise(torch, w, x) for w, x in zip(want, got)):
            fail("slabbed input embedding not bitwise equal to the unslabbed one")
        del want, got
        ln, zsym = cm.layernorm(ps["ln_z"], z), 0.5 * (z + z.transpose(1, 2))
        for rows in (slice(i, i + chunk) for i in range(0, n, chunk)):
            if not _bitwise(torch, cm.layernorm(ps["ln_z"], z[:, rows]), ln[:, rows]):
                fail(f"slabbed LayerNorm of the pair tensor differs at rows {rows}")
            if not _bitwise(torch, 0.5 * (z[:, rows] + z[:, :, rows].transpose(1, 2)),
                            zsym[:, rows]):
                fail(f"slabbed symmetrization differs at rows {rows}")
        del ln, zsym
        errs = []
        for name, fn in (("structure pair bias", lambda c: st.pair_bias(ps, z, c)),
                         ("distogram head", lambda c: md.distogram_head(pd, z, c))):
            want, got = fn(None).float(), fn(chunk).float()
            err = (got - want).abs()
            if not bool((err <= 2.0 ** -7 * want.abs() + 1e-3 * want.abs().max()).all()):
                fail(f"slabbed {name}: max err {float(err.max()):.3e} over tolerance")
            errs.append(f"{name} max|err| {float(err.max()):.3e} ({int((err > 0).sum())} of "
                        f"{err.numel()} differ)")
            del want, got, err
    torch.cuda.synchronize()
    log(f"slabbed stages at bucket {n}, chunk {chunk}: input embedding bitwise; LayerNorm and "
        f"symmetrization bitwise on each of {n // chunk} slabs; " + "; ".join(errs)
        + " (tolerance one bf16 ulp 2^-7 relative + 1e-3 of max|y|)")


def np_finite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(np.asarray(a)).all())


def np_equal(a, b) -> bool:
    import numpy as np
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def _tri_rows(torch, g, lens, rows, n):
    """Triangular attention's operands as the trunk builds them: q/k/v are
    (b*rows, n, 4, 32) views of a (b, rows, n, 384) bf16 projection, the
    bias a transposed (b, 4, n, n) bf16 view broadcast by block over each
    protein's rows, protein i's rows with key length lens[i]."""
    bf, b = torch.bfloat16, len(lens)
    qkv = torch.randn((b, rows, n, 384), generator=g, device="cuda").to(bf)
    q, k, v = (a.reshape(b * rows, n, 4, 32) for a in torch.split(qkv, 128, dim=-1))
    bias = torch.randn((b, n, n, 4), generator=g, device="cuda").to(bf).permute(0, 3, 1, 2)
    kvlen = torch.tensor(lens, dtype=torch.int32, device="cuda").repeat_interleave(rows)
    return dict(q=q, k=k, v=v, bias=bias, kvlen=kvlen)


def _seq_rows(torch, g, lens, n, *, structure):
    """Seq attention's (``structure=False``) or the structure module's
    operands as the model builds them for a batch: q/k/v (b, n, 16, 64)
    views of a (b, n, 3072) bf16 projection, a per-protein f32 bias
    permuted from (b, n, n, 16) (the structure module's minus a distance
    term), protein i's keys past lens[i] folded into its bias as -1e9."""
    b = len(lens)
    qkv = torch.randn((b, n, 3 * 1024), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (a.reshape(b, n, 16, 64) for a in torch.split(qkv, 1024, dim=-1))
    bias = torch.randn((b, n, n, 16), generator=g, device="cuda").to(torch.bfloat16)
    bias = bias.permute(0, 3, 1, 2).float()
    if structure:
        d2 = torch.rand((b, n, n), generator=g, device="cuda")
        bias = bias - 0.7 * d2[:, None]
    real = torch.arange(n, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
    bias = bias + torch.where(real, 0.0, -1e9).float()[:, None, None, :]
    return dict(q=q, k=k, v=v, bias=bias, kvlen=None)


def _flash_engine_row(torch, rows, pending, c, lens, label, part, kind, shape):
    """One flash row at an engine shape: against its plain version, timed,
    with SDPA on the bias expanded over the rows and the key lengths folded
    in as the library yardstick."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import flash_mha_kernel, flash_mha_plain
    args = (c["q"], c["k"], c["v"], c["bias"], c["kvlen"])
    o = flash_mha_kernel(*args)
    name = _flash_name(c["q"], c["k"], c["bias"])
    row = _row(name, f"{label}: {kind} {shape}")
    row.max_abs_err = _flash_close(torch, o, flash_mha_plain(*args), c["v"], f"{kind} at {label}")
    if name == "flash_mha_wg":
        _flash_bitwise(torch, args, o, f"{kind} at {label}")
        row.tc_ms = _tc_ms(torch, args)
    bq, n, h, d = c["q"].shape
    pending.append((row, part, (name, (kind, bq, n, h, d, len(lens)))))
    row.ms = time_ms(torch, lambda: flash_mha_kernel(*args))
    row.call_ms = call_ms(torch, lambda: flash_mha_kernel(*args))
    row.plain_ms = time_ms(torch, lambda: flash_mha_plain(*args), iters=3)
    per = bq // len(lens)
    mask = c["bias"].repeat_interleave(per, dim=0).float()
    if c["kvlen"] is not None:
        for i, ln in enumerate(lens):
            mask[i * per:(i + 1) * per, ..., ln:] = -1e30
    mask = mask.to(c["q"].dtype)
    qt, kt, vt = (a.transpose(1, 2) for a in (c["q"], c["k"], c["v"]))
    row.library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    del mask
    row.bound_ms, row.bound_by = bound_ms(nbytes(*args, o), 4 * bq * h * n * c["k"].shape[1] * d)
    rows.setdefault(name, []).append(row)
    log(row.line())


def check_engine_shapes(torch, rows: dict) -> list:
    """Each kernel at the engine's new main-path shapes: batch 4 in bucket
    256 (the engine phase's four longest requests; triangular, seq and
    structure attention with each protein's own key length) and the
    chunk-64 slabs of bucket 2,048, against its plain version and timed.
    Returns (row, part, launch tally key) for each row, whose launches the
    engine's capture passes give."""
    g = torch.Generator(device="cuda").manual_seed(6)
    pending = []
    where = (("batch 4, bucket 256", "short", ENGINE_LENGTHS[:ENGINE_MAX_BATCH], 256, 256),
             ("bucket 2048, chunk 64", "long", (ENGINE_LONG_LEN,), 64, ENGINE_LONG_BUCKET))
    for label, part, lens, nrows, n in where:
        b = len(lens)
        _pair_kernels_at(torch, g, rows, pending, label, part, lens, nrows, n)
        if part == "short":
            for kind in ("seq", "structure"):
                _flash_engine_row(torch, rows, pending,
                                  _seq_rows(torch, g, lens, n, structure=kind == "structure"),
                                  lens, label, part, kind,
                                  f"q,k,v ({b}, {n}, 16, 64) bf16 views, bias ({b}, 16, {n}, {n})"
                                  f" f32 permuted, one per protein, key lengths {list(lens)} "
                                  f"folded into it")
        torch.cuda.empty_cache()
    return pending


def _pair_kernels_at(torch, g, rows, pending, label, part, lens, nrows, n) -> None:
    """The pair track's kernels where each protein of ``lens`` (bucket
    ``n``) runs ``nrows`` rows of its pair tensor: the quantize forms and
    ``aaq_matmul`` on (b * nrows * n, 128) tokens and triangular attention
    over nrows rows a protein, each against its plain version and timed;
    appends (row, part, launch tally key) to ``pending``."""
    from repro_torch.kernels.aaq_matmul.aaq_matmul import aaq_matmul_kernel
    from repro_torch.kernels.aaq_matmul.ref import aaq_matmul_ref
    from repro_torch.kernels.aaq_quant.aaq_quant import aaq_fake_quant_kernel, aaq_quantize_kernel
    from repro_torch.kernels.aaq_quant.ref import aaq_fake_quant_ref, aaq_quantize_ref
    b = len(lens)
    t = b * nrows * n
    for name in ("aaq_quantize", "aaq_fake_quant"):
        x = _linear_input(torch, g, t, 128) if name == "aaq_quantize" else \
            torch.randn((t, 128), generator=g, device="cuda").to(torch.bfloat16)
        kern = (lambda: aaq_quantize_kernel(x, bits=4, k_outliers=4)) if name == "aaq_quantize" \
            else (lambda: aaq_fake_quant_kernel(x, 4, 4))
        plain = (lambda: aaq_quantize_ref(x, 4, 4)) if name == "aaq_quantize" \
            else (lambda: aaq_fake_quant_ref(x, 4, 4))
        got, want = kern(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        if not all(_bitwise(torch, a, c) for a, c in zip(got, want)):
            fail(f"{name} at {label}: not bitwise equal to its plain version")
        row = _row(name, f"{label}: x ({t}, 128) bf16, bits 4, k 4")
        pending.append((row, part, (name, (t, 128, 4, 4))))
        row.ms, row.call_ms = time_ms(torch, kern), call_ms(torch, kern)
        row.plain_ms = time_ms(torch, plain, iters=3)
        row.bound_ms, row.bound_by = bound_ms(nbytes(x, *got), 0)
        rows.setdefault(name, []).append(row)
        log(row.line())
    x = torch.randn((t, 128), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((128, 128), generator=g, device="cuda") / math.sqrt(128)).to(torch.bfloat16)
    q, sc, ov, oi = aaq_quantize_ref(x, 4, 4)
    y = aaq_matmul_kernel(q, sc, ov, oi, w, bits=4, out_dtype=torch.bfloat16)
    want = aaq_matmul_ref(q, sc, ov, oi, w, bits=4, out_dtype=torch.bfloat16)
    name = _mm_name(w, 4)
    err = _mm_close(torch, y, want, f"{name} at {label}")
    if name == "aaq_matmul_wg":
        _mm_bitwise(torch, q, sc, ov, oi, w, y, label)
    row = _row(name, f"{label}: q ({t}, 64) int4 packed, W (128, 128) bf16, bits 4, k 4")
    pending.append((row, part, ("aaq_matmul", (t, 128, 128))))
    row.max_abs_err = err
    fn = lambda: aaq_matmul_kernel(q, sc, ov, oi, w, bits=4, out_dtype=torch.bfloat16)  # noqa: E731
    row.ms, row.call_ms = time_ms(torch, fn), call_ms(torch, fn)
    if name == "aaq_matmul_wg":
        row.tc_ms = _mm_tc_ms(torch, q, sc, ov, oi, w)
    row.plain_ms = time_ms(torch, lambda: aaq_matmul_ref(q, sc, ov, oi, w, bits=4,
                                                         out_dtype=torch.bfloat16), iters=3)
    row.library_ms = time_ms(torch, lambda: x @ w)
    row.bound_ms, row.bound_by = bound_ms(nbytes(q, sc, ov, oi, w, y), 2 * t * 128 * 128)
    rows.setdefault(name, []).append(row)
    log(row.line())
    del x, q, sc, ov, oi, y, want
    _flash_engine_row(torch, rows, pending, _tri_rows(torch, g, lens, nrows, n), lens,
                      label, part, "tri",
                      f"q,k,v ({b * nrows}, {n}, 4, 32) bf16 views, bias ({b}, 4, {n}, {n}) "
                      f"bf16 transposed, block-broadcast, key lengths {list(lens)}")


# ---------------------------------------------------------------------------
# phase 7: the fleet over HTTP, and the comparison schemes
# ---------------------------------------------------------------------------
def _metric_total(text: str, name: str) -> float:
    """Sum of one series' samples in a Prometheus text body."""
    return sum(float(ln.split()[-1]) for ln in text.splitlines()
               if ln.startswith(name + "{") or ln.startswith(name + " "))


def _gather(fn, args) -> list:
    """``fn`` over ``args`` on one thread each (concurrent HTTP clients)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(args)) as pool:
        return list(pool.map(fn, args))


def _replays(core) -> int:
    return sum(e.replays for e in core._executables.values())


def serve_fleet(torch, cfg, params, sequential) -> dict:
    """``FoldHTTPServer`` over a ``FleetRouter`` of 2 replicas at full width
    on 127.0.0.1:0, phase 6's short settings, fidelity on.  Each replica is
    warmed with the key ladder {1, 2, 4} of every bucket (every launch size
    of a batch of up to 4 maps onto one), so that every capture precedes
    serving: a pass of phase 6's 8 requests, posted concurrently and each
    followed over SSE, then a second pass; each result decoded off the
    wire, bitwise the serving replica's own and TM >= 0.9995 against the
    sequential batch-1 fold.  Then replica 0 is failed (``mark_failed``,
    as the reference's test does) under a burst of 16 requests with
    ``max_restarts=1``: its queued requests are requeued under their ids
    and served, the rebuilt replica captures the keys it is sent while
    replica 1 only replays, and the old engine's graph pool is released.
    Returns the kernel launches of the fleet's run (the warm-ups and the
    rebuilt replica's captures; replays run no wrapper)."""
    import urllib.request
    import numpy as np
    from repro_torch.kernels import dispatch
    from repro_torch.models.ppm import tm_score
    from repro_torch.serving import (DEFAULT_LONGFOLD_BUDGET_MB, FleetRouter, FoldClient,
                                     FoldHTTPServer, check_request_order)
    from repro_torch.serving import events as ev
    from repro_torch.serving.transport import protocol
    from repro_torch.serving.transport.server import request_json
    aaq = "lightnobel_aaq"
    built = Counter()

    def factory(i: int) -> FoldClient:
        client = FoldClient(params, cfg, aaq, buckets=ENGINE_BUCKETS,
                            max_batch=ENGINE_MAX_BATCH, inflight_depth=2, chunk_size="auto",
                            mem_budget_mb=DEFAULT_LONGFOLD_BUDGET_MB, fidelity=True,
                            device="cuda")
        if not built[i]:            # a restart captures lazily, while serving
            client.core.warmup(ladder=(1, 2, 4))
        built[i] += 1
        return client

    torch.cuda.synchronize()
    dispatch.reset_counters()
    t0 = time.perf_counter()
    router = FleetRouter(factory, 2, max_restarts=1)
    warm_s = time.perf_counter() - t0
    launches, plain, routed = _counts()
    keys = {i: sorted(r.client.core._executables) for i, r in enumerate(router.replicas)}
    for i, r in enumerate(router.replicas):
        core = r.client.core
        if core.compile_count != len(keys[i]) or len(keys[i]) != 18:
            fail(f"fleet replica {i}: {core.compile_count} captures for {len(keys[i])} keys")
    log(f"fleet: 2 replicas warmed in {warm_s:.1f} s, {len(keys[0])} keys each (buckets "
        f"{ENGINE_BUCKETS} x launch sizes 1/2/4 x 2 schemes), one capture per key per replica; "
        f"graph pools {[round(r.client.core.pool_reserved_bytes() / 2**30, 3) for r in router.replicas]}"
        f" GiB, memory_reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB")
    _check_main_path("fleet warm-up", launches, plain, routed)
    tm_ref = {tuple(s.tolist()): c for s, c in sequential}
    server = FoldHTTPServer(router, port=0, host="127.0.0.1").start()
    url = server.url

    def post(seq):
        t = time.perf_counter()
        rid = request_json(f"{url}/v1/fold", method="POST",
                           body={"sequence": seq.tolist()})["id"]
        return rid, t

    def follow(rid):
        with urllib.request.urlopen(f"{url}/v1/fold/{rid}/events", timeout=600) as resp:
            return protocol.parse_sse(resp.read()), time.perf_counter()

    def http_pass(seqs, what):
        t = time.perf_counter()
        posted = _gather(post, list(seqs))
        streams = _gather(follow, [rid for rid, _ in posted])
        wall = time.perf_counter() - t
        out = []
        for (rid, t_post), (events, t_end), seq in zip(posted, streams, seqs):
            check_request_order(events)
            if events[-1].kind != ev.COMPLETED:
                fail(f"{what}: request {rid} ended {events[-1].kind}")
            st = request_json(f"{url}/v1/fold/{rid}")
            rec = router.get(rid)
            mine = rec.handle._result
            wire = protocol.decode_array(st["result"]["coords"])
            if st["state"] != "DONE" or not mine.ok or wire.tobytes() != mine.coords.tobytes():
                fail(f"{what}: request {rid} not bitwise its replica's in-process result")
            tm = float(tm_score(torch.from_numpy(wire), tm_ref[tuple(seq.tolist())]))
            out.append(dict(rid=rid, replica=st["replica"], requeues=st["requeues"],
                            events=events, tm=tm, ms=(t_end - t_post) * 1e3,
                            run_ms=mine.run_ms, batch=mine.batch_size))
        tms = [o["tm"] for o in out]
        log(f"{what}: {len(out)} requests over HTTP in {wall * 1e3:.1f} ms; replicas "
            f"{[o['replica'] for o in out]}, batches {[o['batch'] for o in out]}, requeues "
            f"{[o['requeues'] for o in out]}; POST-to-terminal ms "
            f"{[round(o['ms'], 1) for o in out]} (median {sorted(o['ms'] for o in out)[len(out) // 2]:.1f}); "
            f"run_ms {[round(o['run_ms'], 1) for o in out]}; TM vs sequential batch 1 "
            f"{[round(t, 5) for t in tms]} gate >= {ENGINE_TM_GATE}; SSE order legal, wire "
            f"bitwise the replicas' own")
        if min(tms) < ENGINE_TM_GATE:
            fail(f"{what}: TM {min(tms):.5f} < {ENGINE_TM_GATE}")
        return out

    try:
        seqs = [s for s, _ in sequential]
        first = http_pass(seqs, "fleet first pass")
        second = http_pass(seqs, "fleet second pass")
        cores = [r.client.core for r in router.replicas]
        for i, core in enumerate(cores):
            text = urllib.request.urlopen(f"{url}/metrics/replica/{i}").read().decode()
            scraped = _metric_total(text, "fold_compiles_total")
            if core.compile_count != len(keys[i]) or scraped != len(keys[i]):
                fail(f"fleet replica {i}: captures {core.compile_count}, scraped {scraped}, "
                     f"for {len(keys[i])} keys after two passes")
        hz, fleet = request_json(f"{url}/healthz"), request_json(f"{url}/v1/fleet")
        text = urllib.request.urlopen(f"{url}/metrics").read().decode()
        routed_total = _metric_total(text, "fleet_routed_total")
        if not hz["ok"] or fleet["healthy"] != 2 or routed_total != 2 * len(seqs):
            fail(f"fleet endpoints: healthz {hz}, fleet {fleet}, routed {routed_total}")
        log(f"fleet endpoints: /healthz ok {hz['ok']}, replicas {[(r['index'], r['healthy'], r['restarts']) for r in hz['replicas']]}; "
            f"/v1/fleet {fleet['replicas']} replicas, {fleet['healthy']} healthy; /metrics "
            f"fleet_routed_total {routed_total:.0f}; /metrics/replica/<i> fold_compiles_total "
            f"{[len(keys[i]) for i in range(2)]}: no capture in either pass")
        # the lazy distogram of one request, materialized by a handler thread
        rid = first[0]["rid"]
        st = request_json(f"{url}/v1/fold/{rid}?distogram=1")
        dist = protocol.decode_array(st["result"]["distogram"])
        if dist.tobytes() != np.asarray(router.get(rid).handle._result.distogram).tobytes():
            fail("fleet: the distogram over the wire differs from the replica's")
        # two engines' graphs of one key on the same inputs (a finding)
        from repro_torch.serving import pad_to_bucket
        big = max(ENGINE_BUCKETS)
        aat, mask = pad_to_bucket(seqs[:4], big, 4)
        aat, mask = (torch.from_numpy(a).to(cores[0].device) for a in (aat, mask))
        outs = [c._executables[(big, 4, aaq, "single", 0)].launch(aat, mask) for c in cores]
        torch.cuda.synchronize()
        log(f"fleet: the two replicas' graphs of key {big}|4|{aaq} give bitwise-equal coords: "
            f"{_bitwise(torch, outs[0]['coords'], outs[1]['coords'])} (a finding, not a gate)")
        del outs

        # replica 0 fails under a burst; max_restarts=1 rebuilds it
        old = router.replicas[0].client
        old_pool = tuple(old.core.graph_pool)
        old_pool_b = old.core.pool_reserved_bytes()
        reserved_before = torch.cuda.memory_reserved()
        captures1 = cores[1].compile_count
        replays1 = _replays(cores[1])
        burst = seqs + seqs
        t = time.perf_counter()
        posted = _gather(post, burst)
        router.replicas[0].mark_failed()
        requeued = router.check_health()
        t_restart = time.perf_counter()
        streams = _gather(follow, [rid for rid, _ in posted])
        t_streams = time.perf_counter()
        router.drain_wait(timeout=600.0)
        router.join_released(timeout=600.0)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        burst_ms = (t_end - t) * 1e3
        new = router.replicas[0].client
        caps = [(e.describe()["key"], round(e.capture_ms), round(e.instantiate_ms))
                for e in new.core._executables.values()]
        log(f"fleet failure timeline: posted and restarted at {(t_restart - t) * 1e3:.1f} ms, "
            f"every stream terminal at {(t_streams - t) * 1e3:.1f} ms, drained and the old "
            f"client released at {(t_end - t) * 1e3:.1f} ms; the rebuilt replica's captures "
            f"(key, ms with its warm-up, instantiate ms): {caps}; streams ended at "
            f"{sorted(round((e - t) * 1e3) for _, e in streams)} ms")
        for (rid, _), (events, _), seq in zip(posted, streams, burst):
            check_request_order(events)
            kinds = [e.kind for e in events]
            res = router.get(rid).handle._result
            if not res.ok or kinds[-1] != ev.COMPLETED or kinds.count(ev.SUBMITTED) != 1:
                fail(f"fleet failure: request {rid} {res.status} events {kinds}")
            tm = float(tm_score(torch.from_numpy(res.coords), tm_ref[tuple(seq.tolist())]))
            if tm < ENGINE_TM_GATE:
                fail(f"fleet failure: request {rid} TM {tm:.5f} < {ENGINE_TM_GATE}")
        leaked = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg["segment_pool_id"]) == old_pool)
        new_pool_b = new.core.pool_reserved_bytes()
        reserved_after = torch.cuda.memory_reserved()
        log(f"fleet failure: replica 0 failed under a burst of {len(burst)} requests; "
            f"{len(requeued)} requeued under their ids {sorted(requeued)}; all {len(burst)} ok "
            f"in {burst_ms:.1f} ms, each stream legal with one SUBMITTED; replica 0 rebuilt "
            f"(restarts {router.replicas[0].restarts}) captured {new.core.compile_count} keys "
            f"while replica 1 captured {cores[1].compile_count - captures1} and replayed "
            f"{_replays(cores[1]) - replays1} launches; the old client released: "
            f"{router.released == [old]}, its pool {old_pool_b / 2**30:.3f} GiB -> "
            f"{leaked / 2**30:.3f} GiB left; new pool {new_pool_b / 2**30:.3f} GiB; "
            f"memory_reserved {reserved_before / 2**30:.3f} -> {reserved_after / 2**30:.3f} GiB")
        if not requeued or router.replicas[0].restarts != 1 or not new.core.compile_count:
            fail(f"fleet failure: requeued {requeued}, restarts {router.replicas[0].restarts}, "
                 f"captures on the rebuilt replica {new.core.compile_count}")
        if cores[1].compile_count != captures1 or _replays(cores[1]) == replays1:
            fail("fleet failure: replica 1 captured, or did not replay, during the restart")
        if router.released != [old] or leaked or \
                reserved_after > reserved_before - old_pool_b + new_pool_b + 2 ** 29:
            fail(f"fleet failure: the old client's memory was not released (pool segments "
                 f"left {leaked} B; memory_reserved {reserved_before} -> {reserved_after} B)")
        # the whole phase's launches: the warm-ups, and the rebuilt replica's captures
        launches, plain, routed = _counts()
        _check_main_path("fleet", launches, plain, routed)
    finally:
        server.stop()
        router.stop()
    del router, old, new, cores
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def fold_schemes(torch, cfg, params) -> None:
    """One N = 250 request under each of the five comparison schemes through
    the sequential server at full width, eager (plain PyTorch schemes; the
    attention still runs the flash kernel): fold time and TM against
    baseline_fp16.  Only finite coords are gated."""
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.launch.serve import serve_ppm_sequential
    seq = ProteinSampler(seed=11).sample(99, length=250)
    rows = []
    for name in ("smoothquant", "llm_int8", "ptq4protein", "tender", "mefold"):
        serve_ppm_sequential(cfg, params, [seq], (256,), scheme=name, fidelity=False,
                             device="cuda", emit=lambda *_: None)            # warm
        (res,) = serve_ppm_sequential(cfg, params, [seq], (256,), scheme=name, fidelity=True,
                                      device="cuda", emit=lambda *_: None)
        if res.coords is None or not bool(torch.isfinite(res.coords).all()):
            fail(f"scheme {name}: no finite coords")
        rows.append(f"{name} {res.latency_ms:.1f} ms TM {res.tm_vs_fp:.4f}")
    log(f"comparison schemes, N = 250 in bucket 256, sequential, eager, full width: "
        + "; ".join(rows) + " (TM against baseline_fp16; finite coords gated)")


# ---------------------------------------------------------------------------
# phase 8: the LM decode tenant, one CUDA graph per scheme
# ---------------------------------------------------------------------------
def _lm_prompts(vocab: int, n: int):
    import numpy as np
    rng = np.random.default_rng(11)          # the reference example's trace
    return [rng.integers(0, vocab, size=int(rng.integers(4, 17))).astype(np.int32)
            for _ in range(n)]


def _lm_model(torch, arch: str):
    from repro_torch.configs import get_config
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    log(f"{arch}: {cfg.layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} KV heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, "
        f"{cm.count_params(params) / 1e9:.3f}B params ({cm.param_bytes(params) / 2**30:.2f} GiB) "
        f"from seed 0 in {time.perf_counter() - t0:.1f}s")
    return cfg, params


def _lm_serve(torch, cfg, params, scheme, prompts, max_new, tally_into=None):
    """One ``LMClient`` (window 256, 4 slots): warm-up (the one capture)
    and the trace, with the counters zeroed just before and read just
    after.  Gates: every request served, one capture and none after the
    warm-up, flash on every layer of the captured step and, under AAQ, two
    aaq_quantize launches a layer, no plain version, no launch outside
    the graph while serving."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention.flash_attention import VARIANT_NAMES, variant_for
    from repro_torch.serving import CompileWatcher, LMClient
    client = LMClient(params, cfg, scheme, window=256, max_slots=4,
                      default_max_new_tokens=max_new, device="cuda")
    core = client.core
    watch = CompileWatcher()
    dispatch.reset_counters()
    with launch_tally(full=True) as tally:
        t0 = time.perf_counter()
        client.warmup()
        capture_ms = (time.perf_counter() - t0) * 1e3
        captured = watch.delta()
        watch.mark()
        t0 = time.perf_counter()
        results = client.run(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, plain, routed = _counts()
    if tally_into is not None:
        tally_into.update(tally)
    (exe,) = core._executables.values()
    per_step = exe.kernel_launches
    quant = scheme != "baseline_fp16"
    # the rule's flash variant for one query row a slot: the decode kernel
    flash = VARIANT_NAMES[variant_for(cfg.torch_dtype, cfg.hd, sq=1, hq=cfg.n_heads,
                                      hkv=cfg.n_kv_heads)]
    if flash != "flash_mha_dec":
        fail(f"lm {cfg.name}: the served step's attention would launch {flash}, not the "
             "decode kernel")
    want = {k: 0 for k in per_step}
    want[flash] = cfg.layers
    if quant:
        want["aaq_quantize"] = 2 * cfg.layers
    s = client.metrics.summary()
    # the step's device time: one replay by CUDA events (it writes ring row 0,
    # which the KV-row check leaves out)
    zeros = torch.zeros((4,), dtype=torch.int32, device="cuda")
    replay_ms = sorted(exe.timed_ms(zeros, zeros, clock=time.perf_counter) for _ in range(5))[2]
    log(f"lm {cfg.name} {scheme}: {s['served']}/{len(prompts)} served, {s['tokens']} tokens in "
        f"{s['steps']} steps, wall {wall * 1e3:.1f} ms ({1e3 * wall / max(1, s['steps']):.2f} ms "
        f"a step with its host work, the replay {replay_ms:.3f} ms by CUDA events, "
        f"{s['tokens'] / wall:.1f} tokens/s); warm-up {capture_ms:.0f} ms ({captured} "
        f"capture, {exe.nodes} graph nodes), {watch.delta()} captures while serving; kernel "
        f"launches in the graph (a step) {per_step}; wrapper launches of the run {launches} "
        f"(warm-up and capture; replays run no wrapper), replayed "
        f"{ {k: v for k, v in core.replayed_launches.items() if v} }; plain {plain}")
    if s["served"] != len(prompts) or not all(r.ok for r in results):
        fail(f"lm {cfg.name} {scheme}: served {s['served']} of {len(prompts)}")
    if captured != 1 or watch.delta() or core.compile_count != 1:
        fail(f"lm {cfg.name} {scheme}: {captured} captures at warm-up, {watch.delta()} after")
    if per_step != want:
        fail(f"lm {cfg.name} {scheme}: captured step launches {per_step}, want {want}")
    if any(plain.values()) or routed["attention.ref"] or routed["quantize.ref"]:
        fail(f"lm {cfg.name} {scheme}: a plain version ran: {plain} {routed}")
    if launches[flash] == 0 or (quant and launches["aaq_quantize"] == 0):
        fail(f"lm {cfg.name} {scheme}: a kernel of the path never launched: {launches}")
    return client, results, dict(wall_s=wall, steps=s["steps"], tokens=s["tokens"],
                                 step_ms=1e3 * wall / max(1, s["steps"]), replay_ms=replay_ms,
                                 tokens_per_s=s["tokens"] / wall,
                                 kv_bytes=core.admission.bytes_per_request)


def _lm_profile(torch, client) -> None:
    """Where a decode step's time goes: 5 replays of the step's graph under
    torch.profiler, the device-busy share of their wall time and the
    kernels that take the most device time.  Not gated: it reads "not
    measured" when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    (exe,) = client.core._executables.values()
    zeros = torch.zeros((4,), dtype=torch.int32, device="cuda")
    exe.launch(zeros, zeros)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            exe.launch(zeros, zeros)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    what = f"lm {client.core.cfg.name} {client.core.scheme.name} profile of 5 replays"
    if not kernels:
        log(f"{what}: wall {wall:.2f} ms; the profiler recorded no device time (not measured)")
        return
    busy = sum(us for _, us, _ in kernels) / 1e3
    log(f"{what}: wall {wall:.2f} ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%), "
        f"{sum(c for _, _, c in kernels) / 5:.0f} device kernels a step; by device time a step: "
        + "; ".join(f"{us / 5e3:.3f} ms {n // 5}x {name[:60]}"
                    for name, us, n in sorted(kernels, key=lambda k: -k[1])[:6]))


def _lm_graph_vs_eager(torch, client) -> None:
    """One step replayed by the graph against the same step run eagerly,
    from the same KV ring: logits and the ring after it bitwise."""
    core = client.core
    (exe,) = core._executables.values()
    tokens = torch.tensor([5, 17, 0, 900], dtype=torch.int32, device="cuda") % core.cfg.vocab
    positions = torch.tensor([3, 40, 0, 255], dtype=torch.int32, device="cuda")
    before = {k: v.clone() for k, v in core.cache.items()}
    eager = exe._forward(tokens, positions)["logits"].clone()
    ring_eager = {k: v.clone() for k, v in core.cache.items()}
    for k, v in core.cache.items():
        v.copy_(before[k])
    graph = exe.launch(tokens, positions)["logits"]
    torch.cuda.synchronize()
    same = _bitwise(torch, graph, eager) and all(
        torch.equal(core.cache[k], ring_eager[k]) for k in core.cache)
    log(f"lm {core.cfg.name} {core.scheme.name}: graph replay vs the eager step, logits and KV "
        f"ring bitwise equal: {same}")
    if not same:
        fail(f"lm {core.cfg.name} {core.scheme.name}: graph replay differs from the eager step")


def _lm_kv_rows(torch, client, prompts, results) -> None:
    """Layer 0's ring after the trace: each slot's rows are the K/V rows of
    the tokens its last occupant fed, recomputed here at the step's shape
    (4 slots); raw rows bitwise, quantized rows dequantized within half a
    quantization step (their f32 scale / 2) of the row they came from.
    Row 0 is left out: a slot that went idle fed token 0 at position 0 in
    every later step, as the reference's idle slots do."""
    import numpy as np
    from repro_torch.core.qtensor import unpack_int4
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf
    from repro_torch.serving.lm import _kv_policy
    core = client.core
    cfg, params, cache = core.cfg, core.params, core.cache
    last = {}
    for r in results:                         # the last occupant of each slot
        if r.slot not in last or r.request_id > last[r.slot].request_id:
            last[r.slot] = r
    fed = {slot: np.concatenate([prompts[r.request_id], r.tokens[:-1]])
           for slot, r in last.items()}
    pol = _kv_policy(core.scheme)
    p0 = params["blocks"][0]
    worst, rows = 0.0, 0
    for j in range(1, max(len(f) for f in fed.values())):
        tok = [int(fed[i][j]) if i in fed and j < len(fed[i]) else 0 for i in range(4)]
        x = cm.embed(params["embed"], torch.tensor(tok, device="cuda").long()[:, None])
        pos = torch.full((4, 1), j, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            _, k, v = tf.qkv(p0["attn"], tf.apply_norm(p0["attn_norm"], x, cfg), cfg, pos)
        for i in range(4):
            if i not in fed or j >= len(fed[i]):
                continue
            for name, src in (("k", k), ("v", v)):
                want = src[i, 0]                                      # (Hkv, hd)
                if pol is None:
                    if not _bitwise(torch, cache[name][0, i, j % 256], want):
                        fail(f"lm KV ring: raw {name} row of slot {i} at {j} differs")
                    continue
                q = unpack_int4(cache[f"{name}_inliers"][0, i, j % 256]).float()
                sc = cache[f"{name}_scales"][0, i, j % 256]
                err = ((q * sc - want.float()).abs() / sc).max()
                worst = max(worst, float(err))
                rows += 1
    log(f"lm {cfg.name} {core.scheme.name}: layer 0's KV ring after the trace, "
        + ("raw rows bitwise the recomputed K/V rows" if pol is None else
           f"{rows} dequantized rows within {worst:.4f} of a quantization step of the rows "
           f"they came from (gate 0.5)"))
    if pol is not None and worst > 0.5 + 1e-5:
        fail(f"lm KV ring: a dequantized row is {worst:.4f} steps from its source")


#: phase 8's limits on the served decode against the plain path on the card,
#: set from the readings on the H100 80GB HBM3 at 700 W (PERF.md, section 6):
#: max |logits_first(kernels) - logits_first(kernels="ref")| read 0.049 under
#: fp16 and 0.218 / 0.322 under AAQ (qwen1.5-0.5b / qwen2.5-3b: one INT4 step
#: flips where the K/V row moved by one bf16 ulp); the AAQ limit stays under
#: the 0.91 that the AAQ-vs-fp16 drift reads, so a ring that skipped
#: quantization on one side fails it.  Prefill vs the served first logits
#: read 0.049, unembed vs the widened product 4.8e-6 / 1.0e-5.
LM_PLAIN_FIRST_TOL = {"baseline_fp16": 0.2, "lightnobel_aaq": 0.5}
LM_PREFILL_TOL = 0.2
LM_UNEMBED_TOL = 1e-4


def _lm_vs_plain(torch, client, prompts, results) -> dict:
    """The served decode against plain paths on the card, same weights:
    an ``LMClient`` with ``kernels="ref"`` (plain attention and
    ``quantize_ref``, every other op the same) on the same prompts; under
    fp16 also each prompt's full-sequence prefill under the plain backend
    (causal attention over the prompt: no ring, no per-slot positions,
    no ``index_put_``) against the served first logits; and ``unembed``
    (``torch.mm`` with a float32 output) against the product of the
    operands widened to float32.  Token streams are compared, not gated
    whole: flash rounds its probabilities to bf16 for the tensor cores,
    the plain path keeps them in float32, and a one-ulp difference carried
    through every layer flips near-tied greedy picks.  Where the first
    logits' top-2 gap exceeds twice the measured difference the first
    token cannot flip, and must be equal.  Launches here are comparisons:
    the counted run is over."""
    import numpy as np
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    from repro_torch.serving import LMClient
    core = client.core
    cfg, params, scheme = core.cfg, core.params, core.scheme.name
    ref = LMClient(params, cfg, scheme, window=core.window, max_slots=core.max_slots,
                   default_max_new_tokens=client.default_max_new_tokens,
                   kernels=dispatch.REF, device="cuda")
    try:
        ref_res = ref.run(prompts)
    finally:
        ref.close()
    diffs = [float(np.max(np.abs(a.logits_first - b.logits_first)))
             for a, b in zip(results, ref_res)]
    gaps = [float(np.diff(np.sort(b.logits_first)[-2:])[0]) for b in ref_res]
    same = sum(int(np.array_equal(a.tokens, b.tokens)) for a, b in zip(results, ref_res))
    sure = [i for i, (d, g) in enumerate(zip(diffs, gaps)) if g > 2 * d]
    flipped = [i for i in sure if results[i].tokens[0] != ref_res[i].tokens[0]]
    out = dict(first=max(diffs), streams=same, sure=len(sure), flipped=flipped)
    with torch.inference_mode(), dispatch.use_backend(dispatch.REF):
        if scheme == "baseline_fp16":
            pre = [lm.prefill_fn(params, {"tokens": torch.tensor(pr[None], device="cuda").long()},
                                 cfg)[0, 0].cpu().numpy() for pr in prompts]
            out["prefill"] = max(float(np.max(np.abs(a - r.logits_first)))
                                 for a, r in zip(pre, results))
            out["prefill_plain"] = max(float(np.max(np.abs(a - r.logits_first)))
                                       for a, r in zip(pre, ref_res))
        g = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((4, 1, cfg.d_model), generator=g, device="cuda").to(cfg.torch_dtype)
        e = (params["embed"]["e"] if cfg.tie_embeddings else params["lm_head"]["w"].t())
        want = x.float() @ e.float().t()
        out["unembed"] = float((tf.unembed(params, x, cfg) - want).abs().max())
    tol = LM_PLAIN_FIRST_TOL[scheme]
    log(f"lm {cfg.name} {scheme}: served (kernels) vs the plain path on the card (kernels=ref, "
        f"same weights and prompts): max |logits_first| difference {out['first']:.4e} (limit "
        f"{tol}); identical token streams {same}/{len(prompts)}; first token equal in the "
        f"{len(sure)} requests whose top-2 gap exceeds twice their difference: "
        f"{not flipped} (gaps {[f'{v:.3e}' for v in gaps]})"
        + (f"; full-sequence prefill (plain) vs served logits_first {out['prefill']:.4e}, vs "
           f"the plain path's {out['prefill_plain']:.4e} (limit {LM_PREFILL_TOL})"
           if "prefill" in out else "")
        + f"; unembed vs the widened float32 product {out['unembed']:.4e} "
        f"(limit {LM_UNEMBED_TOL})")
    if not (out["first"] <= tol and out["unembed"] <= LM_UNEMBED_TOL) or flipped:
        fail(f"lm {cfg.name} {scheme}: the served step departs from the plain path: {out}")
    if "prefill" in out and not max(out["prefill"], out["prefill_plain"]) <= LM_PREFILL_TOL:
        fail(f"lm {cfg.name} {scheme}: prefill departs from the served first logits: {out}")
    return out


def serve_lm(torch, lm_pending) -> dict:
    """Phase 8 (see the module docstring).  Returns the launches by variant
    of its counted runs and fills the launches of the LM kernel rows."""
    import gc
    import numpy as np
    from repro_torch.serving.lm import KV_SITE
    cfg, params = _lm_model(torch, "qwen1.5-0.5b")
    prompts = _lm_prompts(cfg.vocab, 6)
    tally = Counter()
    total = Counter()
    runs = {}
    for scheme in ("baseline_fp16", "lightnobel_aaq"):
        client, results, reading = _lm_serve(torch, cfg, params, scheme, prompts, 16, tally)
        total.update(_counts()[0])
        bits = client.core.scheme.act_bits(KV_SITE, cfg.hd)
        formula = math.ceil(cfg.layers * 2 * 256 * cfg.n_kv_heads * cfg.hd * bits / 8)
        if reading["kv_bytes"] != formula or any(r.kv_bytes != formula for r in results):
            fail(f"lm {scheme}: KV bytes {reading['kv_bytes']} != {formula}")
        _lm_kv_rows(torch, client, prompts, results)
        _lm_graph_vs_eager(torch, client)
        _lm_profile(torch, client)
        _lm_vs_plain(torch, client, prompts, results)
        # one request alone against the same request in the batch
        k = 3
        solo = client.run([prompts[k]])[0]
        same = (np.array_equal(solo.tokens, results[k].tokens)
                and solo.logits_first.tobytes() == results[k].logits_first.tobytes())
        log(f"lm {scheme}: request {k} alone vs in the batch of 4 slots: token stream and "
            f"first logits bitwise equal: {same}")
        if not same or client.core.compile_count != 1:
            fail(f"lm {scheme}: request {k} alone differs from its batched run")
        runs[scheme] = (results, reading)
        client.close()
    fp_res, fp = runs["baseline_fp16"]
    aq_res, aq = runs["lightnobel_aaq"]
    drift = max(float(np.max(np.abs(a.logits_first - f.logits_first)))
                for a, f in zip(aq_res, fp_res))
    agree = sum(int(np.array_equal(a.tokens, f.tokens)) for a, f in zip(aq_res, fp_res))
    log(f"lm {cfg.name}: KV bytes a request fp16 {fp['kv_bytes']} / aaq {aq['kv_bytes']} = "
        f"{fp['kv_bytes'] / aq['kv_bytes']:.3f}x; step {fp['step_ms']:.2f} / {aq['step_ms']:.2f} ms "
        f"(host clock, a step of 4 slots with its host work), replay {fp['replay_ms']:.3f} / "
        f"{aq['replay_ms']:.3f} ms (CUDA events); {fp['tokens_per_s']:.1f} / "
        f"{aq['tokens_per_s']:.1f} decoded tokens/s; max |logits_first(aaq) - "
        f"logits_first(fp16)| = {drift:.4e} (not gated: random full-width bf16 weights), "
        f"identical token streams {agree}/{len(prompts)}; on {torch.cuda.get_device_name(0)}")
    if not math.isfinite(drift):
        fail(f"lm: logits drift {drift}")
    http_fleet_lm(torch, cfg, params, prompts[:4], {r.request_id: r for r in aq_res})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # GQA at head dim 128 on the tensor-core flash: qwen2.5-3b, 2 prompts
    cfg3, params3 = _lm_model(torch, "qwen2.5-3b")
    prompts3 = _lm_prompts(cfg3.vocab, 2)
    client, res3, r3 = _lm_serve(torch, cfg3, params3, "lightnobel_aaq", prompts3, 8, tally)
    total.update(_counts()[0])
    _lm_vs_plain(torch, client, prompts3, res3)
    log(f"lm {cfg3.name} lightnobel_aaq: {r3['step_ms']:.2f} ms a step (replay "
        f"{r3['replay_ms']:.3f} ms), "
        f"{r3['tokens_per_s']:.1f} tokens/s, KV bytes a request {r3['kv_bytes']}")
    client.close()
    del params3, client
    gc.collect()
    torch.cuda.empty_cache()
    for row, key in lm_pending:
        row.launches = tally.get(key, 0)
    return dict(total)


def http_fleet_lm(torch, cfg, params, prompts, inproc) -> None:
    """``/v1/generate`` over HTTP to 2 LM replicas on 127.0.0.1:0: SSE token
    events in order for each request, the wire tokens bitwise the in-process
    client's, ``/metrics/replica/<i>`` carrying ``workload="lm"`` series."""
    import urllib.request
    from repro_torch.serving import FleetRouter, FoldHTTPServer, LMClient, check_request_order
    from repro_torch.serving import events as ev
    from repro_torch.serving.transport import protocol
    from repro_torch.serving.transport.server import request_json

    def factory(i):
        c = LMClient(params, cfg, "lightnobel_aaq", window=256, max_slots=4,
                     default_max_new_tokens=16, device="cuda")
        c.warmup()
        return c

    router = FleetRouter(factory, 2)
    server = FoldHTTPServer(router, port=0, host="127.0.0.1").start()
    url = server.url
    try:
        def post(p):
            return request_json(f"{url}/v1/generate", method="POST",
                                body={"prompt": p.tolist()})["id"]

        def follow(rid):
            with urllib.request.urlopen(f"{url}/v1/generate/{rid}/events", timeout=600) as resp:
                return protocol.parse_sse(resp.read())

        t0 = time.perf_counter()
        rids = _gather(post, prompts)
        streams = _gather(follow, rids)
        wall = (time.perf_counter() - t0) * 1e3
        for k, (rid, events) in enumerate(zip(rids, streams)):
            check_request_order(events)
            toks = [e for e in events if e.kind == ev.TOKEN]
            st = request_json(f"{url}/v1/generate/{rid}")
            wire = st["result"]["tokens"]
            if (events[-1].kind != ev.COMPLETED or [t.data["step"] for t in toks] != list(range(16))
                    or [t.data["token"] for t in toks] != wire
                    or wire != [int(t) for t in inproc[k].tokens]):
                fail(f"lm http: request {rid} tokens {wire} not the in-process client's "
                     f"{inproc[k].tokens.tolist()} or its events out of order")
        texts = [urllib.request.urlopen(f"{url}/metrics/replica/{i}").read().decode()
                 for i in range(2)]
        fleet = request_json(f"{url}/v1/fleet")
        labelled = [sum(1 for ln in t.splitlines() if ln.startswith("lm_") and 'workload="lm"' in ln)
                    for t in texts]
        served = [_metric_total(t, "lm_requests_total") for t in texts]
        if fleet["workloads"] != ["lm", "lm"] or min(labelled) == 0 or sum(served) != len(prompts):
            fail(f"lm http: fleet {fleet}, workload-labelled series {labelled}, served {served}")
        log(f"lm http: {len(prompts)} /v1/generate requests to 2 replicas in {wall:.1f} ms, "
            f"SSE token events in order, wire tokens bitwise the in-process client's; "
            f"replicas served {served}; workload=\"lm\" series {labelled}")
    finally:
        server.stop()
        router.stop()
        for r in router.replicas:
            r.client.close()


# ---------------------------------------------------------------------------
# phase 3 (zoo shapes) and phase 9: the rest of the model zoo
# ---------------------------------------------------------------------------
def _zoo_key(q, k) -> tuple:
    """A flash launch's tally key in phase 9: (Sq, Hq, D, Skv, Hkv)."""
    return (q.shape[1], q.shape[2], q.shape[3], k.shape[1], k.shape[2])


def _valid_pairs(b, sq, skv, causal, window, kvlen) -> int:
    """(query, key) pairs that these masks leave, over the batch."""
    qpos = range(sq)
    if kvlen is not None:
        return int(sum(int(n) for n in kvlen.tolist())) * sq
    total = 0
    for qp in qpos:
        hi = min(skv, qp + 1) if causal else skv
        lo = max(0, qp - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return b * total


# (label, arch, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, kv_valid_len)
ZOO_FLASH = (
    ("phi-3 prefill", "phi-3-vision-4.2b", 2, 512, 512, 32, 32, 96, 96, True, None, None),
    ("recurrentgemma prefill", "recurrentgemma-9b", 2, 2560, 2560, 16, 1, 256, 256, True,
     2048, None),
    ("recurrentgemma decode", "recurrentgemma-9b", 4, 1, 2048, 16, 1, 256, 256, False, None,
     [1, 700, 1401, 2048]),
    ("MLA prefill", "deepseek-v2-lite-16b", 2, 512, 512, 16, 16, 192, 128, True, None, None),
    ("whisper encoder self", "whisper-base", 2, 1500, 1500, 8, 8, 64, 64, False, None, None),
    ("whisper cross", "whisper-base", 2, 64, 1500, 8, 8, 64, 64, False, None, None),
    ("mixtral prefill", "mixtral-8x22b", 1, 4608, 4608, 48, 8, 128, 128, True, 4096, None),
    ("whisper decoder self prefill", "whisper-base", 2, 64, 64, 8, 8, 64, 64, True, None, None),
    # the other decode steps phase 9 runs, against its 16-row rings and the
    # 1,500 encoder frames
    ("MLA decode", "deepseek-v2-lite-16b", 2, 1, 16, 16, 16, 192, 128, False, None, [16, 9]),
    ("phi-3 decode", "phi-3-vision-4.2b", 2, 1, 16, 32, 32, 96, 96, False, None, [16, 7]),
    ("whisper self decode", "whisper-base", 2, 1, 16, 8, 8, 64, 64, False, None, [16, 3]),
    ("whisper cross decode", "whisper-base", 2, 1, 1500, 8, 8, 64, 64, False, None, None),
    ("mixtral decode", "mixtral-8x22b", 2, 1, 16, 48, 8, 128, 128, False, None, [16, 5]),
)
#: float32 on the float32 kernels at the zoo's head dims 96, 192 and 256:
#: phi-3 at phase 12(c)'s shapes (its float32 prefill of 32 tokens and a
#: decode step against its 256-row ring at position 100, 4 rows), MLA and
#: recurrentgemma at phase 9's; then head dim 48 (which the bf16 kernels
#: would pad to 64) and 320 (above 256: QK^T over all of it, the output in
#: two panels of 160)
ZOO_FLASH_F32 = (
    ("phi-3 prefill f32", "phi-3-vision-4.2b", 4, 32, 32, 32, 32, 96, 96, True, None, None),
    ("phi-3 decode f32", "phi-3-vision-4.2b", 4, 1, 256, 32, 32, 96, 96, False, None,
     [101, 101, 101, 101]),
    ("MLA prefill f32", "deepseek-v2-lite-16b", 2, 512, 512, 16, 16, 192, 128, True, None,
     None),
    ("MLA decode f32", "deepseek-v2-lite-16b", 2, 1, 16, 16, 16, 192, 128, False, None, [16, 9]),
    ("recurrentgemma prefill f32", "recurrentgemma-9b", 2, 2560, 2560, 16, 1, 256, 256, True,
     2048, None),
    ("recurrentgemma decode f32", "recurrentgemma-9b", 4, 1, 2048, 16, 1, 256, 256, False,
     None, [1, 700, 1401, 2048]),
    ("D 48 f32", "a head dim the bf16 kernels pad", 2, 64, 64, 8, 8, 48, 48, True, None,
     None),
    ("D 320 f32", "a head dim above 256", 2, 512, 512, 8, 8, 320, 320, True, None, None),
    ("D 320 f32 decode", "a head dim above 256", 4, 1, 512, 8, 2, 320, 320, False, None,
     [512, 300, 77, 1]),
)
#: bf16 above head dim 256: widened to float32 on the float32 kernel, the
#: output rounded once to bf16
ZOO_FLASH_WIDE = (
    ("D 320 bf16", "a head dim above 256", 2, 512, 512, 8, 8, 320, 320, True, None, None),
)


def _f32_key(q, k) -> tuple:
    """A float32 flash launch's tally key in phase 12(c): (prefill or
    decode, Hq, D, Hkv), at any length."""
    return ("f32", "decode" if q.shape[1] == 1 else "prefill", q.shape[2], q.shape[3],
            k.shape[2])


def check_zoo_flash(torch, rows: dict) -> list:
    """Flash at the model zoo's shapes (phase 9's): head dims 96, 192 (MLA:
    v at 128, padded with zeros to 192 as ``dispatch.attention`` does, the
    output sliced back) and 256 (MQA, window 2,048, and its decode against a
    2,048-row ring), the whisper encoder's 1,500 frames and the cross
    attention onto them, mixtral's GQA 48/8 with a 4,096 window, and every
    other decode step phase 9 runs.  Each held to ``flash_mha_plain`` (on
    the unpadded v) and timed: ``bound_ms`` counts the pairs the masks leave
    and v and o at their own head dim; ``library_ms`` is SDPA (KV heads
    repeated, the window or key lengths as a boolean mask).  A shape the
    rule sends to the decode or prefill kernel also gets two launches and a
    batch row launched alone bitwise, and the tensor-core kernel's time on
    the same operands (``tc_ms``).  Then ``ZOO_FLASH_F32``: the same
    checks in float32 on the float32 kernels (their bound at the CUDA
    cores' float32 rate), head dims 48 and 320 among them, and
    ``ZOO_FLASH_WIDE``, bf16 above 256.  Returns (row, tally key)
    pairs: phase 9's keys for the bf16 rows, phase 12(c)'s (``_f32_key``)
    for the float32 ones."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (_flash_launch_args,
                                                                     flash_mha_kernel,
                                                                     flash_mha_plain)
    g = torch.Generator(device="cuda").manual_seed(17)
    bf, f32 = torch.bfloat16, torch.float32
    pending = []
    for (label, arch, b, sq, skv, hq, hkv, d, dv, causal, window, kvlen), dt in (
            [(c, bf) for c in ZOO_FLASH] + [(c, f32) for c in ZOO_FLASH_F32]
            + [(c, bf) for c in ZOO_FLASH_WIDE]):
        q = torch.randn((b, sq, hq, d), generator=g, device="cuda").to(dt)
        k = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dt)
        v = torch.randn((b, skv, hkv, dv), generator=g, device="cuda").to(dt)
        kvl = None if kvlen is None else torch.tensor(kvlen, dtype=torch.int32, device="cuda")
        vp = F.pad(v, (0, d - dv)) if dv < d else v
        scale = 1.0 / math.sqrt(d)
        kw = dict(causal=causal, window=window, softmax_scale=scale)

        def kern(q=q, k=k, vp=vp, kvl=kvl, kw=kw):
            return flash_mha_kernel(q, k, vp, None, kvl, **kw)

        def plain(q=q, k=k, v=v, kvl=kvl, kw=kw):
            return flash_mha_plain(q, k, v, None, kvl, **kw)

        full = kern()
        o = full[..., :dv]
        err = _flash_close(torch, o, plain(), v, f"{label} ({arch})")
        name = _flash_name(q, k, None, vp, **kw)
        if name != "flash_mha":
            _flash_bitwise(torch, (q, k, vp, None, kvl), full, label, **kw)
        del full
        launched = _flash_launch_args(q, k, vp, None, kvl, **kw).sizes[5]
        pad = f", the head dim padded to {launched}" if launched != d else ""
        shape = (f"{label} ({arch}): q ({b}, {sq}, {hq}, {d}), k ({b}, {skv}, {hkv}, {d}), "
                 f"v ({b}, {skv}, {hkv}, {dv}{', padded to ' + str(d) if dv < d else ''})"
                 f" {'bf16' if dt == bf else 'f32'}{pad}"
                 f"{', causal' if causal else ''}{f', window {window}' if window else ''}"
                 f"{f', kv_valid_len {kvlen}' if kvlen else ''}")
        row = _row(name, shape)
        row.max_abs_err = err
        row.ms, row.call_ms = time_ms(torch, kern), call_ms(torch, kern)
        if name not in ("flash_mha", *F32_FLASH):
            row.tc_ms = _tc_ms(torch, (q, k, vp, None, kvl), **kw)
        row.plain_ms = time_ms(torch, plain, iters=3)
        qt = q.transpose(1, 2)
        kt, vt = (a.repeat_interleave(hq // hkv, dim=2).transpose(1, 2) for a in (k, v))
        mask = None
        if kvl is not None:
            mask = (torch.arange(skv, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
        elif window is not None:
            qp = torch.arange(sq, device="cuda")[:, None]
            kp = torch.arange(skv, device="cuda")[None, :]
            mask = (kp <= qp) & (kp > qp - window)
        row.library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=scale))
        del kt, vt, mask
        # each input read once (at a decode row, only the K/V rows the key
        # lengths keep), the output written once, v and o at their own width
        kv_bytes = (k.element_size() * hkv * (d + dv) * sum(kvlen) if kvlen
                    else nbytes(k, v))
        pairs = _valid_pairs(b, sq, skv, causal, window, kvl)
        row.bound_ms, row.bound_by = bound_ms(nbytes(q, o, kvl) + kv_bytes,
                                              2 * pairs * hq * (d + dv), f32=dt == f32)
        pending.append((row, _zoo_key(q, k) if dt == bf else _f32_key(q, k)))
        log(row.line())
    log(f"flash zoo shapes: allclose on {len(ZOO_FLASH)} cases (D = 64/96/128/192/256, "
        f"MLA v padded 128 -> 192, MQA 16/1 and GQA 48/8, windows 2,048 and 4,096, decode "
        f"rows against a 2,048-row ring, 16-row rings and 1,500 frames, cross attention onto "
        f"1,500 frames); on the decode and prefill kernels two launches and a row alone "
        f"bitwise: {[r.shape.split(' (')[0] for r, _ in pending if r.tc_ms is not None]}; "
        f"float32 on flash_mha_f32 and flash_mha_f32_dec at D = 48/96/192/256/320 and bf16 "
        f"at D = 320 widened ({len(ZOO_FLASH_F32) + len(ZOO_FLASH_WIDE)} cases, the same "
        f"checks)")
    return pending


# phase 9: (arch, layers on the card (None: all), batch, prompt tokens);
# phi-3's 512 positions are 256 image embeddings and 256 tokens, whisper's
# decoder prompt is 64 tokens against its 1,500 encoder frames
ZOO_MODELS = (
    ("deepseek-v2-lite-16b", None, 2, 512),
    ("recurrentgemma-9b", None, 2, 2560),
    ("mamba2-780m", None, 2, 512),
    ("whisper-base", None, 2, 64),
    ("phi-3-vision-4.2b", None, 2, 256),
    ("mixtral-8x22b", 2, 1, 4608),
)
ZOO_DECODE_TOKENS = 16
#: limits of phase 9 on max |last-position logits|, set from readings
#: (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W): the kernel route against
#: the plain route on the same weights (bf16 roundings apart; mamba2 has no
#: attention, so its two routes are the same code), and 16 decode steps
#: against a prefill of the same 16 tokens (other products, other bf16
#: roundings).  Each lies between the model's reading and its control's,
#: a fault the gate must catch (``_zoo_fault``; the controls are gated
#: above the limits too).  Readings / controls: prefill deepseek 0.930 /
#: 2.447 (router flips: 7,813 of its 26 x 1,024 top-6 choices differ between
#: the routes; ``ZOO_FORCED_TOL`` holds the rest), recurrentgemma 0.157 / 0.545, whisper 0.0150 / 0.357, phi-3
#: 0.103 / 5.85, mixtral 0.0300 / 3.37; decode 0.245 / 3.06, 0.227 / 3.39,
#: mamba2 0.195 / 4.74, 0.0140 / 0.233, 0.0913 / 2.43, 0.0327 / 2.13.
ZOO_PREFILL_TOL = {"deepseek-v2-lite-16b": 1.5, "recurrentgemma-9b": 0.3,
                   "mamba2-780m": 0.0, "whisper-base": 0.07, "phi-3-vision-4.2b": 0.5,
                   "mixtral-8x22b": 0.3}
ZOO_DECODE_TOL = {"deepseek-v2-lite-16b": 0.8, "recurrentgemma-9b": 0.8,
                  "mamba2-780m": 0.6, "whisper-base": 0.06, "phi-3-vision-4.2b": 0.45,
                  "mixtral-8x22b": 0.25}
#: the flash fault of each model's prefill control: the argument it gets wrong
ZOO_PREFILL_FAULT = {"deepseek-v2-lite-16b": "softmax scale 1/sqrt(v's 128), not 1/sqrt(192)",
                     "recurrentgemma-9b": "window dropped", "mixtral-8x22b": "window dropped",
                     "whisper-base": "causal dropped", "phi-3-vision-4.2b": "causal dropped"}
ZOO_DECODE_FAULT = "the newest ring row dropped from kv_valid_len"
#: MoE prefill: limit on max |last-position logits| between the kernel
#: route with its routing forced to the plain route's top-k choices
#: (``_routing``) and the plain route, so that a router flip, which moves
#: a token's whole expert share, is told apart from the attention's bf16
#: roundings; the prefill control is run forced too and gated above it.
#: Readings / controls (NVIDIA H100 80GB HBM3, 700 W): deepseek 0.0868 /
#: 2.04, mixtral 0.0305 / 1.67 (49 of its 2 x 4,608 top-2 choices flip).
ZOO_FORCED_TOL = {"deepseek-v2-lite-16b": 0.3, "mixtral-8x22b": 0.15}
ZOO_SSM_DECODE_FAULT = "the conv state not carried between steps"


@contextlib.contextmanager
def _zoo_fault(torch, arch: str, step: str):
    """Flash with one argument wrong, for a control run: in a prefill the
    model's ``ZOO_PREFILL_FAULT``, in a decode step the newest ring row
    dropped from ``kv_valid_len``; mamba2's decode (no attention) with its
    conv state dropped at every step."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import ssm
    fl, conv = dispatch.flash_mha_kernel, ssm._causal_conv
    if arch == "mamba2-780m":
        with swapped(ssm, "_causal_conv", lambda xbc, w, b, state=None: conv(xbc, w, b)):
            yield
        return

    def faulty(q, k, v, bias=None, kvl=None, **kw):
        fault = ZOO_PREFILL_FAULT[arch]
        if step == "decode":
            if kvl is not None:          # the self-attention ring, not the cross
                kvl = torch.clamp(kvl - 1, min=1)
        elif fault.startswith("softmax"):
            kw["softmax_scale"] = kw["softmax_scale"] * math.sqrt(192 / 128)
        elif fault == "window dropped":
            kw["window"] = None
        elif fault == "causal dropped":
            kw["causal"] = False
        return fl(q, k, v, bias, kvl, **kw)

    with swapped(dispatch, "flash_mha_kernel", faulty):
        yield


@contextlib.contextmanager
def _routing(torch, force=None):
    """Record each MoE layer's top-k choices (expert indices, in call
    order) into the list yielded; with ``force`` (such a list from another
    run) each layer takes those choices instead, at this run's gate values."""
    from repro_torch.models import moe
    top_k, seen = moe._top_k, []

    def routed(gates, k):
        if force is None:
            v, i = top_k(gates, k)
        else:
            i = force[len(seen)]
            v = torch.gather(gates, -1, i)
        seen.append(i)
        return v, i

    with swapped(moe, "_top_k", routed):
        yield seen


def _zoo_routes(torch, arch, params, batch, cfg, ref, ref_route) -> dict:
    """An MoE prefill's routing on the kernel route against the plain
    route's (``ref_route``, which gave ``ref``): the tokens a layer whose
    set of top-k experts differs, and max |logits - ref| with the kernel
    route's routing forced to the plain route's, for the model and for its
    prefill control."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    with dispatch.use_backend("kernel"):
        with _routing(torch) as kern_route:
            lm.prefill_fn(params, batch, cfg)
        with _routing(torch, force=ref_route):
            forced = lm.prefill_fn(params, batch, cfg)
        with _zoo_fault(torch, arch, "prefill"), _routing(torch, force=ref_route):
            c_forced = lm.prefill_fn(params, batch, cfg)
    flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
             for a, b in zip(kern_route, ref_route)]
    return dict(tokens=ref_route[0][..., 0].numel(), flips=flips,
                forced=float((forced - ref).abs().max()),
                control_forced=float((c_forced - ref).abs().max()))


def _zoo_attn_calls(cfg, step: str) -> int:
    """Attention calls a prefill or a decode step of ``cfg`` makes."""
    if cfg.kind == "ssm":
        return 0
    if cfg.kind == "hybrid":
        return cfg.layers // cfg.hybrid.attn_every
    if cfg.kind == "encdec":     # encoder self (prefill only), decoder self, cross
        return (cfg.enc_layers if step == "prefill" else 0) + 2 * cfg.layers
    return cfg.layers


def _act_calls(cfg) -> int:
    """``AAQConfig.act`` calls a forward of ``cfg`` makes: 2 residual sites a
    layer, then 2 K/V (or MLA latent) sites an attention layer, 1 state
    site an SSD or RG-LRU layer; the enc-dec's self-attention K/V only."""
    if cfg.kind == "ssm":
        return 2 * cfg.layers
    if cfg.kind == "hybrid":
        return 2 * cfg.layers + 2 * (cfg.layers // cfg.hybrid.attn_every)
    if cfg.kind == "encdec":
        return 2 * (cfg.enc_layers + cfg.layers)
    return 4 * cfg.layers


@contextlib.contextmanager
def _fq_tally(torch, tally):
    """Count ``aaq_fake_quant`` calls by (T, H, dtype, bits, k) into ``tally``."""
    from repro_torch.kernels.aaq_quant import ops
    fk = ops.aaq_fake_quant_kernel

    def counted(x, bits, k_outliers):
        tally[(*x.shape, str(x.dtype).removeprefix("torch."), bits, k_outliers)] += 1
        return fk(x, bits, k_outliers)

    with swapped(ops, "aaq_fake_quant_kernel", counted):
        yield


def _zoo_aaq_prefill(torch, arch, params, batch, cfg, fq_tally):
    """The ``AAQConfig()`` prefill on the kernel route: ``aaq_fake_quant``
    launched once an act call, no plain fake-quant, and logits bitwise those
    of the same prefill with only the act sites on the plain version
    (``backend="ref"`` on those calls; attention stays on the kernel)."""
    from repro_torch.core.policy import AAQConfig
    from repro_torch.kernels import dispatch
    from repro_torch.models import lm
    fq = dispatch.fake_quant
    with dispatch.use_backend("kernel"):
        dispatch.reset_counters()
        with _fq_tally(torch, fq_tally):
            aaq = lm.prefill_fn(params, batch, cfg, AAQConfig())
            torch.cuda.synchronize()
        launches, plain, routed = _counts()
        with swapped(dispatch, "fake_quant", lambda x, *, bits, k_outliers, backend=None:
                     fq(x, bits=bits, k_outliers=k_outliers, backend="ref")):
            acts_plain = lm.prefill_fn(params, batch, cfg, AAQConfig())
    want = _act_calls(cfg)
    if (launches["aaq_fake_quant"] != want or plain["aaq_fake_quant"]
            or routed["fakequant.ref"] or routed["fakequant.ref_grad"]):
        fail(f"zoo {arch}: the AAQ prefill launched aaq_fake_quant {launches['aaq_fake_quant']} "
             f"times (want {want}, one an act call), plain {plain}, routed {routed}")
    if not _bitwise(torch, aaq, acts_plain):
        fail(f"zoo {arch}: AAQ prefill logits with the kernel's fake-quant differ from those "
             f"with the plain fake-quant by {float((aaq - acts_plain).abs().max())}")
    log(f"zoo {arch}: AAQConfig() prefill: aaq_fake_quant launched {want} times (one an act "
        f"call), no plain fake-quant; logits bitwise equal with the act sites on the plain "
        f"version")
    return aaq


def _zoo_batch(torch, cfg, b, s, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int64))
             .cuda()}
    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.kind == "vlm":
        batch["image_embeds"] = torch.randn((b, cfg.n_image_tokens, cfg.d_model), generator=g,
                                            device="cuda").to(cfg.torch_dtype)
    if cfg.kind == "encdec":
        batch["audio_frames"] = torch.randn((b, cfg.n_audio_frames, cfg.d_model), generator=g,
                                            device="cuda").to(cfg.torch_dtype)
    return batch


def _zoo_counted(torch, fn, tally):
    """Run ``fn`` with every counter zeroed just before and read just after;
    flash launches also tallied by (Sq, Hq, D, Skv, Hkv).  Returns the
    output, the counters and the flash launches the rule expects, by
    variant."""
    from repro_torch.kernels import dispatch
    fl = dispatch.flash_mha_kernel
    expected = Counter()

    def fl_counted(q, k, v, bias=None, kvl=None, **kw):
        tally[_zoo_key(q, k)] += 1
        expected[_flash_name(q, k, bias, v, **kw)] += 1
        return fl(q, k, v, bias, kvl, **kw)

    dispatch.reset_counters()
    with swapped(dispatch, "flash_mha_kernel", fl_counted):
        out = fn()
        torch.cuda.synchronize()
    return out, _counts(), expected


def _zoo_flash_ok(launches, expected, want) -> bool:
    """A zoo run's flash launches: ``want`` in all, each on the variant the
    rule gives its operands, none on a float32 or the fold's kernel."""
    got = {v: launches[v] for v in FLASH_VARIANTS if launches[v]}
    return (sum(got.values()) == want and got == dict(expected)
            and not any(launches[v] for v in (*F32_FLASH, "flash_mha_wg")))


def _zoo_model(torch, arch, layers, b, s, tally, fq_tally) -> dict:
    """One model of phase 9 (see the module docstring); returns its readings."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import common as cm
    from repro_torch.models import encdec as ed
    from repro_torch.models import lm
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(layers=layers)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    n_params = cm.count_params(params)
    log(f"zoo {arch}: {cfg.kind}, {cfg.layers} layers{' (reduced: layers)' if layers else ''}, "
        f"d_model {cfg.d_model}, {n_params / 1e9:.3f}B params "
        f"({cm.param_bytes(params) / 2**30:.2f} GiB bf16) from seed 0 in "
        f"{time.perf_counter() - t0:.1f}s")
    batch = _zoo_batch(torch, cfg, b, s)
    want = _zoo_attn_calls(cfg, "prefill")
    torch.cuda.reset_peak_memory_stats()
    with dispatch.use_backend("kernel"):
        logits, (launches, plain, routed), expected = _zoo_counted(
            torch, lambda: lm.prefill_fn(params, batch, cfg), tally)
        t0 = time.perf_counter()
        lm.prefill_fn(params, batch, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
    aaq = _zoo_aaq_prefill(torch, arch, params, batch, cfg, fq_tally)
    if (not _zoo_flash_ok(launches, expected, want) or any(plain.values())
            or routed["attention.ref"]):
        fail(f"zoo {arch}: prefill launched flash { {v: launches[v] for v in FLASH_VARIANTS} } "
             f"(want {want}, by the rule {dict(expected)}), plain {plain}, routed {routed}")
    prefill_flash = dict(expected)
    with dispatch.use_backend("ref"), _routing(torch) as ref_route:
        ref = lm.prefill_fn(params, batch, cfg)
    d_ref = float((logits - ref).abs().max())
    drift = float((aaq - logits).abs().max())
    c_ref = None
    if want:
        with dispatch.use_backend("kernel"), _zoo_fault(torch, arch, "prefill"):
            c_ref = float((lm.prefill_fn(params, batch, cfg) - ref).abs().max())
    routes = _zoo_routes(torch, arch, params, batch, cfg, ref, ref_route) \
        if cfg.kind == "moe" else None
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(aaq).all())
    # 16 decode steps from an empty cache against a prefill of the same
    # tokens; MoE at a capacity that seats every token (capacity_factor
    # E/k), since 16 prefill tokens a row can overflow an expert and drop
    # where one decode token never does (the reference's semantics)
    if cfg.kind == "moe":
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    toks = batch["tokens"][:, :ZOO_DECODE_TOKENS]
    max_len = cfg.hybrid.window if cfg.kind == "hybrid" else ZOO_DECODE_TOKENS
    cache = lm.make_cache(cfg, b, max_len, device="cuda")
    dbatch = {"tokens": toks}
    if cfg.kind == "encdec":
        dbatch["audio_frames"] = batch["audio_frames"]
        cache["enc_out"].copy_(ed.encode(params, batch["audio_frames"], cfg))
    step_want = _zoo_attn_calls(cfg, "decode")
    step_ms = []
    flash_variants = Counter(prefill_flash)
    with dispatch.use_backend("kernel"):
        for t in range(ZOO_DECODE_TOKENS):
            t0 = time.perf_counter()
            (dl, cache), (launches, plain, routed), expected = _zoo_counted(
                torch, lambda t=t: lm.decode_fn(params, {"tokens": toks[:, t:t + 1]}, cache,
                                                cfg), tally)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if (not _zoo_flash_ok(launches, expected, step_want) or any(plain.values())
                    or routed["attention.ref"]):
                fail(f"zoo {arch}: decode step {t} launched flash "
                     f"{ {v: launches[v] for v in FLASH_VARIANTS} } (want {step_want}, by the "
                     f"rule {dict(expected)}), plain {plain}, routed {routed}")
            flash_variants.update(expected)
        full = lm.prefill_fn(params, dbatch, cfg)
        c_dec = None
        if step_want or cfg.kind == "ssm":
            cache = lm.make_cache(cfg, b, max_len, device="cuda")
            if cfg.kind == "encdec":
                cache["enc_out"].copy_(ed.encode(params, batch["audio_frames"], cfg))
            with _zoo_fault(torch, arch, "decode"):
                for t in range(ZOO_DECODE_TOKENS):
                    cl, cache = lm.decode_fn(params, {"tokens": toks[:, t:t + 1]}, cache, cfg)
            c_dec = float((cl - full).abs().max())
    d_dec = float((dl - full).abs().max())
    finite = finite and bool(torch.isfinite(dl).all())
    out = dict(arch=arch, kind=cfg.kind, layers=cfg.layers, params_b=n_params / 1e9,
               flash_prefill=want, flash_step=step_want, prefill_ms=prefill_ms,
               flash_variants=dict(flash_variants),
               step_ms=sorted(step_ms)[len(step_ms) // 2], peak_gib=peak / 2**30,
               peak_above_params_gib=(peak - held) / 2**30, kernel_vs_plain=d_ref,
               control_prefill=c_ref, decode_vs_prefill=d_dec, control_decode=c_dec,
               aaq_drift=drift, logits_absmax=float(ref.abs().max()), routes=routes)
    log(f"zoo {arch}: prefill {b}x{s} {prefill_ms:.1f} ms, flash {want} a prefill"
        f"{' (attention-free: no flash call)' if not want else ''}, {step_want} a decode step "
        f"(by variant over the prefill and {ZOO_DECODE_TOKENS} steps {dict(flash_variants)}); "
        f"decode step {out['step_ms']:.2f} ms (median of {ZOO_DECODE_TOKENS}, host clock, "
        f"eager); peak {out['peak_gib']:.2f} GiB ({out['peak_above_params_gib']:.2f} above "
        f"the params); max|logits kernel - plain route| {d_ref:.4e} (limit "
        f"{ZOO_PREFILL_TOL[arch]}; control, {ZOO_PREFILL_FAULT.get(arch, 'none')}: {c_ref}), "
        f"max|decode - prefill| after {ZOO_DECODE_TOKENS} tokens {d_dec:.4e} (limit "
        f"{ZOO_DECODE_TOL[arch]}; control, "
        f"{ZOO_SSM_DECODE_FAULT if cfg.kind == 'ssm' else ZOO_DECODE_FAULT}: {c_dec}), "
        f"max|logits| {out['logits_absmax']:.3f}, AAQ vs DISABLED drift {drift:.4e} (not gated)")
    if routes:
        log(f"zoo {arch}: prefill routing, kernel route vs plain route: tokens whose top-"
            f"{cfg.moe.top_k} experts differ, of {routes['tokens']} a layer, by MoE layer "
            f"{routes['flips']} ({sum(routes['flips'])} in all); max|logits kernel route with the "
            f"plain route's routing forced - plain route| {routes['forced']:.4e} (limit "
            f"{ZOO_FORCED_TOL[arch]}; control forced too, {ZOO_PREFILL_FAULT[arch]}: "
            f"{routes['control_forced']})")
        if not routes["forced"] <= ZOO_FORCED_TOL[arch] < routes["control_forced"]:
            fail(f"zoo {arch}: forced routing: kernel vs plain {routes['forced']}, control "
                 f"{routes['control_forced']}, limit {ZOO_FORCED_TOL[arch]}")
    if not finite or d_ref > ZOO_PREFILL_TOL[arch] or d_dec > ZOO_DECODE_TOL[arch]:
        fail(f"zoo {arch}: finite {finite}, kernel vs plain {d_ref}, decode vs prefill {d_dec}")
    if ((c_ref is not None and not c_ref > ZOO_PREFILL_TOL[arch])
            or not c_dec > ZOO_DECODE_TOL[arch]):
        fail(f"zoo {arch}: a control passed its gate: prefill {c_ref}, decode {c_dec}")
    del params, cache, batch, logits, ref, aaq, dl, full
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_zoo(torch, zoo_pending, wide_pending, card: str) -> dict:
    """Phase 9 (see the module docstring).  Returns the launches by variant of
    its counted runs and fills the launches of the zoo kernel rows and of
    the wide quantize rows (its AAQ prefills' fake-quant of bf16 residual
    rows, bits 8, k 4, by width); ``card`` is the nvidia-smi name and power
    limit, printed with the readings."""
    tally = Counter()
    fq_tally = Counter()
    total = Counter()
    t0 = time.perf_counter()
    readings = []
    for arch, layers, b, s in ZOO_MODELS:
        readings.append(_zoo_model(torch, arch, layers, b, s, tally, fq_tally))
        total.update(readings[-1]["flash_variants"])
    total["aaq_fake_quant"] = sum(fq_tally.values())
    for row, key in zoo_pending:
        row.launches = tally.get(key, 0)
    for row, (name, *key) in wide_pending:      # (H, dtype, bits, k), at any T
        row.launches = sum(n for (_, *fq_key), n in fq_tally.items()
                           if fq_key == key) if name == "aaq_fake_quant" else 0
    log(f"zoo fake-quant launches by (T, H, dtype, bits, k): {dict(fq_tally)}")
    if not any(total[v] for v in FLASH_VARIANTS) or total["aaq_fake_quant"] == 0:
        fail(f"zoo: a kernel was never launched: {dict(total)}")
    log(f"zoo readings on {card}: {json.dumps(readings)}")
    log(f"phase 9 wall {time.perf_counter() - t0:.1f}s")
    return dict(total)


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------
TRAIN_ARGV = ("--arch", "qwen1.5-0.5b", "--batch", "8", "--seq", "64", "--lr", "1e-3",
              "--aaq-ste", "--steps", "8")
TRAIN_FAIL = ("--ckpt-every", "4", "--fail-at", "6")
TRAIN_HELD_OUT = 100          # the step whose batch phase 10 holds out
#: phase 10(b): limit on max over gradient leaves of max|kernel route - plain
#: route| / max|plain route| (and on the loss's relative difference).  The
#: two routes differ only in the fake-quant, which the kernel computes
#: bitwise, and the run is deterministic: the prediction is 0.  The
#: control (the first act site's gradient zeroed) must exceed it.
TRAIN_ROUTE_TOL = 1e-5
#: phase 10(c): (arch, layers) at full width, one train step each
TRAIN_ZOO = (("deepseek-v2-lite-16b", 2), ("recurrentgemma-9b", 3), ("mamba2-780m", 2),
             ("whisper-base", 2), ("phi-3-vision-4.2b", 2), ("mixtral-8x22b", 1))
TRAIN_ZOO_BATCH, TRAIN_ZOO_SEQ = 2, 64


@contextlib.contextmanager
def _deterministic(torch):
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _train_passes(cfg) -> tuple[int, int]:
    """(act calls, attention calls) of one training forward and its
    recomputation: the remat recomputes the layers the reference remats
    (every layer where the config scans them, but DeepSeek's dense first
    block; the hybrid's periods, not its tail; nothing of the enc-dec)."""
    acts = _act_calls(cfg)
    attn = _zoo_attn_calls(cfg, "prefill")
    if cfg.kind == "encdec":
        return acts, attn
    if cfg.kind == "hybrid":
        per = cfg.hybrid.attn_every
        n = cfg.layers // per
        return acts + n * (2 * per + 2), attn + n
    if cfg.kind == "moe" and cfg.moe.dense_first_layer_ff:
        return acts + 4 * (cfg.layers - 1), attn + cfg.layers - 1
    return 2 * acts, 2 * attn


def _tree_equal(torch, a, b) -> bool:
    from repro_torch.tree import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(_bitwise(torch, x, y) if x.is_floating_point()
                                      else bool(torch.equal(x, y)) for x, y in zip(la, lb))


def _grad_gap(torch, got, want) -> float:
    """max over leaves of max|got - want| / max|want|."""
    from repro_torch.tree import leaves
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(leaves(got), leaves(want)))


def _train_qwen(torch, fq_tally) -> tuple[dict, object]:
    """Phase 10(a): the launcher uninterrupted, then through a failure and
    a restart; returns its readings and the uninterrupted run's state."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AAQConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    cfg = get_config("qwen1.5-0.5b").replace(dtype="float32")
    # the per-step losses are of different batches (their spread, ~0.05 at
    # this learning rate, hides the trend): the loss falls when a batch the
    # run never sees (step 100's) scores better under the final weights
    # than under the initial ones (the launcher's, from seed 0)
    held_batch = {k: torch.from_numpy(v).cuda() for k, v in
                  SyntheticLM(cfg.vocab, 64, 8, seed=0).batch(TRAIN_HELD_OUT).items()}

    def held_loss(params) -> float:
        with torch.no_grad():
            return float(lm.loss_fn(params, held_batch, cfg, aaq=AAQConfig(ste=True)))

    held_first = held_loss(lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg))
    ckdir = ROOT / "build" / "phase10_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    dispatch.reset_counters()
    with _fq_tally(torch, fq_tally):
        clean = train.main([*TRAIN_ARGV, "--ckpt-every", "1000",
                            "--ckpt-dir", str(ckdir / "clean")])
        torch.cuda.synchronize()
    launches, plain, routed = _counts()
    peak = torch.cuda.max_memory_allocated() - held
    failed = train.main([*TRAIN_ARGV, *TRAIN_FAIL, "--ckpt-dir", str(ckdir / "failed")])
    acts, attn = _train_passes(cfg)
    held_last = held_loss(clean.state[0])
    steps = len(clean.losses)
    losses = clean.losses
    same = _tree_equal(torch, clean.state, failed.state)
    saves = failed.driver.saves
    step_ms = sorted(h["step_ms"] for h in clean.driver.history[1:])
    out = dict(losses=losses, held_out_first=held_first, held_out_last=held_last,
               restarts=failed.driver.restarts,
               starts=failed.driver.starts,
               resumed_equal=same, fake_quant_launches=launches["aaq_fake_quant"],
               want_fake_quant=steps * acts, attention_ref_grad=routed["attention.ref_grad"],
               want_attention=steps * attn, flash=sum(launches[v] for v in FLASH_VARIANTS),
               plain=plain, step_ms_median=step_ms[len(step_ms) // 2],
               first_step_ms=clean.driver.history[0]["step_ms"], peak_gib=peak / 2**30,
               saves=saves, replayed_losses_equal=failed.losses[6:] == losses[4:])
    log(f"train qwen1.5-0.5b (full width, f32, 8 x 64 tokens, --aaq-ste): losses {losses}; "
        f"held-out batch under the initial / final weights {held_first!r} / {held_last!r}; "
        f"step {out['step_ms_median']:.1f} ms (median of steps 1-7, host clock around a "
        f"synchronised step; step 0 {out['first_step_ms']:.1f} ms); peak "
        f"{out['peak_gib']:.2f} GiB above what was held before; aaq_fake_quant "
        f"{launches['aaq_fake_quant']} launches (want {steps} x {acts}), attention plain "
        f"(ref_grad) {routed['attention.ref_grad']} (want {steps} x {attn}), flash "
        f"{out['flash']}; restart: restarts {out['restarts']}, starts {out['starts']}, "
        f"final params and AdamW state bitwise the uninterrupted run's: {same}; saves "
        f"{saves}")
    ok = (all(math.isfinite(x) for x in losses) and held_last < held_first
          and out["restarts"] == 1 and out["starts"] == [0, 4] and same
          and out["replayed_losses_equal"]
          and launches["aaq_fake_quant"] == steps * acts and not any(plain.values())
          and routed["fakequant.ref"] == 0 and routed["fakequant.ref_grad"] == 0
          and routed["attention.ref_grad"] == steps * attn and out["flash"] == 0
          and routed["attention.kernel"] == 0 and len(saves) == 2)
    if not ok:
        fail(f"train qwen1.5-0.5b: {out}")
    del failed
    shutil.rmtree(ckdir, ignore_errors=True)
    return out, clean.state


def _train_routes(torch, params) -> dict:
    """Phase 10(b): one step's loss and gradients on the kernel route
    against the plain route, and the zeroed-site control against the plain
    route, on the same weights and batch."""
    from repro_torch.configs import get_config
    from repro_torch.core import policy
    from repro_torch.core.policy import AAQConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import value_and_grad
    cfg = get_config("qwen1.5-0.5b").replace(dtype="float32")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in SyntheticLM(cfg.vocab, 64, 8, seed=0).batch(TRAIN_HELD_OUT).items()}
    aaq = AAQConfig(enabled=True, ste=True)
    ste = policy._fake_quant_ste

    class ZeroGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, bits, k):
            return dispatch.fake_quant(x, bits=bits, k_outliers=k)

        @staticmethod
        def backward(ctx, g):
            return torch.zeros_like(g), None, None

    calls = []

    def first_zeroed(x, bits, k):
        calls.append(1)
        return (ZeroGrad.apply if len(calls) == 1 else ste)(x, bits, k)

    def run(mode, control=False):
        dispatch.set_backend(mode)
        try:
            if control:
                with swapped(policy, "_fake_quant_ste", first_zeroed):
                    return value_and_grad(params, batch, cfg, aaq=aaq)
            return value_and_grad(params, batch, cfg, aaq=aaq)
        finally:
            dispatch.set_backend("auto")

    dispatch.reset_counters()
    loss_k, g_k = run("auto")
    kern_launches = dispatch.launch_counts()["aaq_fake_quant"]
    loss_p, g_p = run("ref")
    plain_calls = dispatch.counters["fakequant.ref"]
    out = dict(loss_kernel=float(loss_k), loss_plain=float(loss_p),
               grad_gap=_grad_gap(torch, g_k, g_p),
               loss_gap=abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
               kernel_launches=kern_launches, plain_fake_quant=plain_calls)
    del g_k
    loss_c, g_c = run("auto", control=True)
    out["control_grad_gap"] = _grad_gap(torch, g_c, g_p)
    del g_c, g_p
    log(f"train routes, qwen1.5-0.5b one step: loss kernel route {out['loss_kernel']!r}, "
        f"plain route {out['loss_plain']!r}; max over leaves of max|grad kernel - plain| / "
        f"max|plain| {out['grad_gap']:.3e} (limit {TRAIN_ROUTE_TOL}; control, the first act "
        f"site's gradient zeroed: {out['control_grad_gap']:.3e}); fake-quant kernel launches "
        f"{kern_launches}, plain route's plain fake-quant {plain_calls}")
    if not (out["grad_gap"] <= TRAIN_ROUTE_TOL and out["loss_gap"] <= TRAIN_ROUTE_TOL
            < out["control_grad_gap"] and kern_launches > 0 and plain_calls > 0):
        fail(f"train routes: {out}")
    return out


def _train_zoo_model(torch, arch, layers) -> dict:
    """Phase 10(c): one train step of ``arch`` at full width."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core.policy import AAQConfig
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cfg = get_config(arch).replace(layers=layers, dtype="float32")
    if cfg.kind == "encdec":
        cfg = cfg.replace(enc_layers=layers)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw.init(params)
    n_params = cm.count_params(params)
    b, s = TRAIN_ZOO_BATCH, TRAIN_ZOO_SEQ
    batch = _zoo_batch(torch, cfg, b, s, seed=1)
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    for k in ("image_embeds", "audio_frames"):
        if k in batch:
            batch[k] = batch[k].float()
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-3), aaq=AAQConfig(enabled=True, ste=True),
                           microbatches=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_counters()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    ms = (time.perf_counter() - t0) * 1e3
    launches, plain, routed = _counts()
    acts, attn = _train_passes(cfg)
    out = dict(arch=arch, kind=cfg.kind, layers=layers, params_b=n_params / 1e9, loss=loss,
               grad_norm=gnorm, step_ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               fake_quant=launches["aaq_fake_quant"], want_fake_quant=acts,
               attention_ref_grad=routed["attention.ref_grad"], want_attention=attn)
    log(f"train {arch}: {cfg.kind}, {layers} layers at full width (d_model {cfg.d_model}), "
        f"{n_params / 1e9:.3f}B params, f32, {b} x {s} tokens: loss {loss:.4f}, grad norm "
        f"{gnorm:.4e}, step {ms:.1f} ms (host clock, first step), peak {out['peak_gib']:.2f} "
        f"GiB; aaq_fake_quant {launches['aaq_fake_quant']} launches (want {acts}), attention "
        f"plain (ref_grad) {routed['attention.ref_grad']} (want {attn})")
    ok = (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
          and launches["aaq_fake_quant"] == acts and not any(plain.values())
          and routed["fakequant.ref"] == 0 and routed["fakequant.ref_grad"] == 0
          and routed["attention.ref_grad"] == attn and routed["attention.kernel"] == 0
          and not any(launches[v] for v in FLASH_VARIANTS))
    if not ok:
        fail(f"train {arch}: {out} plain {plain} routed {routed}")
    del params, opt, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_phase(torch, train_pending, card: str) -> dict:
    """Phase 10 (see the module docstring).  Returns the launches by variant
    of the uninterrupted qwen run and fills the launches of the training
    quantize rows; ``card`` is the nvidia-smi name and power limit."""
    import gc
    t0 = time.perf_counter()
    fq_tally = Counter()
    with _deterministic(torch):
        qwen, state = _train_qwen(torch, fq_tally)
        routes = _train_routes(torch, state[0])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    for row, key in train_pending:
        row.launches = fq_tally.get(key, 0)
    zoo = [_train_zoo_model(torch, arch, layers) for arch, layers in TRAIN_ZOO]
    log(f"train readings on {card}: {json.dumps(dict(qwen=qwen, routes=routes, zoo=zoo))}")
    log(f"phase 10 wall {time.perf_counter() - t0:.1f}s")
    return {"aaq_fake_quant": sum(fq_tally.values())}


def flash_resources(build) -> None:
    """Phase 2's ptxas readout: registers a thread and spilled bytes of each
    flash instantiation, the tensor-core kernel's ``flash_tc_kernel<D, bias
    kind>`` (bias kind 0 none, 1 f32, 2 bf16), the Hopper kernel's
    ``flash_wg_kernel<D, bias kind>``, the decode kernel's
    ``flash_dec_kernel<D>`` and the prefill kernel's ``flash_pf_kernel<D>``
    (the Hopper kernels' consumer warpgroups raise their own count with
    setmaxnreg; ptxas reports the launch count and any spill past it); a
    spill fails."""
    import re
    res = {}
    for name, (regs, spill) in build.ptxas_resources().items():
        if m := re.search(r"flash_(tc|wg)_kernelILi(\d+)ELi(\d)E", name):
            res[(m[1], int(m[2]), int(m[3]))] = (regs, spill)
        elif m := re.search(r"flash_(dec|pf)_kernelILi(\d+)EE", name):
            res[(m[1], int(m[2]), 0)] = (regs, spill)
    for kind in ("tc", "wg", "dec", "pf"):
        got = {k[1:]: v for k, v in res.items() if k[0] == kind}
        if not got:
            fail(f"build: ptxas reported no flash_{kind}_kernel instantiation")
        by_d = {d: " / ".join(f"{got[d, b][0]}" for b in range(3) if (d, b) in got)
                for d in sorted({d for d, _ in got})}
        how = {"tc": "no bias / f32 / bf16 bias", "wg": "f32 / bf16 bias"}.get(kind, "no bias")
        log(f"build: flash_{kind}_kernel registers a thread (ptxas, sm_90a; {how}): "
            + ", ".join(f"D={d} {r}" for d, r in by_d.items())
            + f"; spilled bytes {sorted({s for _, s in got.values()})}")
    if spilled := {k: v for k, v in res.items() if v[1]}:
        fail(f"build: flash kernels spill registers at (kernel, D, bias kind) {spilled}")
    f32 = {}
    for name, v in build.ptxas_resources().items():
        if m := re.search(r"flash_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name):
            f32[f"flash_f32_kernel<{m[1]}, {m[2]}, {m[3]}>"] = v
        elif m := re.search(r"flash_f32_dec_kernelILi(\d+)ELi(\d+)E", name):
            f32[f"flash_f32_dec_kernel<{m[1]}, {m[2]}>"] = v
    if not any(k.startswith("flash_f32_kernel") for k in f32) or \
            not any(k.startswith("flash_f32_dec_kernel") for k in f32):
        fail(f"build: ptxas reported no flash_f32_kernel or flash_f32_dec_kernel: {f32}")
    log(f"build: the float32 flash kernels (registers a thread, spilled bytes; <output columns, "
        f"keys a tile, query rows> and <head dim, keys a tile>; ptxas, sm_90a): {f32}")
    if spilled := {k: v for k, v in f32.items() if v[1]}:
        fail(f"build: float32 flash kernels spill registers: {spilled}")


def matmul_resources(build) -> None:
    """Phase 2's ptxas readout of the Hopper matmul: registers a thread and
    spilled bytes of each ``aaq_matmul_wg_kernel<outliers, segments>``
    instantiation (up to four warpgroups of 128 threads: at most 128
    registers a thread); a spill fails."""
    import re
    res = {}
    for name, (regs, spill) in build.ptxas_resources().items():
        if m := re.search(r"aaq_matmul_wg_kernelILb([01])ELi(\d+)E", name):
            res[(int(m[1]), int(m[2]))] = (regs, spill)
    if not res:
        fail("build: ptxas reported no aaq_matmul_wg_kernel instantiation")
    log("build: aaq_matmul_wg_kernel registers a thread, spilled bytes (ptxas, sm_90a; "
        "<outliers, one H segment>): "
        + ", ".join(f"<{o}, {g}> {r}, {sp}" for (o, g), (r, sp) in sorted(res.items())))
    if spilled := {k: v for k, v in res.items() if v[1]}:
        fail(f"build: aaq_matmul_wg_kernel spills registers at <outliers, segment> {spilled}")
    split = {}
    for name, v in build.ptxas_resources().items():
        if m := re.search(r"aaq_matmul_split_kernelILi(\d)ELi(\d)E(f|13__nv_bfloat16)", name):
            split[f"<bits {m[1]}, {m[2]} part{'s' if m[2] != '1' else ''}>"] = v
    if len(split) != 4:
        fail(f"build: ptxas reported {len(split)} aaq_matmul_split_kernel instantiations, not 4")
    log(f"build: aaq_matmul_split_kernel registers a thread, spilled bytes (ptxas, sm_90a; "
        f"f32 W in 3 parts, bf16 W in 1): {split}")
    if spilled := {k: v for k, v in split.items() if v[1]}:
        fail(f"build: aaq_matmul_split_kernel spills registers: {spilled}")


# ---------------------------------------------------------------------------
# phase 11: the mesh-sharded fold tier
# ---------------------------------------------------------------------------
MESH_BUCKET = 256
# (a): the first request alone (the batch-1 key), then all four (batch 4)
MESH_LENGTHS = (250, 241, 233, 226)
# (b) and (c): model ranks on one card (host-staged gloo, eager) and across
# cards (NCCL, graphs); full width at this depth, each rank a process
MESH_WIDTHS = (2, 4)
MESH_BLOCKS = 8
# the chunked sharded fold: slabs of 64 rows of i inside a rank's j shard
MESH_CHUNK = 64
# TM floor of a sharded fold against the same fold on one device: the
# phase-4 floor, since only the placement differs
MESH_TM_GATE = 0.9995


def _mesh_serve(client, seqs) -> list:
    """``seqs[0]`` alone (a batch of 1), then all of ``seqs`` (one batch)."""
    first = client.submit(seqs[0])
    client.drive()
    handles = [client.submit(s) for s in seqs]
    client.drive()
    out = [first.result()] + [h.result() for h in handles]
    if not all(r.ok for r in out):
        fail(f"phase 11: a request was not served: {[r.status for r in out]}")
    return out


def _mesh_tm(torch, what, got, want) -> list:
    """Each result's TM against its single-device twin (1.0 where the
    coords are bitwise); fails under ``MESH_TM_GATE``."""
    from repro_torch.models.ppm import tm_score
    tms = [1.0 if np_equal(a.coords, b.coords) else
           float(tm_score(torch.from_numpy(a.coords), torch.from_numpy(b.coords)))
           for a, b in zip(got, want)]
    if min(tms) < MESH_TM_GATE or not all(np_finite(a.coords) for a in got):
        fail(f"{what}: TM against the single placement {tms} (gate {MESH_TM_GATE})")
    return tms


def _mesh_nccl_1x1(torch, cfg, params, seqs) -> dict:
    """(a): the engine on a 1x1 mesh over NCCL at threshold 256, keys
    captured as graphs with their collectives; returns the counted run's
    launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.parallel import collectives as coll
    from repro_torch.serving import FoldClient
    from repro_torch.serving.placement import ServingMesh
    kw = dict(buckets=(MESH_BUCKET,), max_tokens_per_batch=len(seqs) * MESH_BUCKET,
              max_batch=len(seqs), device="cuda")
    single = FoldClient(params, cfg, "lightnobel_aaq", **kw)
    want = _mesh_serve(single, seqs)
    t0 = time.perf_counter()
    _mesh_serve(single, seqs)
    wall_single = (time.perf_counter() - t0) * 1e3
    nodes_single = sorted((e.batch, e.nodes) for e in single.core._executables.values())
    single.close()
    mesh = ServingMesh(1, 1, backend="nccl")
    client = FoldClient(params, cfg, "lightnobel_aaq", mesh=mesh,
                        shard_threshold=MESH_BUCKET, **kw)
    dispatch.reset_counters()
    coll.reset_counts()
    t0 = time.perf_counter()
    first = _mesh_serve(client, seqs)
    wall = (time.perf_counter() - t0) * 1e3
    launches, plain, routed = _counts()
    _check_main_path("phase 11(a), 1x1 over NCCL", launches, plain, routed)
    core = client.core
    keys = list(core._executables.values())
    if core.compile_count != 2 or sorted(e.batch for e in keys) != [1, len(seqs)] \
            or any(e.graph is None or e.shard is None for e in keys):
        fail(f"phase 11(a): expected two sharded graph keys, got "
             f"{[(e.key, e.graph is not None) for e in keys]}")
    if {r.placement for r in first} != {"mesh:1x1"}:
        fail(f"phase 11(a): placements {[r.placement for r in first]}")
    t0 = time.perf_counter()
    second = _mesh_serve(client, seqs)
    wall2 = (time.perf_counter() - t0) * 1e3
    if core.compile_count != 2:
        fail(f"phase 11(a): the second pass captured {core.compile_count - 2} keys")
    if not all(np_equal(a.coords, b.coords) for a, b in zip(first, second)):
        fail("phase 11(a): the second pass's coords differ from the first's")
    tms = _mesh_tm(torch, "phase 11(a)", first, want)
    for e in sorted(keys, key=lambda e: e.batch):
        c = {k: v for k, v in e.collectives.items() if v["calls"]}
        log(f"phase 11(a): key {e.key}: {e.nodes} graph nodes, capture {e.capture_ms:.0f} ms, "
            f"collectives a fold {c} ({sum(v['bytes'] for v in c.values()) / 2**20:.1f} MiB "
            f"handed to them a rank)")
    log(f"phase 11(a): 1x1 over NCCL: 2 captures then 0, placements mesh:1x1, TM against "
        f"the single placement {tms} (1.0 = bitwise); wall {wall:.0f} ms with captures, "
        f"{wall2:.0f} ms replayed ({len(seqs) + 1} requests; the single placement's "
        f"replays {wall_single:.0f} ms, its graph nodes by batch {nodes_single})")
    client.close()
    mesh.close()
    return launches


def _mesh_ranks(torch, cfg, params, seq, width, backend, what, chunked) -> tuple:
    """(b)/(c): one N = 250 fold under AAQ and then FP on a 1 x ``width``
    mesh against the same fold on one device, and with ``chunked`` the AAQ
    fold at chunk ``MESH_CHUNK`` against the chunked fold on one device.
    Gates each rank's launches (unchunked: those of the single fold's
    graph, variant by variant: every op runs once a rank, at the shard's
    shapes; twice over NCCL, whose keys are graphs too: warm-up and
    capture; chunked: the same on every rank and the single fold's
    variants, since an op whose slabs run inside the j shard runs fewer of
    them), no plain call, its pinned pair shard (1/width of the pair
    tensor) and the TM; prints each rank's peak beside the admission
    estimate.  Returns (rank 0's launch tally of the unchunked AAQ fold,
    by shape; rank 0's launches of all its folds)."""
    from repro_torch.serving import FoldClient
    from repro_torch.serving.placement import ServingMesh
    mesh = ServingMesh(1, width, backend=backend)
    t0 = time.perf_counter()
    mesh.bind("cuda")
    log(f"{what}: {width} ranks up in {time.perf_counter() - t0:.1f}s (route {mesh.route})")
    kw = dict(buckets=(MESH_BUCKET,), max_batch=1, device="cuda")
    tally_aaq, total = None, Counter()
    runs = [("lightnobel_aaq", None), ("baseline_fp16", None)]
    if chunked:
        runs.append(("lightnobel_aaq", MESH_CHUNK))
    for scheme, chunk in runs:
        name = scheme if chunk is None else f"{scheme} at chunk {chunk}"
        single = FoldClient(params, cfg, scheme, chunk_size=chunk, **kw)
        want = single.submit(seq).result()
        (exe,) = single.core._executables.values()
        solo = {k: v * (2 if mesh.graphs else 1) for k, v in exe.kernel_launches.items()}
        est1 = single.core.admission.estimate_bytes(MESH_BUCKET, 1)
        single.close()
        t0 = time.perf_counter()
        client = FoldClient(params, cfg, scheme, mesh=mesh, shard_threshold=MESH_BUCKET,
                            chunk_size=chunk, **kw)
        t_params = (time.perf_counter() - t0) * 1e3
        mesh.rank_stats(reset=True)
        t0 = time.perf_counter()
        with launch_tally(full=True) as tally:
            got = client.submit(seq).result()
        wall = (time.perf_counter() - t0) * 1e3
        stats = mesh.rank_stats()
        if not got.ok or got.placement != f"mesh:1x{width}":
            fail(f"{what} {name}: {got.status} on {got.placement}")
        key = next(iter(client.core._executables))
        if key[-1] != (chunk or 0):
            fail(f"{what} {name}: the sharded key {key} is not at chunk {chunk or 0}")
        tm = _mesh_tm(torch, f"{what} {name}", [got], [want])[0]
        pair = (1, MESH_BUCKET, MESH_BUCKET // width, cfg.hz)
        est = client.core.admission.estimate_bytes(MESH_BUCKET, 1)
        for st in stats:
            routed = st["routes"]
            if chunk is None:
                launched_ok = st["launches"] == solo
            else:
                launched_ok = (st["launches"] == stats[0]["launches"]
                               and {k for k, v in st["launches"].items() if v}
                               == {k for k, v in solo.items() if v})
            if not launched_ok or any(st["plain"].values()) or \
                    any(routed[f"{op}.ref"] for op in ("attention", "qmatmul", "fakequant")):
                fail(f"{what} {name} rank {st['rank']}: launches {st['launches']} plain "
                     f"{st['plain']} routed {routed}; the single fold launched {solo}")
            if st["pair"] != pair:
                fail(f"{what} {name} rank {st['rank']}: pinned pair shard {st['pair']}, "
                     f"expected {pair}")
        c = {k: v for k, v in stats[0]["collectives"].items() if v["calls"]}
        log(f"{what} {name}: TM {tm:.6f} against one device; {wall:.0f} ms (the client's "
            f"bind with its parameter broadcast {t_params:.0f} ms); every rank "
            f"launched {stats[0]['launches']} (the single fold {solo}); pair shard {pair} "
            f"a rank (1/{width}); peak above the rank's baseline "
            f"{[round(st['peak_bytes'] / 2**20, 1) for st in stats]} MiB by rank against "
            f"the admission estimate {est / 2**20:.1f} MiB a device ({est1 / 2**20:.1f} on "
            f"one); collectives a rank {c}")
        total.update(stats[0]["launches"])
        if scheme == "lightnobel_aaq" and chunk is None:
            tally_aaq = Counter(tally)
        client.close()
    mesh.close()
    return tally_aaq, dict(total)


def _mesh_refusal(torch) -> None:
    """A mesh of more ranks than cards is refused on the card ("needs N
    devices"), unless the host-staged route is asked for."""
    from repro_torch.serving.placement import make_serving_mesh
    over = torch.cuda.device_count() + 1
    try:
        make_serving_mesh(f"1x{over}", device="cuda")
    except ValueError as e:
        if f"needs {over} devices" not in str(e):
            fail(f"phase 11: --mesh 1x{over} refused with {e}")
    else:
        fail(f"phase 11: --mesh 1x{over} was not refused on {over - 1} card(s)")
    make_serving_mesh(f"1x{over}", device="cuda", backend="gloo")
    log(f"phase 11: --mesh 1x{over} refused on {over - 1} card(s) (needs {over} devices); "
        f"the host-staged route takes it when asked for")


def serve_mesh(torch, rows: dict) -> tuple:
    """Phase 11 (see the module docstring).  Returns (the kernel rows at
    the shard's shapes with their launches a rank, the launches of the
    counted runs by variant)."""
    import gc
    from repro_torch.configs import get_ppm_config
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.models.ppm import init_ppm
    t0 = time.perf_counter()
    cfg = get_ppm_config()
    sampler = ProteinSampler(seed=11)
    seqs = [sampler.sample(300 + i, length=n) for i, n in enumerate(MESH_LENGTHS)]
    params = init_ppm(cfg, seed=0, device="cuda")
    _mesh_refusal(torch)
    launches = Counter(_mesh_nccl_1x1(torch, cfg, params, seqs))
    log(f"phase 11(a) done at {time.perf_counter() - t0:.1f}s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, blocks=MESH_BLOCKS)
    params = init_ppm(cut, seed=0, device="cuda")
    tallies = {}
    for width in MESH_WIDTHS:
        tallies[width], counted = _mesh_ranks(
            torch, cut, params, seqs[0], width, "gloo",
            f"phase 11(b), 1x{width} on one card over host-staged gloo", width == 2)
        launches.update(counted)
        log(f"phase 11(b) {width} ranks done at {time.perf_counter() - t0:.1f}s")
    cards = torch.cuda.device_count()
    if cards >= 2:
        width = min(cards, 4)
        _, counted = _mesh_ranks(torch, cut, params, seqs[0], width, "nccl",
                                 f"phase 11(c), 1x{width} across {width} cards over NCCL",
                                 True)
        launches.update(counted)
    else:
        log("phase 11(c): one card visible; NCCL across cards not run")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels at a rank's shapes: the rows-as-batch and token views of
    # the bucket-256 pair tensor shrink to N/W rows
    g = torch.Generator(device="cuda").manual_seed(11)
    pending = []
    for width in MESH_WIDTHS:
        _pair_kernels_at(torch, g, rows, pending,
                         f"mesh 1x{width}, bucket 256, a rank ({MESH_BLOCKS} blocks)",
                         width, (MESH_LENGTHS[0],), MESH_BUCKET // width, MESH_BUCKET)
    for row, width, key in pending:
        row.launches = tallies[width].get(key, 0)
        if row.launches == 0:
            fail(f"phase 11: no launch a rank at {row.name} [{row.shape}]")
    torch.cuda.empty_cache()
    log(f"phase 11 wall {time.perf_counter() - t0:.1f}s")
    return [row for row, _, _ in pending], dict(launches)


# ---------------------------------------------------------------------------
# phase 12: multi-device training (the sharded train step, GPipe, the ring
# matmuls, elastic resume)
# ---------------------------------------------------------------------------
MT_ARGV = ("--arch", "qwen1.5-0.5b", "--batch", "8", "--seq", "64", "--lr", "1e-3",
           "--deterministic", "--ckpt-every", "1000")
MT_STEPS = 3
#: the sharded run's losses against one card's under DISABLED (the
#: reference's gate for its sharded step, ``tests/test_distributed.py``)
MT_FP_TOL = 1e-4
#: ... and under ``--aaq-ste``, relative: a sanity bound, not a fault
#: detector.  The H100 read 1.88e-4 at 2x2 and 5.44e-5 at 1x4, and a rank
#: that skips its act sites 2.45e-4: at these random full-width weights
#: the whole AAQ-vs-DISABLED gap of the loss is 2.5e-4, and the products'
#: partial sums, added in another order, move values across fake-quant
#: bins that a loss this flat turns into gaps of that size (DISABLED reads
#: 3.9e-7).  The fault gate is ``_first_act``'s, bitwise.
MT_AAQ_TOL = 1e-3
#: the 1x1 mesh's losses and parameters against phase 10's unsharded steps:
#: bitwise expected (every op the same on the whole tensor), else this
MT_1X1_TOL = 1e-6
#: GPipe against ``loss_fn``, the ring matmul against ``x @ w`` (relative
#: to the largest entry): the reference's gates
MT_GPIPE_TOL = 2e-4
MT_RING_TOL = 2e-4
MT_GPIPE_POD = 4
MT_RING_SHAPE = (4096, 8192, 4096)     # (m, k, n)


def _mt_args(steps, aaq, *extra) -> list:
    return [*MT_ARGV, "--steps", str(steps), *(("--aaq-ste",) if aaq else ()), *extra]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _losses_gap(a, b) -> float:
    return max(_rel(x, y) for x, y in zip(a, b)) if len(a) == len(b) else math.inf


def _state_gap(torch, a, b) -> float:
    """max over leaves of max|a - b| / max|b| (0 where bitwise)."""
    from repro_torch.tree import leaves
    gap = 0.0
    for x, y in zip(leaves(a), leaves(b)):
        y = y.to(x.device)
        if not _bitwise(torch, x, y):
            gap = max(gap, float((x.float() - y.float()).abs().max())
                      / max(float(y.float().abs().max()), 1e-30))
    return gap


def _mt_refusal(torch) -> None:
    """``--model-parallel`` with more ranks than cards is refused."""
    from repro_torch.launch import train
    over = torch.cuda.device_count() + 1
    try:
        train.main(_mt_args(1, False, "--model-parallel", str(over)))
    except ValueError as e:
        if f"needs {over} devices" not in str(e):
            fail(f"phase 12: --model-parallel {over} refused with {e}")
    else:
        fail(f"phase 12: --model-parallel {over} was not refused on {over - 1} card(s)")
    log(f"phase 12: --model-parallel {over} refused on {over - 1} card(s) "
        f"(needs {over} devices)")


@contextlib.contextmanager
def _one_rank_nccl():
    """A process group of this process alone over NCCL (a 1x1 mesh)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    d, init = lmesh.rendezvous()
    lmesh.init_train_group(0, 1, init, "cuda")
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


def _mt_1x1(torch, tally) -> dict:
    """(a): three steps through ``launch.train`` on a 1x1 mesh over NCCL
    against the same three steps unsharded (phase 10's path)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    cfg = get_config("qwen1.5-0.5b").replace(dtype="float32")
    ck = ROOT / "build" / "phase12_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    with _deterministic(torch):
        plain = train.main(_mt_args(MT_STEPS, True, "--ckpt-dir", str(ck / "plain")))
        with _one_rank_nccl():
            dispatch.reset_counters()
            with _fq_tally(torch, tally):
                got = train.main(_mt_args(MT_STEPS, True, "--gather-state",
                                          "--ckpt-dir", str(ck / "mesh")))
            launches, plain_calls, routed = _counts()
    shutil.rmtree(ck, ignore_errors=True)
    acts, _ = _train_passes(cfg)
    lg, sg = _losses_gap(got.losses, plain.losses), _state_gap(torch, got.state, plain.state)
    out = dict(mesh=got.mesh, losses=got.losses, unsharded=plain.losses, loss_gap=lg,
               state_gap=sg, bitwise=lg == 0 and sg == 0,
               fake_quant=launches["aaq_fake_quant"], want_fake_quant=MT_STEPS * acts,
               step_ms=[round(h["step_ms"], 1) for h in got.driver.history],
               unsharded_step_ms=[round(h["step_ms"], 1) for h in plain.driver.history])
    log(f"phase 12(a), 1x1 over NCCL, qwen1.5-0.5b full width f32, 8 x 64, --aaq-ste, "
        f"{MT_STEPS} steps: losses {got.losses} against unsharded {plain.losses}; max "
        f"relative gap losses {lg:.3e}, parameters and AdamW state {sg:.3e} (bitwise: "
        f"{out['bitwise']}; limit {MT_1X1_TOL}); aaq_fake_quant {out['fake_quant']} launches "
        f"(want {MT_STEPS} x {acts}), plain fake-quant {plain_calls['aaq_fake_quant']}; step "
        f"ms {out['step_ms']} (unsharded {out['unsharded_step_ms']})")
    if not (got.mesh == (1, 1) and lg <= MT_1X1_TOL and sg <= MT_1X1_TOL
            and launches["aaq_fake_quant"] == MT_STEPS * acts
            and not any(plain_calls.values()) and routed["fakequant.ref"] == 0
            and routed["fakequant.ref_grad"] == 0):
        fail(f"phase 12(a): {out} plain {plain_calls} routed {routed}")
    return out


@contextlib.contextmanager
def _first_act(torch, rec: dict):
    """Record the first act site's input and output of a run into ``rec``
    (rank 0's local rows of a DTensor: rank 0 sits at coordinate 0 of
    every mesh dim, so its rows are the leading slice of each sharded
    dim).  The first site fake-quantizes the embedding's rows, which the
    vocabulary-parallel lookup makes bitwise one card's (it adds zeros):
    its output is the one place where a sharded AAQ run must be bitwise
    one card's."""
    from repro_torch.core import policy
    from repro_torch.parallel import sharding as sh
    inner = policy._fake_quant_ste

    def first(x, bits, k_outliers):
        y = inner(x, bits, k_outliers)
        if not rec:
            def local(t):
                return (t.to_local() if sh.is_dtensor(t) else t).detach().clone()
            rec.update(x=local(x), y=local(y), bits=bits, k=k_outliers)
        return y

    with swapped(policy, "_fake_quant_ste", first):
        yield


def _first_same(torch, got: dict, want: dict) -> tuple:
    """(input bitwise, output bitwise): rank 0's first-site rows against
    the same rows of one card's run."""
    sl = tuple(slice(0, n) for n in got["x"].shape)
    return (_bitwise(torch, got["x"], want["x"][sl].contiguous()),
            _bitwise(torch, got["y"].contiguous(), want["y"][sl].contiguous()))


def _mt_run(torch, mp, aaq, steps, report, *extra, tally=None, skip_rank0_acts=False,
            first=None):
    """``launch.train --model-parallel mp`` with this process as rank 0 (the
    launcher starts ranks 1..W-1 on the other cards); returns (the run,
    every rank's ``--report``).  ``first``: a dict ``_first_act`` fills."""
    from repro_torch.core import policy
    from repro_torch.launch import train
    shutil.rmtree(report, ignore_errors=True)
    argv = _mt_args(steps, aaq, "--model-parallel", str(mp), "--report", str(report), *extra)
    skip = (swapped(policy, "_fake_quant_ste", lambda x, bits, k: x) if skip_rank0_acts
            else contextlib.nullcontext())
    count = _fq_tally(torch, tally) if tally is not None else contextlib.nullcontext()
    rec = _first_act(torch, first) if first is not None else contextlib.nullcontext()
    with skip, count, rec:                  # (the recorder wraps the skip)
        run = train.main(argv)
    reps = [json.loads(p.read_text()) for p in sorted(Path(report).glob("rank*.json"))]
    return run, reps


def _mt_rank_line(what, reps) -> str:
    return "; ".join(
        f"rank {r['rank']}: peak {r['peak_bytes'] / 2**30:.2f} GiB above what it held "
        f"(one card 8.87), "
        f"step ms {[round(x, 1) for x in r['step_ms']]}, collectives a step "
        f"{ {k: (v['calls'], round(v['bytes'] / 2**20, 2)) for k, v in r['collectives_a_step'].items()} } "
        f"(calls, MiB)" for r in reps)


def _mt_check_ranks(what, reps, steps, acts, aaq) -> None:
    for r in reps:
        fq = r["launches"]["aaq_fake_quant"]
        if (fq != (steps * acts if aaq else 0) or any(r["plain"].values())
                or r["routed"]["fakequant.ref"] or r["routed"]["fakequant.ref_grad"]):
            fail(f"{what} rank {r['rank']}: aaq_fake_quant {fq} (want {steps} x {acts}), "
                 f"plain {r['plain']}, routed {r['routed']}")


def _mt_meshes(torch, tallies) -> dict:
    """(b): with two cards or more, the sharded runs at model 2 (and 4 on
    four cards) against one card's, the restart, the control, elastic
    resume, GPipe and the ring matmul."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config("qwen1.5-0.5b").replace(dtype="float32")
    acts, _ = _train_passes(cfg)
    cards = torch.cuda.device_count()
    base = ROOT / "build" / "phase12"
    shutil.rmtree(base, ignore_errors=True)
    out = {}
    bad = []         # every gate of (b) is read in one run, then the phase fails
    with _deterministic(torch):
        one_fp = train.main(_mt_args(MT_STEPS, False, "--ckpt-dir", str(base / "one_fp")))
        one_first = {}
        with _first_act(torch, one_first):
            one_aaq = train.main(_mt_args(MT_STEPS, True, "--ckpt-dir", str(base / "one_aaq")))
        one_fp.state = one_aaq.state = None               # their losses are what is kept
        for mp in (2, 4) if cards >= 4 else (2,):
            t0 = time.perf_counter()
            fp, fp_reps = _mt_run(torch, mp, False, MT_STEPS, base / f"rep_fp{mp}",
                                  "--ckpt-dir", str(base / f"fp{mp}"))
            tallies[fp.mesh] = Counter()
            first = {}
            aaq, aaq_reps = _mt_run(torch, mp, True, MT_STEPS, base / f"rep_aaq{mp}",
                                    "--ckpt-dir", str(base / f"aaq{mp}"), "--ckpt-every", "2",
                                    tally=tallies[fp.mesh], first=first)
            f_in, f_out = _first_same(torch, first, one_first)
            fp.state = aaq.state = None                   # (rank 0's DTensors, on the card)
            what = f"phase 12(b), --model-parallel {mp} on a {fp.mesh} mesh"
            _mt_check_ranks(what, fp_reps, MT_STEPS, acts, False)
            _mt_check_ranks(what, aaq_reps, MT_STEPS, acts, True)
            g_fp, g_aaq = _losses_gap(fp.losses, one_fp.losses), _losses_gap(aaq.losses,
                                                                              one_aaq.losses)
            out[f"mp{mp}"] = dict(mesh=fp.mesh, fp_losses=fp.losses, aaq_losses=aaq.losses,
                                  fp_gap=g_fp, aaq_gap=g_aaq, first_input_bitwise=f_in,
                                  first_output_bitwise=f_out, fp_ranks=fp_reps,
                                  aaq_ranks=aaq_reps)
            log(f"{what}: DISABLED losses {fp.losses} against one card's {one_fp.losses} "
                f"(max relative gap {g_fp:.3e}, limit {MT_FP_TOL}); --aaq-ste {aaq.losses} "
                f"against {one_aaq.losses} ({g_aaq:.3e}, bound {MT_AAQ_TOL}); the first act "
                f"site on rank 0's rows {tuple(first['x'].shape)}: input bitwise one card's "
                f"{f_in}, fake-quant output bitwise {f_out}; every rank aaq_fake_quant "
                f"{MT_STEPS} x {acts}, no plain fake-quant; {time.perf_counter() - t0:.1f}s")
            log(f"{what}, --aaq-ste: {_mt_rank_line(what, aaq_reps)}")
            if not (g_fp <= MT_FP_TOL and g_aaq <= MT_AAQ_TOL and f_in and f_out):
                bad.append(f"{what}: loss gaps {g_fp} / {g_aaq}, first act site input "
                           f"bitwise {f_in}, output bitwise {f_out}")
            if mp == 2:
                failed, _ = _mt_run(torch, 2, True, 4, base / "rep_failed", "--fail-at", "3",
                                    "--ckpt-every", "2", "--gather-state",
                                    "--ckpt-dir", str(base / "failed"))
                full, _ = _mt_run(torch, 2, True, 4, base / "rep_full", "--gather-state",
                                  "--ckpt-dir", str(base / "full"))
                same = _tree_equal(torch, failed.state, full.state)
                failed.state = full.state = None
                ctl_first = {}
                ctl, _ = _mt_run(torch, 2, True, MT_STEPS, base / "rep_ctl",
                                 "--ckpt-dir", str(base / "ctl"), skip_rank0_acts=True,
                                 first=ctl_first)
                g_ctl = _losses_gap(ctl.losses, one_aaq.losses)
                c_in, c_out = _first_same(torch, ctl_first, one_first)
                out["restart"] = dict(restarts=failed.driver.restarts,
                                      starts=failed.driver.starts, bitwise=same,
                                      losses=failed.losses, full=full.losses)
                out["control"] = dict(gap=g_ctl, first_input_bitwise=c_in,
                                      first_output_bitwise=c_out)
                log(f"{what}: failed at step 3 and restarted (restarts "
                    f"{failed.driver.restarts}, starts {failed.driver.starts}), final "
                    f"parameters and AdamW state bitwise the uninterrupted run's: {same}; "
                    f"control (rank 0 skips its act sites): losses {ctl.losses}, gap "
                    f"{g_ctl:.3e} against one card's; the first act site's input bitwise "
                    f"{c_in}, output bitwise {c_out} (must be False)")
                if not (same and failed.driver.restarts == 1 and failed.driver.starts == [0, 2]
                        and failed.losses[-1] == full.losses[-1] and c_in and not c_out):
                    bad.append(f"{what}: restart {out['restart']} control {out['control']}")
                ckpt_2x2 = base / "aaq2"
    if cards >= 4:
        out["elastic"] = _rank_job_run(torch, "elastic", 2, str(ckpt_2x2))
        out["gpipe"] = _rank_job_run(torch, "gpipe", MT_GPIPE_POD, "")
        out["ring"] = _rank_job_run(torch, "ring", 4, "")
        e, g, r = out["elastic"], out["gpipe"], out["ring"]
        if not (e["bitwise"] and e["mesh"] == (1, 2) and e["microbatch_scale"] == 2):
            bad.append(f"phase 12(b) elastic: {e}")
        if not g["gap"] <= MT_GPIPE_TOL:
            bad.append(f"phase 12(b) gpipe: {g}")
        if not r["gap"] <= MT_RING_TOL:
            bad.append(f"phase 12(b) ring: {r}")
    else:
        log(f"phase 12(b): {cards} cards; elastic resume from 2x2, GPipe at pod 4 and the "
            f"ring on 4 ranks need four")
    shutil.rmtree(base, ignore_errors=True)
    if bad:
        fail("; ".join(bad))
    return out


# the rank jobs of (b) and (c): rank 0 is this process, ranks 1.. processes
# of this script (``--rank-job``) on the other cards
def _join_group(rank: int, world: int, init: str, gloo: bool) -> None:
    """A card a rank over NCCL, or (``gloo``) every rank on this card over
    gloo, CUDA tensors staged through the host (phase 11(b)'s route)."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    if not gloo:
        lmesh.init_train_group(rank, world, init, "cuda")
        return
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=lmesh.TIMEOUT_S))


def _rank_job_run(torch, job, world, arg, gloo: bool = False) -> dict:
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    d, init = lmesh.rendezvous()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--rank-job", job,
                               "--rank", str(r), "--world", str(world), "--init", init,
                               "--arg", arg, "--parent", str(os.getpid()),
                               *(("--gloo",) if gloo else ())],
                              stdout=subprocess.DEVNULL) for r in range(1, world)]
    t0 = time.perf_counter()
    ok = False
    try:
        _join_group(0, world, init, gloo)
        res = _RANK_JOBS[job](torch, 0, world, arg)
        dist.barrier()
        ok = True
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if ok:
            lmesh.stop_ranks(procs)
        else:
            for p in procs:
                p.kill()
                p.wait()
        shutil.rmtree(d, ignore_errors=True)
    bad = [p.returncode for p in procs if p.returncode]
    if bad:
        fail(f"phase 12 {job}: ranks exited {bad}")
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 12 {job} on {world} ranks: {json.dumps(res)}")
    return res


def _job_elastic(torch, rank, world, ckpt_dir) -> dict:
    """The 2x2 run's latest checkpoint restored onto a 1x2 mesh: every leaf
    gathered (and its layers stacked) bitwise the checkpoint's array."""
    import numpy as np
    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.elastic import plan_for_devices, resume_elastic
    from repro_torch.tree import leaves, tree_map
    cfg = get_config("qwen1.5-0.5b").replace(dtype="float32")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    template = (params, adamw.init(params))
    plan = plan_for_devices(world, model_parallel=2, old_data=2)
    step, tree, mesh = resume_elastic(ckpt_dir, template, plan, cfg)
    d = Path(ckpt_dir) / f"step_{step:08d}"
    host = ckpt.stack_layers(tree_map(lambda x: sh.to_global(x).cpu().numpy(), tree), cfg)
    same = all(np.array_equal(x, np.load(d / f"arr_{i}.npy"))
               for i, x in enumerate(leaves(host)))
    return dict(step=step, mesh=tuple(mesh.shape), microbatch_scale=plan.microbatch_scale,
                leaves=len(leaves(tree)), bitwise=same)


def _job_gpipe(torch, rank, world, _arg) -> dict:
    """``gpipe_loss`` over ``pod`` = world (24 layers, 24/world a stage),
    4 microbatches, against ``loss_fn`` on one card."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.pipeline import gpipe_loss
    cfg = get_config("qwen1.5-0.5b").replace(dtype="float32")
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in SyntheticLM(cfg.vocab, 64, 8, seed=0).batch(0).items()}
    mesh = make_mesh((world,), ("pod",))
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = float(gpipe_loss(params, batch, cfg, mesh=mesh, n_micro=4))
        ms = (time.perf_counter() - t0) * 1e3
        want = float(lm.loss_fn(params, batch, cfg, remat=False))
    return dict(pod=world, layers=cfg.layers, gpipe=got, loss_fn=want, gap=_rel(got, want),
                ms=ms)


def _job_ring(torch, rank, world, _arg) -> dict:
    """``ring_ag_matmul_ws`` on ``world`` ranks (each its k-block of x, w
    whole) against ``x @ w`` on one card, timed."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import overlap
    m, k, n = MT_RING_SHAPE
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda")
    group = make_mesh((world,), ("model",)).get_group(0)
    kl = k // world
    xs = x[:, rank * kl:(rank + 1) * kl].contiguous()
    got = overlap.ring_ag_matmul_ws(xs, w, group)
    want = x @ w
    gap = float((got - want).abs().max()) / float(want.abs().max())
    ring_ms = call_ms(torch, lambda: overlap.ring_ag_matmul_ws(xs, w, group), iters=5, warmup=1)
    dense_ms = call_ms(torch, lambda: x @ w, iters=5, warmup=1)
    return dict(shape=MT_RING_SHAPE, ranks=world, gap=gap, ring_ms=ring_ms,
                one_card_matmul_ms=dense_ms)


# (c): a sharded prefill and decode on cards, full width at 2 layers in
# float32: phi-3's ring sharded on its 32 K/V heads, chatglm3's 2 K/V heads
# on the head dim (128).  The route of each: the kernels (float32 flash on
# the float32 kernels, phi-3 at head dim 96; chatglm3's decode's head-dim
# scores are plain PyTorch on either route)
MD_ARCHS = (("phi-3-vision-4.2b", "auto"), ("chatglm3-6b", "auto"))
MD_BATCH, MD_PROMPT, MD_RING, MD_POS, MD_STEPS, MD_LAYERS = 4, 32, 256, 100, 4, 2
#: the sharded steps' logits against one card's, relative to the largest:
#: the reference's gate for its sharded steps (``MT_FP_TOL``)
MD_TOL = 1e-4
#: the one card's logits of (c), by arch: rank 0 holds them for the job
_MD_ONE: dict = {}
#: float32 flash launches of (c)'s one-card runs, by ``_f32_key``
_MD_TALLY: Counter = Counter()


def _md_one_card(torch, arch) -> dict:
    """``_md_steps`` of ``arch`` on one card into ``_MD_ONE``, its flash
    launches tallied into ``_MD_TALLY``; -> the launches by variant."""
    from repro_torch.kernels import dispatch
    fl = dispatch.flash_mha_kernel

    def fl_counted(q, k, v, bias=None, kvl=None, **kw):
        _MD_TALLY[_f32_key(q, k)] += 1
        return fl(q, k, v, bias, kvl, **kw)

    dispatch.reset_counters()
    with swapped(dispatch, "flash_mha_kernel", fl_counted):
        _MD_ONE[arch], _ = _md_steps(torch, arch)
    return _counts()[0]


def _md_steps(torch, arch, mesh=None) -> list:
    """A prefill of ``MD_PROMPT`` tokens a row, then ``MD_STEPS`` decode steps
    from a random ring of ``MD_RING`` positions at ``MD_POS`` (the same
    numbers on every rank), on one card or laid out on ``mesh`` as the
    dry-run lays out its cells; -> every step's logits, whole, on the
    card."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.dryrun import _spec_leaves
    from repro_torch.models import common as cm
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import leaves, unflatten
    cfg = get_config(arch).replace(layers=MD_LAYERS, dtype="float32")
    place = ((lambda path, part: sh.distribute_params(part, mesh, cfg, path))
             if mesh is not None else cm.as_made)
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, place=place)
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (MD_BATCH, MD_PROMPT + MD_STEPS), generator=g,
                           device="cuda", dtype=torch.int32)
    cache = lm.make_cache(cfg, MD_BATCH, MD_RING, device="cuda")
    for t in leaves(cache):
        if t.is_floating_point():
            t.copy_(0.5 * torch.randn(t.shape, generator=g, device="cuda"))
    cache["pos"].fill_(MD_POS)
    batch = {"tokens": tokens[:, :MD_PROMPT]}
    prules = drules = None
    if mesh is not None:
        bspec = sh.batch_specs(cfg, ShapeSpec("p", MD_PROMPT, MD_BATCH, "prefill"), mesh)
        dspecs = sh.batch_specs(cfg, ShapeSpec("d", MD_RING, MD_BATCH, "decode"), mesh)
        batch = {k: sh.distribute(v, mesh, bspec["batch"][k]) for k, v in batch.items()}
        cache = unflatten(cache, [sh.distribute(t, mesh, sp) for t, sp in
                                  zip(leaves(cache), _spec_leaves(dspecs["cache"]))])
        prules = sh.default_act_rules(mesh, "prefill", cfg)
        drules = sh.default_act_rules(mesh, "decode", cfg)
        drules["kv_cache"] = sh.P(*dspecs["cache"]["k"][1:])
    out = []
    route = dict(MD_ARCHS)[arch]
    with torch.no_grad(), sh.mixed_ops(params), dispatch.use_backend(route):
        with sh.act_rules(prules):
            out.append(sh.to_global(lm.prefill_fn(params, batch, cfg)))
        with sh.act_rules(drules):
            for i in range(MD_STEPS):
                tok = tokens[:, MD_PROMPT + i:MD_PROMPT + i + 1].contiguous()
                if mesh is not None:
                    tok = sh.distribute(tok, mesh, dspecs["batch"]["tokens"])
                logits, cache = lm.decode_fn(params, {"tokens": tok}, cache, cfg)
                out.append(sh.to_global(logits))
        ring = str(cache["k"].placements) if sh.is_dtensor(cache["k"]) else None
    torch.cuda.synchronize()
    return out, ring


def _md_gap(torch, got, want) -> float:
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want))


def _job_decode(torch, rank, world, _arg) -> dict:
    """(c) across cards: ``_md_steps`` of each of ``MD_ARCHS`` on a
    (1, world) mesh; rank 0 holds them against one card's."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, world), ("data", "model"))
    res = {}
    for arch, _ in MD_ARCHS:
        got, ring = _md_steps(torch, arch, mesh)
        if rank == 0:
            res[arch] = dict(ring=ring, gap=_md_gap(torch, got, _MD_ONE[arch]))
    return res


def _md_decode(torch) -> tuple:
    """(c): the sharded prefill and decode steps on a 1x1 mesh over NCCL
    against one card's, bitwise; with two cards or more, on a 1xW mesh (W
    the cards, up to 4) across them, within ``MD_TOL``.  -> (the readings,
    the gates that failed)."""
    from repro_torch.launch.mesh import make_mesh
    out = {}
    bad = []
    for arch, _ in MD_ARCHS:
        counts = _md_one_card(torch, arch)
        f32 = {v: counts[v] for v in F32_FLASH}
        other = {v: counts[v] for v in FLASH_VARIANTS if v not in F32_FLASH and counts[v]}
        # a prefill launch a layer, and a decode launch a layer and step
        want = {"flash_mha_f32": MD_LAYERS, "flash_mha_f32_dec": MD_STEPS * MD_LAYERS}
        if f32 != want or other:
            bad.append(f"{arch}: float32 attention on the kernels launched {f32} {other}, "
                       f"not {want} and no bf16 flash variant")
        with _one_rank_nccl():
            got, ring = _md_steps(torch, arch, make_mesh((1, 1), ("data", "model")))
        same = all(_bitwise(torch, a, b) for a, b in zip(got, _MD_ONE[arch]))
        out[arch] = dict(one_by_one_bitwise=same, ring_1x1=ring, **f32)
        if not same:
            bad.append(f"{arch} on a 1x1 mesh: not bitwise one card's (max relative gap "
                       f"{_md_gap(torch, got, _MD_ONE[arch]):.3e})")
    cards = torch.cuda.device_count()
    if cards >= 2:
        world = min(cards, 4)
        res = _rank_job_run(torch, "decode", world, "")
        for arch, _ in MD_ARCHS:
            r = res[arch]
            out[arch].update({f"gap_1x{world}": r["gap"], f"ring_1x{world}": r["ring"]})
            if not r["gap"] <= MD_TOL:
                bad.append(f"{arch} on a 1x{world} mesh: max relative gap {r['gap']:.3e} "
                           f"above {MD_TOL}")
    else:
        log("phase 12(c): one card visible; the sharded decode across cards not run")
    log(f"phase 12(c), the sharded prefill and {MD_STEPS} decode steps ({MD_BATCH} rows, "
        f"{MD_PROMPT}-token prompts, a {MD_RING}-row ring at {MD_POS}), full width at 2 "
        f"layers f32, against one card: {json.dumps(out)}")
    _MD_ONE.clear()
    return out, [f"phase 12(c): {b}" for b in bad]


_RANK_JOBS = {"elastic": _job_elastic, "gpipe": _job_gpipe, "ring": _job_ring,
              "decode": _job_decode}


def rank_job(args) -> int:
    """A started rank of a phase 12 job: joins the group, runs the job,
    prints nothing."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import mesh as lmesh
    lmesh._watch_parent(args.parent)
    _watch_matmul_routes()
    _join_group(args.rank, args.world, args.init, args.gloo)
    _RANK_JOBS[args.rank_job](torch, args.rank, args.world, args.arg)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _mt_rows(torch, tallies) -> list:
    """``aaq_fake_quant`` at a rank's training shapes, from rank 0's tally of
    each mesh's --aaq-ste run, bitwise against the plain version and
    timed; launches a step a rank."""
    g = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for mesh, tally in tallies.items():
        for (t, h, dt, bits, k), n in sorted(tally.items()):
            x = torch.randn((t, h), generator=g, device="cuda")
            _quant_pair(torch, x, bits, k, f"the {mesh} training shape T={t} H={h}")
            row = _timed_quant_row(torch, "aaq_fake_quant", x, bits, k,
                                   f"x ({t}, {h}) float32, bits {bits}, k {k} (training, a "
                                   f"rank of a {mesh[0]}x{mesh[1]} mesh)")
            row.launches = n // MT_STEPS
            log(row.line() + f" launches a step a rank {row.launches}")
            rows.append(row)
    return rows


def train_mesh(torch, card: str) -> tuple:
    """Phase 12 (see the module docstring).  Returns (the training quantize
    rows at a rank's shapes, the launches by variant of rank 0's counted
    runs)."""
    t0 = time.perf_counter()
    _mt_refusal(torch)
    tallies = {(1, 1): Counter()}
    one = _mt_1x1(torch, tallies[(1, 1)])
    log(f"phase 12(a) done at {time.perf_counter() - t0:.1f}s")
    decode, decode_bad = _md_decode(torch)
    log(f"phase 12(c) done at {time.perf_counter() - t0:.1f}s")
    multi = {}
    if torch.cuda.device_count() >= 2:
        try:
            multi = _mt_meshes(torch, tallies)
        finally:
            if decode_bad:
                log("; ".join(decode_bad))
    else:
        log("phase 12(b): one card visible; sharded training across cards not run")
    if decode_bad:
        fail("; ".join(decode_bad))
    rows = _mt_rows(torch, tallies)
    log(f"phase 12 readings on {card}: {json.dumps(dict(one_by_one=one, meshes=multi, decode=decode))}")
    log(f"phase 12 wall {time.perf_counter() - t0:.1f}s")
    return rows, {"aaq_fake_quant": sum(sum(t.values()) for t in tallies.values())}


# ---------------------------------------------------------------------------
# phase 13: the fleet on one shared mesh (``--listen`` with ``--mesh``)
# ---------------------------------------------------------------------------
#: six requests of bucket 256, every one sharded over the mesh
MFLEET_LENGTHS = (250, 246, 241, 237, 233, 226)


def serve_fleet_mesh(torch, width: int) -> dict:
    """Two replicas of ``launch.serve``'s own factory (``--warmup``, no
    fidelity) on ONE 1 x ``width`` mesh over NCCL at threshold 256, at full
    esmfold_ppm width, behind ``FoldHTTPServer``: the 6 requests posted,
    replica 0 failed before anything is served (its queued requests
    requeued, the replica rebuilt on the same rank processes), then served;
    a second pass.  Gates: each request's TM >= 0.9995 against its
    single-device sequential fold; the wire bitwise the serving replica's
    own result; every rank holds only the live engines (the old one
    closed on the workers too); each replica's captures equal its keys,
    none in the second pass; every main-path kernel launched, no plain
    version; the mesh's rank processes gone once it is closed; and the CLI
    refusing ``--listen --mesh`` wider than the cards.  Returns the counted
    launches."""
    import gc
    import io
    import urllib.request
    from repro_torch.configs import get_ppm_config
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models.ppm import init_ppm, tm_score
    from repro_torch.serving import (FleetRouter, FoldHTTPServer, check_request_order,
                                     make_serving_mesh)
    from repro_torch.serving import events as ev
    from repro_torch.serving.transport import protocol
    from repro_torch.serving.transport.server import request_json
    t0 = time.perf_counter()
    what = f"phase 13, 2 replicas on one 1x{width} mesh"
    # the CLI refuses a fleet's mesh larger than the cards, as a lone mesh
    over = torch.cuda.device_count() + 1
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--mode", "ppm", "--listen", "127.0.0.1:0", "--replicas", "2",
                         "--mesh", f"1x{over}", "--shard-threshold", str(MESH_BUCKET)])
    if rc != 2 or f"needs {over} devices" not in out.getvalue():
        fail(f"{what}: --listen --mesh 1x{over} gave {rc}: {out.getvalue()!r}")
    log(f"{what}: --listen --replicas 2 --mesh 1x{over} refused: {out.getvalue().strip()}")
    cfg = get_ppm_config()
    params = init_ppm(cfg, seed=0, device="cuda")
    sampler = ProteinSampler(seed=11)
    seqs = [sampler.sample(500 + i, length=n) for i, n in enumerate(MFLEET_LENGTHS)]
    want = serve.serve_ppm_sequential(cfg, params, seqs, (MESH_BUCKET,), fidelity=False,
                                      device="cuda", emit=lambda *_: None)
    dev = torch.device("cuda")
    args = serve.parser().parse_args(
        ["--mode", "ppm", "--buckets", str(MESH_BUCKET), "--max-batch", "4", "--no-fidelity",
         "--warmup", "--mesh", f"1x{width}", "--shard-threshold", str(MESH_BUCKET)])
    mesh = make_serving_mesh(args.mesh, device=dev).bind(dev)
    procs = list(mesh._procs)
    dispatch.reset_counters()
    t1 = time.perf_counter()
    router = FleetRouter(serve.fold_replica_factory(args, cfg, params, (MESH_BUCKET,), dev,
                                                    mesh), 2, autostart=False, max_restarts=1)
    warm_s = time.perf_counter() - t1
    server = FoldHTTPServer(router, port=0, host="127.0.0.1").start()
    url = server.url

    def post(seq):
        return request_json(f"{url}/v1/fold", method="POST",
                            body={"sequence": seq.tolist()})["id"]

    def follow(rid):
        with urllib.request.urlopen(f"{url}/v1/fold/{rid}/events", timeout=600) as resp:
            return protocol.parse_sse(resp.read())

    def check(rids, label):
        tms = []
        for rid, events, ref in zip(rids, _gather(follow, rids), want):
            check_request_order(events)
            st = request_json(f"{url}/v1/fold/{rid}")
            mine = router.get(rid).handle._result
            wire = protocol.decode_array(st["result"]["coords"])
            if events[-1].kind != ev.COMPLETED or not mine.ok or \
                    st["result"]["placement"] != f"mesh:1x{width}":
                fail(f"{what}, {label}: request {rid} {events[-1].kind} "
                     f"{st['result']['placement']}")
            if wire.tobytes() != mine.coords.tobytes():
                fail(f"{what}, {label}: request {rid}'s wire is not its in-process result")
            tms.append(float(tm_score(torch.from_numpy(wire), ref.coords)))
        if min(tms) < MESH_TM_GATE:
            fail(f"{what}, {label}: TM {tms} against the sequential folds (gate {MESH_TM_GATE})")
        return tms

    try:
        keys = [sorted(r.client.core._executables) for r in router.replicas]
        log(f"{what}: {len(procs)} rank process(es) started, 2 replicas warmed in "
            f"{warm_s:.1f} s, keys {[len(k) for k in keys]}, engines on the mesh "
            f"{[r.client.core.mesh_eid for r in router.replicas]}")
        rids = [post(s) for s in seqs]
        old = router.replicas[0].client
        router.replicas[0].mark_failed()
        requeued = router.check_health()
        router.start()
        t2 = time.perf_counter()
        first = check(rids, "first pass")
        router.drain_wait(timeout=600.0)
        router.join_released(timeout=600.0)
        first_ms = (time.perf_counter() - t2) * 1e3
        new = router.replicas[0].client
        if not requeued or router.replicas[0].restarts != 1 or new is old or \
                router.released != [old] or old.core.mesh_eid is not None:
            fail(f"{what}: requeued {requeued}, restarts {router.replicas[0].restarts}, "
                 f"released {len(router.released)}")
        caps = [r.client.core.compile_count for r in router.replicas]
        t3 = time.perf_counter()
        second = check([post(s) for s in seqs], "second pass")
        router.drain_wait(timeout=600.0)
        second_ms = (time.perf_counter() - t3) * 1e3
        cores = [r.client.core for r in router.replicas]
        if [c.compile_count for c in cores] != caps or \
                any(c.compile_count != len(c._executables) for c in cores):
            fail(f"{what}: captures {[c.compile_count for c in cores]} (before the second "
                 f"pass {caps}) for keys {[len(c._executables) for c in cores]}")
        live = sorted(c.mesh_eid for c in cores)
        stats = mesh.rank_stats()
        if any(s["engines"] != live for s in stats):
            fail(f"{what}: engines by rank {[s['engines'] for s in stats]}, live {live}")
        launches, plain, routed = _counts()
        _check_main_path(what, launches, plain, routed)
        log(f"{what}: replica 0 failed with {len(requeued)} requests queued, requeued "
            f"{sorted(requeued)}, rebuilt on the same ranks (engine {new.core.mesh_eid}); "
            f"first pass {first_ms:.0f} ms, TM against the sequential folds "
            f"{[round(t, 5) for t in first]}; second pass {second_ms:.0f} ms, no capture, TM "
            f"{[round(t, 5) for t in second]}; wire bitwise in-process; engines on every rank "
            f"{live}; captures {[c.compile_count for c in cores]}; launches {launches}")
    finally:
        server.stop()
        router.stop()
        # the engines (their graphs, on every rank) go before the mesh: a
        # communicator is not torn down under graphs that captured its
        # collectives (the CLI's fleet does the same)
        for r in router.replicas:
            r.client.close()
        mesh.close()
    for p in procs:
        p.wait(timeout=60)
    if any(p.poll() is None for p in procs):
        fail(f"{what}: a rank process outlived the mesh")
    log(f"{what}: the mesh closed and its {len(procs)} rank process(es) gone; "
        f"phase wall {time.perf_counter() - t0:.1f}s")
    del router, old, new, cores, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 14: the examples
# ---------------------------------------------------------------------------
#: each example -> each kernel its path runs, as the variants that may
#: serve it.  The reduced configs are float32: the products and flash take
#: their f32 variants.  Training runs only the fake-quant (its attention
#: has no kernel backward); the LM decode tenant quantizes its KV rows and
#: attends by flash
_FOLD_KERNELS = (("aaq_quantize",), ("aaq_fake_quant",),
                 ("aaq_matmul", "aaq_matmul_wg", "aaq_matmul_f32"),
                 ("flash_mha_wg", "flash_mha_f32"))
EXAMPLES = {"quickstart": _FOLD_KERNELS, "fold_server": _FOLD_KERNELS,
            "train_lm": (("aaq_fake_quant",),),
            "lm_serve_quantized_kv": (("aaq_quantize",), ("flash_mha", *F32_FLASH,
                                                          "flash_mha_dec", "flash_mha_pf"))}
#: the lines of each example's output that phase 14 prints
EXAMPLE_LINES = ("TM-score", "pair-activation", "# tails", "# http", "# steady", "done:",
                 "training example", "kv_bytes_per_request", "max |logits_first")


def run_examples(torch) -> None:
    """``python -m repro_torch.examples.<name>`` for each example, all at
    once, on the card: each must exit 0 after its own assertions, with
    every kernel its path runs launched and no plain version."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {name: subprocess.Popen([sys.executable, "-m", f"repro_torch.examples.{name}"],
                                    cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in EXAMPLES}
    for name, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            fail(f"phase 14: {name} did not finish in 600 s:\n{out[-3000:]}")
        lines = out.strip().splitlines()
        if proc.returncode != 0 or not lines or not lines[-1].startswith("# launches "):
            fail(f"phase 14: {name} exited {proc.returncode}:\n{out[-3000:]}")
        launched, plain = (json.loads(p) for p in
                           lines[-1].removeprefix("# launches ").split(" plain "))
        if any(not any(launched[v] for v in family) for family in EXAMPLES[name]) \
                or any(plain.values()):
            fail(f"phase 14: {name}: launches {launched}, plain {plain}")
        log(f"phase 14: {name} exited 0 at {time.perf_counter() - t0:.1f}s; "
            + " | ".join(ln for ln in lines if ln.startswith(EXAMPLE_LINES)))
        log(f"phase 14: {name} launches {launched}")
    log(f"phase 14 wall {time.perf_counter() - t0:.1f}s")


def fold_f32_launches(torch) -> None:
    """The launches at each ``FOLD_F32_ROWS`` shape in quickstart's two folds
    (the reduced float32 config at ``FOLD_LEN`` residues, unquantized and
    AAQ), rerun in this process with the flash and AAQ-linear wrappers
    tallied by shape; a row whose shape the folds never launch fails."""
    from repro_torch.configs import reduce_ppm_config
    from repro_torch.core import make_scheme
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.kernels import dispatch
    from repro_torch.models.ppm import init_ppm, ppm_forward
    tally: Counter = Counter()
    fl, lin = dispatch.flash_mha_kernel, dispatch.aaq_linear

    def fl_counted(q, k, v, bias=None, kvl=None, **kw):
        tally["flash", tuple(q.shape)] += 1
        return fl(q, k, v, bias, kvl, **kw)

    def lin_counted(x, w, *, bits, k_outliers):
        tally["mm", *w.shape, k_outliers] += 1
        return lin(x, w, bits=bits, k_outliers=k_outliers)
    cfg = reduce_ppm_config()
    params = init_ppm(cfg, seed=0, device="cuda")
    seq = ProteinSampler(seed=3).sample(0, length=FOLD_LEN)
    aatype = torch.from_numpy(seq)[None].to("cuda")
    with swapped(dispatch, "flash_mha_kernel", fl_counted), \
            swapped(dispatch, "aaq_linear", lin_counted), torch.inference_mode():
        for scheme in (None, make_scheme("lightnobel_aaq")):
            ppm_forward(params, aatype, cfg, scheme)
    for row, key in FOLD_F32_ROWS:
        row.launches = tally.get(key, 0)
    log(f"phase 14: the reduced f32 fold's launches by shape (quickstart's two folds): "
        f"{dict(tally)}")
    if missing := [key for row, key in FOLD_F32_ROWS if not row.launches]:
        fail(f"phase 14: the reduced f32 fold never launched the timed shapes {missing}")


# ---------------------------------------------------------------------------
# phase 15: the dry-run, and its count held against the card
# ---------------------------------------------------------------------------
#: (arch, shape, --quant-kv, bound on peak_bytes_per_dev in GB or None)
#: traced on the fake 16 x 16 production mesh.  A bound is max(2x, x + 1
#: GB) of the reference's own dry-run peak x for the cell
#: (``repro.launch.dryrun --all``, XLA's memory_analysis, JAX 0.9.0 on the
#: CPU's 512 forced host devices): qwen1.5-0.5b x train_4k 4.08 GB,
#: deepseek-v2-lite-16b x decode_32k 6.30, phi-3-vision-4.2b x decode_32k
#: 23.06, chatglm3-6b x decode_32k 2.66, qwen2.5-3b x prefill_32k 1.23,
#: deepseek-v2-lite-16b x train_4k 5.24, esmfold_ppm x ns256 0.14 (the fold
#: on the production layout, ``PairGrid``).  None: reported, not gated (the
#: INT8 ring is not a reference cell)
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k", False, 8.16),
                ("qwen1.5-0.5b", "decode_32k", True, None),
                ("deepseek-v2-lite-16b", "decode_32k", False, 12.60),
                ("esmfold_ppm", "ns256", False, 1.14),
                ("phi-3-vision-4.2b", "decode_32k", False, 46.12),
                ("chatglm3-6b", "decode_32k", False, 5.32),
                ("qwen2.5-3b", "prefill_32k", False, 2.46),
                ("deepseek-v2-lite-16b", "train_4k", False, 10.48))


def _dry_cells() -> tuple:
    """Each of ``DRYRUN_CELLS`` traced by ``python -m
    repro_torch.launch.dryrun`` in a process of its own, all at once (each
    process its own fake process group; the deepseek train cell alone
    takes the better part of the phase); -> ([(cell, record, its line)],
    the cells that failed)."""
    out_dir = ROOT / "build" / "phase15"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    for i, (arch, name, qkv, bound) in enumerate(DRYRUN_CELLS):
        out = out_dir / f"cell{i}.jsonl"
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                name, "--mesh", "single", "--out", str(out), *(("--quant-kv",) if qkv else ())]
        procs.append((subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), out))
    res, bad = [], []
    for cell, (proc, out) in zip(DRYRUN_CELLS, procs):
        stdout, stderr = proc.communicate(timeout=600)
        line = next((ln for ln in stdout.splitlines() if ln.startswith("[ok]")), None)
        if proc.returncode or line is None:
            bad.append(f"{cell[:3]} exited {proc.returncode}: {stdout[-2000:]} "
                       f"{stderr[-2000:]}")
            continue
        res.append((cell, json.loads(out.read_text().splitlines()[-1]), line))
    shutil.rmtree(out_dir, ignore_errors=True)
    return res, bad


def _dry_phase10(torch, dryrun) -> None:
    """Phase 10's qwen1.5-0.5b step (8 x 64 tokens, float32, ``DISABLED``,
    one device) traced by the dry-run and run for real on the card under
    ``FlopCounterMode`` on the same (plain) route: the FLOP counts must be
    equal; the trace's peak printed beside the real step's
    ``max_memory_allocated``."""
    import gc
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cfg = get_config("qwen1.5-0.5b").replace(dtype="float32")
    shape = ShapeSpec("phase10", 64, 8, "train")
    rec = dryrun.lower_cell("qwen1.5-0.5b", shape, cfg=cfg, mesh_shape=())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = adamw.init(params)
    batch = {k: torch.zeros((8, 64), dtype=torch.int32, device="cuda")
             for k in ("tokens", "labels")}
    with dispatch.use_backend("ref"), FlopCounterMode(display=False) as fc:
        make_train_step(cfg)(params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    est = rec["mem"]["peak_bytes_per_dev"]
    real = fc.get_total_flops()
    log(f"phase 15: phase 10's step (qwen1.5-0.5b f32, 8 x 64, DISABLED, one device): traced "
        f"FLOPs {rec['cost']['flops_per_dev']:.0f}, FlopCounterMode on the card {real}; the "
        f"trace's peak {est / 2**30:.3f} GiB (arguments {rec['mem']['argument_bytes_per_dev'] / 2**30:.3f}), "
        f"the card's max_memory_allocated above what was held {peak / 2**30:.3f} GiB, ratio "
        f"{est / peak:.3f}; trace {rec['trace_s']} s")
    if rec["cost"]["flops_per_dev"] != real or real <= 0:
        fail(f"phase 15: traced FLOPs {rec['cost']['flops_per_dev']} != the card's {real}")
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()


def dry_run(torch) -> None:
    """``launch.dryrun`` on the fake 16 x 16 mesh (fake CUDA tensors,
    nothing allocated) for each of ``DRYRUN_CELLS``, its roofline line
    printed with the card's constants, beside each peak the widened float32
    copies and the largest storage an op made; a cell whose peak exceeds
    its bound fails the phase (every cell is read first); then
    ``_dry_phase10``."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    cells, bad = _dry_cells()
    for (arch, name, qkv, bound), rec, line in cells:
        tag = f"{arch} x {name} x single{' --quant-kv' if qkv else ''}"
        c = rec["collectives"]
        peak = rec["mem"]["peak_bytes_per_dev"] / 1e9
        log(f"phase 15: {line}; flops/dev "
            f"{rec['cost']['flops_per_dev']:.0f}, bytes/dev {rec['cost']['bytes_per_dev']:.4e} "
            f"(widened copies {rec['cost']['widen_bytes_per_dev']:.4e}), "
            f"collectives {c['counts']} ({sum(c['per_device_bytes'].values()) / 2**30:.3f} GiB "
            f"a device), mem {rec['mem']}, model_flops {rec['roofline']['model_flops']:.4e}, "
            f"useful {rec['roofline']['useful_fraction']:.3f}, roofline fraction "
            f"{rec['roofline']['roofline_fraction']:.4f}, device {rec['device']}; peak "
            f"{peak:.3f} GB against the bound {bound} GB")
        if rec["chips"] != 256 or rec["cost"]["flops_per_dev"] <= 0 or not c["counts"]:
            bad.append(f"{tag}: {rec['chips']} chips, {rec['cost']}, {c['counts']}")
        if bound is not None and peak > bound:
            bad.append(f"{tag}: peak {peak:.3f} GB a device above the bound {bound} GB")
    log(f"phase 15 cells wall {time.perf_counter() - t0:.1f}s")
    if bad:
        fail("phase 15: " + "; ".join(bad))
    _dry_phase10(torch, dryrun)
    log(f"phase 15 wall {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 16: the fold on the reference's production layout (a ``PairGrid``)
# ---------------------------------------------------------------------------
#: one card: esmfold_ppm at full width, GRID_BLOCKS of its 48 blocks (cut to
#: keep the phase near a minute), a GRID_LEN-residue protein in bucket
#: GRID_BUCKET, unchunked and row-chunked at GRID_CHUNK
GRID_BLOCKS = 8
GRID_LEN = 250
GRID_BUCKET = 256
GRID_CHUNK = 64
GRID_SCHEMES = ("lightnobel_aaq", "baseline_fp16")
#: four cards (``--mesh-only``): all 48 blocks, a card a rank over NCCL,
#: unchunked at N = GRID_LONG unpadded and chunked at GRID_CHUNK for a
#: GRID_LONG_CHUNKED-residue protein in bucket GRID_LONG_BUCKET (the
#: engine's long fold), TM against one card's fold of the same kind at the
#: CPU tests' floor
GRID_LONG = 1024
GRID_LONG_CHUNKED = ENGINE_LONG_LEN
GRID_LONG_BUCKET = ENGINE_LONG_BUCKET
GRID_TM_LONG = 0.995
#: one card's folds of the 2x2 job's inputs, by (run, scheme) (rank 0 reads them)
_GRID_ONE: dict = {}


def _grid_runs(across: bool) -> list:
    """Phase 16's runs, "blocks,n,bucket,chunk" each (chunk 0: unchunked)."""
    if across:
        return [f"48,{GRID_LONG},{GRID_LONG},0",
                f"48,{GRID_LONG_CHUNKED},{GRID_LONG_BUCKET},{GRID_CHUNK}"]
    return [f"{GRID_BLOCKS},{GRID_LEN},{GRID_BUCKET},{c}" for c in (0, GRID_CHUNK)]


def _grid_inputs(torch, n: int, bucket: int):
    """(aatype (1, bucket) on the card, its mask, or None where n fills
    the bucket) of phase 16's protein."""
    from repro_torch.data.pipeline import ProteinSampler
    from repro_torch.serving.types import pad_to_bucket
    aat, mask = pad_to_bucket([ProteinSampler(seed=16).sample(0, length=n)], bucket, 1)
    return (torch.from_numpy(aat).cuda(),
            None if n == bucket else torch.from_numpy(mask).cuda())


def _grid_fold(torch, cfg, params, grid, scheme, aat, mask, chunk=0) -> tuple:
    """``make_fold_step`` on ``grid`` (its parameters cut to the rank's
    shards by ``grid_params``) or, ``grid`` None, on one device, row-chunked
    at ``chunk`` (0: unchunked); -> (coords as numpy, the peak allocated
    above what was held before the fold)."""
    from repro_torch.core import make_scheme
    from repro_torch.launch.steps import make_fold_step
    from repro_torch.parallel import sharding as sh
    local = params
    if grid is not None:
        local, grid = sh.grid_params(params, grid)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        out = make_fold_step(cfg, make_scheme(scheme), shard=grid,
                             chunk_size=chunk or None)(local, aat, mask=mask)
    torch.cuda.synchronize()
    return out["coords"].float().cpu().numpy(), torch.cuda.max_memory_allocated() - held


def _grid_tm(torch, got, want) -> float:
    from repro_torch.models.ppm import tm_score
    if np_equal(got, want):
        return 1.0
    return float(tm_score(torch.from_numpy(got[0]), torch.from_numpy(want[0])))


def _job_grid(torch, rank, world, arg) -> dict:
    """2x2 ``PairGrid`` folds under each of ``GRID_SCHEMES``: ``arg`` is
    runs of "blocks,n,bucket,chunk" joined by ";".  Every rank folds its
    block; rank 0 holds the coords against one card's (``_GRID_ONE``) and
    returns, by run and scheme, the TM, every rank's peak, its own
    launches, plain calls and launch tally by shape, and its
    collectives."""
    import torch.distributed as dist
    from repro_torch.configs import get_ppm_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.ppm import init_ppm
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as sh
    grid = sh.pair_grid(make_mesh((2, 2), ("data", "model"), device_type="cuda"))
    res, cfg, params = {}, None, None
    for run in arg.split(";"):
        blocks, n, bucket, chunk = (int(x) for x in run.split(","))
        if cfg is None or cfg.blocks != blocks:
            cfg = params = None
            cfg = dataclasses.replace(get_ppm_config(), blocks=blocks)
            params = init_ppm(cfg, seed=0, device="cuda")
        aat, mask = _grid_inputs(torch, n, bucket)
        res[run] = {}
        for scheme in GRID_SCHEMES:
            dispatch.reset_counters()
            coll.reset_counts()
            t0 = time.perf_counter()
            with launch_tally(full=True) as tally:
                coords, peak = _grid_fold(torch, cfg, params, grid, scheme, aat, mask, chunk)
            wall = time.perf_counter() - t0
            launches, plain, routed = _counts()
            peaks = [None] * world
            dist.all_gather_object(peaks, peak)
            if rank == 0:
                res[run][scheme] = dict(
                    tm=_grid_tm(torch, coords, _GRID_ONE[(run, scheme)]["coords"]),
                    finite=np_finite(coords), peaks_mib=[round(p / 2**20, 1) for p in peaks],
                    fold_s=round(wall, 2), launches=launches, plain=plain,
                    ref_routes={k: v for k, v in routed.items() if k.endswith(".ref") and v},
                    collectives={k: v for k, v in coll.counts().items() if v["calls"]},
                    mm_route_faults=list(MM_ROUTE_FAULTS), tally=list(tally.items()))
    return res


_RANK_JOBS["grid"] = _job_grid


def _grid_rows(torch, rows, tally, label) -> list:
    """The three kernels at a 2x2 grid rank's shapes (bucket 256: a
    128 x 128 block of pair tokens, 64 fine rows a triangular attention,
    128 query rows against 256 keys in the sequence attention), each
    against its plain version and timed; launches from rank 0's tally."""
    g = torch.Generator(device="cuda").manual_seed(16)
    pending = []
    n = GRID_BUCKET
    _pair_kernels_at(torch, g, rows, pending, label, "grid", (GRID_LEN,), n // 4, n)
    c = _seq_rows(torch, g, (GRID_LEN,), n, structure=False)
    c = dict(c, q=c["q"][:, :n // 2], bias=c["bias"][:, :, :n // 2])
    _flash_engine_row(torch, rows, pending, c, (GRID_LEN,), label, "grid", "seq",
                      f"q ({1}, {n // 2}, 16, 64) bf16 (the rank's rows), k,v (1, {n}, 16, 64),"
                      f" bias (1, 16, {n // 2}, {n}) f32, the key length folded into it")
    out = []
    for row, _, key in pending:
        row.launches = tally.get(key, 0)
        if row.launches == 0:
            fail(f"phase 16: no launch a rank at {row.name} [{row.shape}]")
        out.append(row)
    return out


def grid_fold(torch, rows: dict, card: str, *, across: bool = False) -> list:
    """Phase 16 (see the module docstring).  One card: (a) a 1x1 grid
    over NCCL bitwise one card's fold, unchunked and chunked; (b) a 2x2
    grid of 4 processes on this card over the host-staged gloo route,
    unchunked and chunked, TM >= MESH_TM_GATE; then the kernels at a rank's
    shapes.  ``across`` (four cards): (c) the 2x2 grid a card a rank over
    NCCL at all 48 blocks, unchunked at N = GRID_LONG and chunked at
    GRID_LONG_CHUNKED residues, TM >= GRID_TM_LONG, each rank's peak beside
    one card's and a quarter of it.  Returns the kernel rows."""
    import gc
    from repro_torch.configs import get_ppm_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.ppm import init_ppm
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as sh
    t0 = time.perf_counter()
    bad, out = [], {}
    gate, what = (GRID_TM_LONG, "16(c)") if across else (MESH_TM_GATE, "16(b)")
    runs = _grid_runs(across)
    cfg = params = None
    for run in runs:
        blocks, n, bucket, chunk = (int(x) for x in run.split(","))
        if cfg is None or cfg.blocks != blocks:
            cfg = params = None
            cfg = dataclasses.replace(get_ppm_config(), blocks=blocks)
            params = init_ppm(cfg, seed=0, device="cuda")
        aat, mask = _grid_inputs(torch, n, bucket)
        for scheme in GRID_SCHEMES:
            t1 = time.perf_counter()
            coords, peak = _grid_fold(torch, cfg, params, None, scheme, aat, mask, chunk)
            _GRID_ONE[(run, scheme)] = dict(coords=coords, peak_mib=round(peak / 2**20, 1),
                                            fold_s=round(time.perf_counter() - t1, 2))
        if across:
            continue
        with _one_rank_nccl():
            grid = sh.pair_grid(make_mesh((1, 1), ("data", "model")))
            for scheme in GRID_SCHEMES:
                dispatch.reset_counters()
                coll.reset_counts()
                coords, peak = _grid_fold(torch, cfg, params, grid, scheme, aat, mask, chunk)
                launches, plain, routed = _counts()
                if scheme == "lightnobel_aaq":
                    _check_main_path(f"phase 16(a), a 1x1 grid over NCCL, chunk {chunk}",
                                     launches, plain, routed)
                one = _GRID_ONE[(run, scheme)]["coords"]
                same = np_equal(coords, one)
                out[f"1x1 chunk {chunk} {scheme}"] = dict(
                    bitwise=same, peak_mib=round(peak / 2**20, 1), launches=launches)
                if not same:
                    bad.append(f"16(a) chunk {chunk} {scheme}: a 1x1 grid not bitwise one "
                               f"card's (TM {_grid_tm(torch, coords, one):.6f})")
    if not across:
        log(f"phase 16(a) done at {time.perf_counter() - t0:.1f}s")
    cfg = params = None
    gc.collect()
    torch.cuda.empty_cache()
    res = _rank_job_run(torch, "grid", 4, ";".join(runs), gloo=not across)
    for run in runs:
        chunk = int(run.split(",")[-1])
        for scheme in GRID_SCHEMES:
            r = res[run][scheme]
            one = _GRID_ONE[(run, scheme)]
            r["one_card_peak_mib"] = one["peak_mib"]
            r["one_card_quarter_mib"] = round(one["peak_mib"] / 4, 1)
            r["one_card_fold_s"] = one["fold_s"]
            out[f"2x2 {run} {scheme}"] = {k: v for k, v in r.items() if k != "tally"}
            label = f"{what} [{run}] {scheme}"
            if not r["finite"] or r["tm"] < gate:
                bad.append(f"{label}: TM {r['tm']:.6f} against one card (gate {gate})")
            if any(r["plain"].values()) or r["ref_routes"]:
                bad.append(f"{label}: a plain version ran: {r['plain']} {r['ref_routes']}")
            if scheme == "lightnobel_aaq" and any(r["launches"][k] == 0
                                                  for k in dispatch.MAIN_PATH):
                bad.append(f"{label}: a main-path kernel was never launched: {r['launches']}")
            if any(r["launches"][k] for k in OFF_FOLD_FLASH):
                bad.append(f"{label}: another flash variant than flash_mha_wg: "
                           f"{r['launches']}")
            if r["mm_route_faults"]:
                bad.append(f"{label}: matmul calls off the rule (D >= 8 on aaq_matmul_wg): "
                           f"{r['mm_route_faults'][:8]}")
            if chunk:
                log(f"phase {what} [{run}] {scheme}: each rank's peak {r['peaks_mib']} MiB "
                    f"beside one card's chunked fold {one['peak_mib']} MiB and a quarter "
                    f"of it {r['one_card_quarter_mib']} MiB (printed, not gated)")
    _GRID_ONE.clear()
    log(f"phase 16 readings on {card} (esmfold_ppm, runs blocks,n,bucket,chunk {runs}): "
        f"{json.dumps(out)}")
    if bad:
        fail("phase 16: " + "; ".join(bad))
    grid_rows = []
    if not across:
        tally = Counter(dict(res[runs[0]]["lightnobel_aaq"]["tally"]))
        grid_rows = _grid_rows(torch, rows, tally,
                               f"grid 2x2, bucket {GRID_BUCKET}, a rank ({GRID_BLOCKS} blocks)")
    torch.cuda.empty_cache()
    log(f"phase 16 wall {time.perf_counter() - t0:.1f}s")
    return grid_rows


# ---------------------------------------------------------------------------
# phase 17: a profiled serve (``launch.serve --profile``)
# ---------------------------------------------------------------------------
#: ``launch.serve``'s flags for phase 17: 8 requests of 200-256 residues
#: (bucket 256, batches of 4) under AAQ, without the fidelity pass
PROFILE_ARGS = ("--mode", "ppm", "--n", "8", "--min-len", "200", "--max-len", "256",
                "--scheme", "lightnobel_aaq", "--no-fidelity")
#: each hand-written kernel's source -> its kernels' symbols there
KERNEL_SYMBOLS = {
    "aaq_quant.cu": ("aaq_quantize_lanes", "aaq_quantize_rows", "aaq_fake_quant_lanes",
                     "aaq_fake_quant_rows"),
    "aaq_matmul.cu": ("aaq_matmul_wg_kernel", "aaq_matmul_tc_kernel", "aaq_matmul_split_kernel"),
    "flash_attention.cu": ("flash_wg_kernel", "flash_tc_kernel"),
}
#: trace categories of the work the card does
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_family(name: str) -> str:
    """A device event's family: a hand-written kernel (flash by its head
    dim), cuBLAS's products, PyTorch's own kernels, or other."""
    import re
    if m := re.search(r"flash_tc_kernel<(\d+)", name):
        return f"flash_mha D={m.group(1)}"
    if m := re.search(r"flash_f32_(dec_)?kernel<(\d+)", name):
        return f"flash_mha_f32{'_dec' if m.group(1) else ''} D<={m.group(2)}"
    if m := re.search(r"flash_(wg|dec|pf)_kernel<(\d+)", name):
        return f"flash_mha_{m.group(1)} D={m.group(2)}"
    for fam in ("aaq_fake_quant", "aaq_quantize", "aaq_matmul_wg", "aaq_matmul"):
        if fam in name:
            return fam
    if re.search(r"gemm|gemv|nvjet|cutlass|xmma|cublas|splitk", name, re.I):
        return "cuBLAS products"
    if "at::" in name:
        return "PyTorch elementwise/reduction"
    return "other kernels"


def _covered_us(spans) -> float:
    """The length of the union of ``(start, end)`` spans."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace_summary(path) -> dict:
    """Read a ``torch.profiler`` Chrome trace: the window (every complete
    event's extent), the device work in it (kernels, copies, sets; their
    union is the busy time), device time by name and by family, and the
    host time inside the engine's ``serve.*`` ranges, by range."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    by_name, by_family = Counter(), Counter()
    calls, fam_calls = Counter(), Counter()
    for e in dev:
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        fam = kernel_family(name) if e["cat"] == "kernel" else "copies and sets"
        by_name[name] += float(e["dur"])
        calls[name] += 1
        by_family[fam] += float(e["dur"])
        fam_calls[fam] += 1
    ranges, range_us = Counter(), Counter()
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("serve."):
            ranges[e["name"]] += 1
            range_us[e["name"].split("/")[0]] += float(e["dur"])
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy = _covered_us(spans)
    d0, d1 = (min(a for a, _ in spans), max(b for _, b in spans)) if spans else (0.0, 0.0)
    return dict(window_us=t1 - t0, busy_us=busy, device_span_us=d1 - d0,
                kernels=sum(1 for e in dev if e["cat"] == "kernel"), by_name=by_name,
                calls=calls, by_family=by_family, family_calls=fam_calls, ranges=ranges,
                range_us=range_us)


def profile_serve(torch) -> None:
    """``launch.serve --profile DIR`` at full esmfold_ppm width through
    ``serve_ppm_engine`` (the CLI's own function, handed the full config):
    (a) with ``--warmup`` (only replays in the window), (b) without (the
    captures in the window), (c) as (a) under ``--driver thread`` (dispatch
    and retire on the client's own thread; where this torch cannot record
    another thread's ranges, the profiler's line saying so stands in for
    them).  Each: counts zeroed before and read after,
    every main-path kernel launched and no plain version, all 8 served and
    a batch of more than one; one trace file, holding a dispatch and a
    retire range for every bucket served, and where the profiler recorded
    device time a kernel of each hand-written source by its symbol.
    Printed: the ten device operations with the most time, the device-busy
    share of the window, the kernel count and the host time inside the
    engine's ranges."""
    import gc
    import io
    from repro_torch.configs import get_ppm_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models.ppm import init_ppm
    from repro_torch.serving import parse_buckets
    t0 = time.perf_counter()
    cfg = get_ppm_config()
    params = init_ppm(cfg, seed=0, device="cuda")
    dev = torch.device("cuda")
    for part, warm, driver in (("a", True, "inline"), ("b", False, "inline"),
                               ("c", True, "thread")):
        what = (f"phase 17({part}), --profile {'--warmup' if warm else 'cold'} "
                f"--driver {driver}")
        log_dir = ROOT / "build" / f"profile_serve_{part}"
        shutil.rmtree(log_dir, ignore_errors=True)
        args = serve.parser().parse_args([*PROFILE_ARGS, "--profile", str(log_dir),
                                          "--driver", driver,
                                          *(["--warmup"] if warm else [])])
        buckets = parse_buckets(args.buckets, args.min_len, args.max_len)
        seqs = serve._sample_trace(args.n, args.min_len, args.max_len)
        dispatch.reset_counters()
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = serve.serve_ppm_engine(args, cfg, params, seqs, buckets, dev)
        wall = time.perf_counter() - t1
        launches, plain, routed = _counts()
        lines = out.getvalue().splitlines()
        if rc != 0:
            fail(f"{what}: serve_ppm_engine returned {rc}:\n" + "\n".join(lines[-20:]))
        _check_main_path(what, launches, plain, routed)
        header = lines.index(next(ln for ln in lines if ln.startswith("request,")))
        rows = [ln.split(",") for ln in lines[header + 1:] if not ln.startswith("#")]
        served = sorted({int(r[2]) for r in rows if r[4] == "ok"})
        if len(rows) != args.n or any(r[4] != "ok" for r in rows) \
                or max(int(r[3]) for r in rows) < 2:
            fail(f"{what}: not all served, or no batch of more than one: {rows}")
        traces = sorted(log_dir.glob("*.pt.trace.json"))
        if len(traces) != 1:
            fail(f"{what}: expected one trace in {log_dir}, found {[t.name for t in traces]}")
        path = traces[0]
        tr = trace_summary(path)
        missing = [f"serve.{phase}/{b}" for b in served for phase in ("dispatch", "retire")
                   if not tr["ranges"][f"serve.{phase}/{b}"]]
        one_thread = [ln for ln in lines if ln.startswith("# profile: torch")]
        if missing and driver == "thread" and one_thread:
            # this torch cannot record the driver thread's ranges, and says so
            log(f"{what}: {one_thread[0]}; the ranges {missing} not recorded")
        elif missing:
            fail(f"{what}: the trace lacks the engine's ranges {missing}: {dict(tr['ranges'])}")
        summary = [ln for ln in lines if ln.startswith(("# served", "# engine", "# pipeline"))]
        log(f"{what}: served {len(rows)} in buckets {served}, batches "
            f"{sorted(Counter(int(r[3]) for r in rows).items())}, serve_ppm_engine "
            f"{wall:.1f}s; trace {path.name} {path.stat().st_size / 2**20:.1f} MiB; ranges "
            f"{dict(tr['ranges'])}; launches {launches}; " + " | ".join(summary))
        log(f"{what}: host time inside the engine's ranges: "
            + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in sorted(tr["range_us"].items()))
            + f" of a {tr['window_us'] / 1e3:.1f} ms window")
        if not tr["kernels"]:
            log(f"{what}: the profiler recorded no device time (device busy: not measured)")
            continue
        absent = [src for src, syms in KERNEL_SYMBOLS.items()
                  if not any(sym in name for name in tr["calls"] for sym in syms)]
        if absent:
            fail(f"{what}: no device event of {absent} in the trace")
        log(f"{what}: device busy {tr['busy_us'] / 1e3:.1f} ms of the {tr['window_us'] / 1e3:.1f} "
            f"ms window ({100 * tr['busy_us'] / tr['window_us']:.1f}%), {tr['kernels']} kernels; "
            f"by family: " + "; ".join(
                f"{fam} {us / 1e3:.1f} ms ({tr['family_calls'][fam]})"
                for fam, us in tr["by_family"].most_common()))
        for name, us in tr["by_name"].most_common(10):
            log(f"  {us / 1e3:9.2f} ms  {tr['calls'][name]:6d}x  {name[:110]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 17 wall {time.perf_counter() - t0:.1f}s")


def main(argv=None) -> int:
    # phase 10 runs under torch.use_deterministic_algorithms, whose cuBLAS
    # products need this workspace setting before CUDA initialises (32 MiB,
    # the size PyTorch takes on Hopper without it); the rank processes
    # inherit it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ap = argparse.ArgumentParser(description="smoke test of the port on the card")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build the kernels and run phases 11, 12, 13 and 16 (the mesh "
                         "tier, multi-device training, the fleet on a mesh, the grid "
                         "fold) alone")
    ap.add_argument("--phases", default="11,12,13,16",
                    help="with --mesh-only: the phases of 11, 12, 13 and 16 to run "
                         "(default all four)")
    # a started rank of a phase 12 job (``_rank_job_run``)
    ap.add_argument("--rank-job", choices=sorted(_RANK_JOBS), help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--arg", default="", help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--gloo", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_job:
        return rank_job(args)
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on the card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    resolve_device("cuda")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; nvcc {nvcc}")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f}s "
        f"({'built' if build.build_seconds is not None else 'cached'}) from "
        f"{[str(s.relative_to(ROOT)) for s in build.sources()]}")
    flash_resources(build)
    matmul_resources(build)
    _watch_matmul_routes()
    if args.mesh_only:
        return mesh_only(torch, smi, t_start, {int(x) for x in args.phases.split(",")})

    # 3. kernels vs plain versions, timed at every main-path shape
    rows: dict[str, list[KernelRow]] = {}
    check_quantize(torch, rows)
    check_matmul(torch, rows)
    check_flash(torch, rows)
    lm_pending = check_lm_kernels(torch, rows)
    zoo_pending = check_zoo_flash(torch, rows)
    wide_pending, train_pending = check_quantize_wide(torch)
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f}s")

    # 4. whole forward, kernels vs plain references
    check_forward(torch)
    log(f"phase 4 done at {time.perf_counter() - t_start:.1f}s")

    # 5. the main path: sequential serving at full width, short and long
    launches, cfg, params = serve_full_width(torch)
    for name, n in launches.items():
        if name in rows:                  # the tc flash rows are phase 8's and 9's
            rows[name][0].launches = n
    profile_folds(torch, cfg, params)
    log(f"phase 5 done at {time.perf_counter() - t_start:.1f}s")

    # 6. the batching engine: the kernels at its new shapes, then graphs
    # per key, batches of up to 4, the long fold
    pending = check_engine_shapes(torch, rows)
    check_slabbed_stages(torch, cfg, params)
    eng_launches, tally, ltally, readings = serve_engine(torch, cfg, params)
    sequential = readings.pop("sequential")
    for row, part, key in pending:
        row.launches = (tally if part == "short" else ltally).get(key, 0)
    log(f"engine launches (capture passes, short and long): {eng_launches}; at the new "
        f"shapes: {[(r.name, r.shape.split(':')[0], r.launches) for r, _, _ in pending]}")
    log(f"engine readings: {json.dumps(readings)}")
    log(f"phase 6 done at {time.perf_counter() - t_start:.1f}s")

    # 7. the fleet over HTTP (2 replicas of the engine) and the five
    # comparison schemes
    fleet_launches = serve_fleet(torch, cfg, params, sequential)
    log(f"fleet launches (warm-ups and captures): {fleet_launches}")
    fold_schemes(torch, cfg, params)
    log(f"phase 7 done at {time.perf_counter() - t_start:.1f}s")

    # 8. the LM decode tenant: qwen1.5-0.5b at full width under both
    # schemes, /v1/generate over HTTP, qwen2.5-3b at full width
    del params, sequential
    lm_launches = serve_lm(torch, lm_pending)
    log(f"lm launches (warm-ups and captures): {lm_launches}")
    log(f"phase 8 done at {time.perf_counter() - t_start:.1f}s")

    # 9. the rest of the model zoo at full width (mixtral at 2 of 56 layers)
    zoo_launches = serve_zoo(torch, zoo_pending, wide_pending, smi)
    log(f"zoo launches (one prefill and 16 decode steps a model): {zoo_launches}")
    log(f"phase 9 done at {time.perf_counter() - t_start:.1f}s")

    # 10. training: qwen1.5-0.5b through a failure and a restart, the kernel
    # route against the plain route, one step of each other kind
    train_launches = train_phase(torch, train_pending, smi)
    log(f"train launches (the uninterrupted qwen run): {train_launches}")
    log(f"phase 10 done at {time.perf_counter() - t_start:.1f}s")

    # 11. the mesh-sharded fold tier: 1x1 over NCCL through graphs, 2 and 4
    # ranks on this card over the host-staged gloo route, NCCL across cards
    mesh_rows, mesh_launches = serve_mesh(torch, rows)
    log(f"mesh launches (rank 0's counted runs): {mesh_launches}")
    log(f"phase 11 done at {time.perf_counter() - t_start:.1f}s")

    # 12. multi-device training: a 1x1 mesh over NCCL, and across cards
    # where there are two or more
    mt_rows, mt_launches = train_mesh(torch, smi)
    log(f"multi-device training launches (rank 0's counted runs): {mt_launches}")
    for row, key in zoo_pending:          # the float32 rows: 12(c)'s one-card runs
        if key[0] == "f32":
            row.launches = _MD_TALLY.get(key, 0)
    log(f"phase 12 done at {time.perf_counter() - t_start:.1f}s")

    # 13. the fleet on one shared mesh; 14. the examples; 15. the dry-run
    fm_launches = serve_fleet_mesh(torch, 1)
    log(f"fleet-on-a-mesh launches (warm-ups and the rebuilt replica's captures): "
        f"{fm_launches}")
    log(f"phase 13 done at {time.perf_counter() - t_start:.1f}s")
    run_examples(torch)
    fold_f32_launches(torch)
    log(f"phase 14 done at {time.perf_counter() - t_start:.1f}s")
    dry_run(torch)
    log(f"phase 15 done at {time.perf_counter() - t_start:.1f}s")

    # 16. the fold on the reference's production layout: a 1x1 grid over
    # NCCL, a 2x2 grid on this card over the host-staged gloo route
    grid_rows = grid_fold(torch, rows, smi)
    log(f"phase 16 done at {time.perf_counter() - t_start:.1f}s")

    # 17. a profiled serve: launch.serve --profile at full width, with and
    # without --warmup, and under --driver thread
    profile_serve(torch)
    log(f"phase 17 done at {time.perf_counter() - t_start:.1f}s")

    # 18. summary
    log(f"AAQ-linear matmuls on the card by variant over the run: {dict(MM_ROUTES)}; off "
        f"the rule (D >= 8 on aaq_matmul_wg, D < 8 on aaq_matmul): {len(MM_ROUTE_FAULTS)}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    # each variant at its first timed shape, then every kernel at the engine's
    # new shapes (batch 4 in bucket 256, the chunked bucket-2,048 slabs), the
    # LM decode shapes, the zoo's shapes, the quantize forms at the zoo's
    # residual widths (bf16, bits 8, k 4) and at the training shapes, the
    # pair kernels at a mesh rank's shapes (1x2, 1x4), the fake-quant at
    # a training rank's shapes, and the three kernels at a 2x2 grid rank's
    print(json.dumps({"kernels": [r[0].record() for r in rows.values()]
                      + [row.record() for row, _, _ in pending]
                      + [row.record() for row, _ in lm_pending]
                      + [row.record() for row, _ in zoo_pending]
                      + [row.record() for row, _ in wide_pending]
                      + [row.record() for row, _ in train_pending]
                      + [row.record() for row in mesh_rows]
                      + [row.record() for row in mt_rows]
                      + [row.record() for row in grid_rows]
                      + [row.record() for row, _ in FOLD_F32_ROWS]}))
    print(smi)
    print(ok_line(torch))
    return 0


def ok_line(torch) -> str:
    return json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}})


def mesh_only(torch, smi, t_start, phases) -> int:
    """``--mesh-only``: ``phases`` of 11 and 12 after the build, 13 on a
    1x2 mesh where there are two cards, and 16 (its 2x2 grid a card a rank
    where there are four cards, else on this card), then the kernel rows
    of 11, 12 and 16, the card and the last line."""
    if not phases or phases - {11, 12, 13, 16}:
        fail(f"--phases takes 11, 12, 13 and 16, not {sorted(phases)}")
    mesh_rows = mt_rows = grid_rows = []
    if 11 in phases:
        mesh_rows, mesh_launches = serve_mesh(torch, {})
        log(f"mesh launches (rank 0's counted runs): {mesh_launches}")
        log(f"phase 11 done at {time.perf_counter() - t_start:.1f}s")
    if 12 in phases:
        mt_rows, mt_launches = train_mesh(torch, smi)
        log(f"multi-device training launches (rank 0's counted runs): {mt_launches}")
        log(f"phase 12 done at {time.perf_counter() - t_start:.1f}s")
    if 13 in phases:
        if torch.cuda.device_count() >= 2:
            fm_launches = serve_fleet_mesh(torch, 2)
            log(f"fleet-on-a-mesh launches (warm-ups and the rebuilt replica's captures): "
                f"{fm_launches}")
            log(f"phase 13 done at {time.perf_counter() - t_start:.1f}s")
        else:
            log("phase 13: one card visible; the fleet on a 1x2 mesh not run")
    if 16 in phases:
        grid_rows = grid_fold(torch, {}, smi, across=torch.cuda.device_count() >= 4)
        log(f"phase 16 done at {time.perf_counter() - t_start:.1f}s")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [row.record() for row in mesh_rows]
                      + [row.record() for row in mt_rows]
                      + [row.record() for row in grid_rows]}))
    print(smi)
    print(ok_line(torch))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
