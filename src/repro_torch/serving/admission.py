"""AAQ-aware admission control: the paper's Table-1 accounting as a live
scheduling signal.

Each candidate (bucket, batch) is priced in *estimated peak activation
bytes*: the Pair-dataflow activations one folding block holds (from
``pair_activation_inventory``, priced at the active scheme's bits-per-value
via ``QuantScheme.act_bytes``) plus the triangular-attention score tensor —
the full cubic (B, H, N, N, N) fp32 tensor below the token-wise-MHA
threshold, and only the chunked (rows, H, q_chunk, N) slab above it (paper
§5.4).  The scheduler consults ``admit`` before growing a batch: batches
that would exceed the budget are deferred (the request waits for a smaller
batch), and a request whose bucket exceeds the budget even alone is
rejected deterministically.

Per-device accounting (mesh-sharded serving): when the engine's placement
policy routes a bucket to the mesh, ``shards_for`` reports its model-axis
shard count and every estimate here becomes a *per-device* share —
``ceil(total / shards)`` — because the pair activations, the score slab,
and the residual stream all carry the j dimension the serving rules shard
over ``model``.  ``mem_budget_bytes`` is therefore a per-device budget: a
bucket that busts it solo on one device is *admitted* once sharding fits
its share, which is the paper's long-sequence scalability story expressed
as a scheduling verdict.

Chunked-path accounting (the long-fold tier): when ``chunk_for`` (wired
from ``repro_torch.serving.longfold.ChunkPolicy``) reports a chunk for a bucket,
the estimate switches to the row-chunked execution model implemented by
``repro_torch.models.ppm.chunking``: the per-op working set is one O(N·chunk)
slab of the pair inventory (at scheme bits), plus the tensors that stay
resident across a chunk scan — the pair residual stream, tri-mul's
full-width partner operand, the attention-bias tables — plus the score
slab for ``chunk`` rows in flight.  Both estimators share ONE score-slab
model (``_score_slab_bytes``): rows × heads × min(q_chunk, N) × N fp32,
with rows = N token-wise unchunked and rows = chunk chunked, so the two
cost models cannot diverge.  Every decision records which estimator priced
it (``AdmissionDecision.estimator``) for the ``on_decision`` telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.schemes import QuantScheme
from repro_torch.models.ppm.model import pair_activation_inventory, score_tensor_shape
from repro_torch.models.ppm.trunk import CHUNKED_ATTN_LEN

ADMIT = "admit"
DEFER = "defer"
REJECT = "reject"

_SCORE_DTYPE_BYTES = 4          # fp32 logits/probs in both attention paths

#: sentinel: resolve the chunk via the wired ``chunk_for`` policy.  Callers
#: pass an explicit ``chunk=None`` to force unchunked pricing (the planner
#: itself does, when deciding whether chunking is needed at all).
POLICY = object()


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    verdict: str                # ADMIT | DEFER | REJECT
    est_bytes: int              # per-device when the bucket is sharded
    budget_bytes: int | None
    reason: str = ""
    shards: int = 1
    chunk_size: int = 0         # 0 = priced unchunked
    estimator: str = "cubic"    # cubic | q_chunk | chunked:<C>

    def event_data(self) -> dict:
        """Telemetry payload for the client's DEFERRED/REJECTED events."""
        return {
            "verdict": self.verdict,
            "est_mb": self.est_bytes / 1e6,
            "budget_mb": (None if self.budget_bytes is None
                          else self.budget_bytes / 1e6),
            "shards": self.shards,
            "chunk_size": self.chunk_size,
            "estimator": self.estimator,
            "reason": self.reason,
        }


class AdmissionController:
    """Prices (bucket, batch) candidates against a peak-activation budget.

    ``shards_for`` (bucket -> model-axis shard count, wired from the
    engine's ``PlacementPolicy``) turns every estimate into the per-device
    share; absent, everything is priced single-device (shards = 1).
    ``chunk_for`` (bucket -> chunk size or None, wired from the engine's
    ``ChunkPolicy``) routes buckets the planner chunks through the
    chunked-path estimator; absent, everything is priced unchunked.
    """

    def __init__(self, cfg, scheme: QuantScheme,
                 mem_budget_bytes: int | None = None, *,
                 chunked_len: int = CHUNKED_ATTN_LEN, q_chunk: int = 512,
                 shards_for: Callable[[int], int] | None = None,
                 chunk_for: Callable[[int], int | None] | None = None):
        self.cfg = cfg
        self.scheme = scheme
        self.mem_budget_bytes = mem_budget_bytes
        self.chunked_len = chunked_len
        self.q_chunk = q_chunk
        self.shards_for = shards_for
        self.chunk_for = chunk_for
        self._cache: dict[tuple[int, int, int, int], int] = {}
        #: optional observer called on EVERY decision (including scheduler
        #: probes — a metrics series counting verdicts sees probe traffic
        #: too, which is the point: DEFER pressure shows up before drops)
        self.on_decision: Callable[[AdmissionDecision, int, int], None] | None = None

    def _shards(self, ns: int, shards: int | None) -> int:
        if shards is not None:
            return max(1, shards)
        if self.shards_for is not None:
            return max(1, self.shards_for(ns))
        return 1

    def _chunk(self, ns: int, chunk) -> int | None:
        if chunk is not POLICY:
            return chunk or None
        if self.chunk_for is not None:
            return self.chunk_for(ns)
        return None

    def estimator_for(self, ns: int, chunk: int | None) -> str:
        if chunk:
            return f"chunked:{chunk}"
        return "q_chunk" if ns >= self.chunked_len else "cubic"

    # -- pricing ----------------------------------------------------------
    def estimate_bytes(self, ns: int, batch: int = 1,
                       shards: int | None = None, chunk=POLICY) -> int:
        """Estimated peak activation bytes for one (bucket=ns, batch) step,
        per device (``ceil(total / shards)`` under a sharded placement)."""
        k = self._shards(ns, shards)
        c = self._chunk(ns, chunk)
        key = (ns, batch, k, c or 0)
        if key not in self._cache:
            self._cache[key] = -(-self._total_bytes(ns, batch, c) // k)
        return self._cache[key]

    def _total_bytes(self, ns: int, batch: int, chunk: int | None = None) -> int:
        if chunk:
            return self._chunked_total_bytes(ns, batch, chunk)
        return (self._pair_bytes(ns, batch)
                + self._score_bytes(ns, batch)
                + self._residual_bytes(ns, batch))

    def _pair_bytes(self, ns: int, batch: int, chunk: int | None = None) -> int:
        """Pair-inventory bytes; with ``chunk`` the per-op working set is
        one (batch, chunk, ns, H) row slab instead of the full tensor."""
        inv = pair_activation_inventory(self.cfg, ns, batch)
        if chunk:
            inv = [(site, (shape[0], min(chunk, shape[1]), *shape[2:]))
                   for site, shape in inv]
        return sum(self.scheme.act_bytes(site, shape) for site, shape in inv)

    def _score_slab_bytes(self, ns: int, batch: int, rows: int) -> int:
        """THE attention-slab model, shared by both estimators: ``rows``
        q-rows in flight at once (ns on the token-wise unchunked path, the
        chunk size on the chunked path) x a min(q_chunk, ns)-query window x
        ns keys, fp32, per head.  For ns <= q_chunk and rows = ns this is
        exactly b*h*ns^3, so the cubic small-bucket model below coincides
        with it and the chunked_len threshold choice only matters for
        buckets past q_chunk.  A kernel-backend engine routing
        ns < chunked_len through the token-wise path therefore needs no
        pricing override."""
        h = score_tensor_shape(self.cfg, ns, batch)[1]
        return batch * rows * h * min(self.q_chunk, ns) * ns * _SCORE_DTYPE_BYTES

    def _score_bytes(self, ns: int, batch: int) -> int:
        if ns >= self.chunked_len:
            # token-wise MHA: rows are batch, the score slab is only ever
            # (batch*ns, h, q_chunk, ns)
            return self._score_slab_bytes(ns, batch, ns)
        b, h, *_ = score_tensor_shape(self.cfg, ns, batch)
        return b * h * ns ** 3 * _SCORE_DTYPE_BYTES

    def _residual_bytes(self, ns: int, batch: int) -> int:
        """The pair residual stream itself (carried across blocks, fp)."""
        itemsize = self.cfg.torch_dtype.itemsize
        return batch * ns * ns * self.cfg.hz * itemsize

    def _chunked_resident_bytes(self, ns: int, batch: int) -> int:
        """Full-width tensors a chunked block keeps resident across the
        row scan: the pair residual stream (fp), tri-mul's partner operand
        (at the scheme's ab bits — chunking.tri_mul_chunked materializes
        it once per op), and the tri/seq attention-bias tables (fp32,
        heads-wide so small)."""
        cfg = self.cfg
        partner = self.scheme.act_bytes(
            "tri_mul_out.ab", (batch, ns, ns, cfg.tri_hidden))
        bias = batch * ns * ns * (cfg.pair_heads + cfg.seq_heads) * _SCORE_DTYPE_BYTES
        return self._residual_bytes(ns, batch) + partner + bias

    def _chunked_total_bytes(self, ns: int, batch: int, chunk: int) -> int:
        if ns >= self.chunked_len:
            score = self._score_slab_bytes(ns, batch, min(chunk, ns))
        else:
            # einsum path: explicit (b, h, chunk, ns, ns) logits per chunk
            h = score_tensor_shape(self.cfg, ns, batch)[1]
            score = batch * h * min(chunk, ns) * ns * ns * _SCORE_DTYPE_BYTES
        return (self._chunked_resident_bytes(ns, batch)
                + self._pair_bytes(ns, batch, chunk)
                + score)

    # -- policy -----------------------------------------------------------
    def admit(self, ns: int, batch: int, shards: int | None = None,
              chunk=POLICY) -> AdmissionDecision:
        k = self._shards(ns, shards)
        c = self._chunk(ns, chunk)
        est = self.estimate_bytes(ns, batch, k, chunk=c)
        estimator = self.estimator_for(ns, c)
        per_dev = f"/device over {k} shards" if k > 1 else ""
        chunked = f" (chunk {c})" if c else ""
        if self.mem_budget_bytes is None or est <= self.mem_budget_bytes:
            d = AdmissionDecision(ADMIT, est, self.mem_budget_bytes,
                                  shards=k, chunk_size=c or 0,
                                  estimator=estimator)
        elif batch <= 1:
            d = AdmissionDecision(
                REJECT, est, self.mem_budget_bytes,
                f"bucket {ns} needs ~{est / 1e6:.1f}MB{per_dev}{chunked} "
                f"alone; budget {self.mem_budget_bytes / 1e6:.1f}MB",
                shards=k, chunk_size=c or 0, estimator=estimator)
        else:
            d = AdmissionDecision(
                DEFER, est, self.mem_budget_bytes,
                f"batch {batch} x bucket {ns} ~{est / 1e6:.1f}MB{per_dev}"
                f"{chunked} over budget", shards=k, chunk_size=c or 0,
                estimator=estimator)
        if self.on_decision is not None:
            self.on_decision(d, ns, batch)
        return d

    def max_batch_for(self, ns: int, upper: int,
                      shards: int | None = None) -> int:
        """Largest batch <= upper within budget (0 = even batch 1 is over)."""
        for b in range(upper, 0, -1):
            if self.admit(ns, b, shards).verdict == ADMIT:
                return b
        return 0

    def explain(self, ns: int, batch: int = 1, shards: int | None = None,
                chunk=POLICY) -> dict:
        """Breakdown for reports/debugging (MB, not bytes).  When a cost
        model is attached (``self.cost_model``, wired by the serve flow)
        the breakdown also carries the MEASURED predicted run latency for
        this (bucket, batch) — memory says whether it fits, the cost model
        says how long it takes."""
        k = self._shards(ns, shards)
        c = self._chunk(ns, chunk)
        cm = getattr(self, "cost_model", None)
        predicted = (None if cm is None
                     else cm.predict_run_ms(ns, batch))
        return {
            "predicted_run_ms": predicted,
            "bucket": ns, "batch": batch, "shards": k,
            "chunk_size": c or 0,
            "estimator": self.estimator_for(ns, c),
            "pair_mb": self._pair_bytes(ns, batch, c) / 1e6,
            "score_mb": self._score_bytes(ns, batch) / 1e6,
            "residual_mb": self._residual_bytes(ns, batch) / 1e6,
            "resident_mb": self._chunked_resident_bytes(ns, batch) / 1e6,
            "total_mb": self._total_bytes(ns, batch, c) / 1e6,
            "per_device_mb": self.estimate_bytes(ns, batch, k, chunk=c) / 1e6,
            "budget_mb": (None if self.mem_budget_bytes is None
                          else self.mem_budget_bytes / 1e6),
            "scheme": self.scheme.name,
        }
