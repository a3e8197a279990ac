"""The ``Workload`` protocol: what a model family provides to be served by
the substrate (port of ``repro/serving/workload.py``).  ``FoldWorkload`` is
here; the LM decode tenant's ``LMDecodeWorkload`` is in ``serving/lm.py``.

A workload owns the five things that differ between model families;
everything else (queues, priorities, deadlines, cancellation, events,
tracing, metrics plumbing) is substrate:

  * **executable surface**: ``input_specs`` (the (shape, dtype) of each
    input a (bucket, batch) executable is captured against) and ``forward``
    (the function captured).  The host engine owns the cache and its key;
    the workload defines what gets captured.
  * **batch formation**: ``pad_inputs`` turns a picked request list into
    the host arrays the executable consumes.
  * **admission cost model**: ``make_admission`` prices candidates in peak
    activation bytes.
  * **retire hooks**: ``block_on`` (what to wait for), ``transfer`` (the
    device->host move, including the lazy distogram), ``build_results``.
  * **result/event types**: ``result_type`` plus any event kinds beyond the
    shared lifecycle vocabulary (``extra_event_kinds``; LM decode adds
    ``TOKEN``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from repro_torch.models.ppm import ppm_forward, tm_score
from repro_torch.models.ppm.trunk import CHUNKED_ATTN_LEN
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.types import (BatchDeviceOutput, FoldResult,
                                       LazyDistogram, pad_to_bucket)

if TYPE_CHECKING:                      # pragma: no cover - typing only
    from repro_torch.serving.engine import InFlightBatch


class Workload:
    """Interface a model family implements to be served by the substrate.

    Instances are bound to their host engine with ``bind(core)`` before
    use; hooks read model config, scheme, metrics and policy objects
    through ``self.core``.
    """

    #: short label
    name = "workload"
    #: per-request result type the client/transport surface
    result_type: type = FoldResult
    #: event kinds beyond the shared lifecycle vocabulary (LM adds TOKEN)
    extra_event_kinds: tuple[str, ...] = ()

    def __init__(self):
        self.core: Any = None

    def bind(self, core) -> "Workload":
        """Attach the host engine; returns self."""
        self.core = core
        return self

    # -- executable surface -------------------------------------------------
    def input_specs(self, bucket: int, batch: int) -> tuple:
        """((shape, dtype), ...) of the (bucket, batch) executable's inputs,
        in ``forward``'s input order (after params)."""
        raise NotImplementedError

    def forward(self, scheme, chunk, params, *inputs):
        """One batch step.  ``scheme``/``chunk`` are fixed per executable
        (part of the host engine's cache key), ``params`` + ``inputs`` are
        tensors."""
        raise NotImplementedError

    def output_keys(self) -> tuple[str, ...]:
        """The outputs of ``forward`` a launch hands back (copied out of a
        graph's static buffers right after each replay)."""
        raise NotImplementedError

    # -- batch formation ------------------------------------------------------
    def pad_inputs(self, requests: tuple, bucket: int,
                   launched_b: int) -> tuple:
        """Host arrays for the executable's inputs, padded to the launch
        shape (dummy rows must be finite-garbage-safe)."""
        raise NotImplementedError

    # -- admission cost model -------------------------------------------------
    def make_admission(self, mem_budget_bytes: int | None):
        raise NotImplementedError

    # -- telemetry ---------------------------------------------------------------
    def make_metrics(self):
        return EngineMetrics()

    # -- retire hooks ----------------------------------------------------------
    def block_on(self, out) -> None:
        """Wait until the launched outputs are ready (ends run_ms timing)."""
        raise NotImplementedError

    def transfer(self, flight: "InFlightBatch"):
        """Device->host transfer of the retired batch; returns a payload
        handed to ``build_results``."""
        raise NotImplementedError

    def build_results(self, flight: "InFlightBatch", run_s: float,
                      payload) -> list:
        raise NotImplementedError


class FoldWorkload(Workload):
    """The protein-folding path."""

    name = "fold"

    # -- executable surface -------------------------------------------------
    def input_specs(self, bucket: int, batch: int) -> tuple:
        return (((batch, bucket), torch.int32), ((batch, bucket), torch.bool))

    def forward(self, scheme, chunk, params, aatype, mask, shard=None):
        # a sharded key: this rank's shard of the fold; the distogram head
        # runs (on a mesh, gathered to rank 0) only when it is kept
        return ppm_forward(params, aatype, self.core.cfg, scheme, mask=mask,
                           chunk_size=chunk or None, shard=shard,
                           distogram=self.core.keep_distogram)

    def output_keys(self) -> tuple[str, ...]:
        return ("coords", "distogram") if self.core.keep_distogram else ("coords",)

    # -- batch formation ------------------------------------------------------
    def pad_inputs(self, requests: tuple, bucket: int,
                   launched_b: int) -> tuple:
        return pad_to_bucket([r.aatype for r in requests], bucket,
                             launched_b)

    # -- admission cost model -------------------------------------------------
    def make_admission(self, mem_budget_bytes: int | None
                       ) -> AdmissionController:
        # pricing switches to the chunked score-slab model at the model's
        # token-wise MHA threshold
        return AdmissionController(
            self.core.cfg, self.core.scheme, mem_budget_bytes,
            chunked_len=CHUNKED_ATTN_LEN,
            shards_for=self.core.placement.shards_for)

    # -- retire hooks ----------------------------------------------------------
    def block_on(self, out) -> None:
        ready = out.get("ready")
        if ready is not None:       # a CUDA event recorded after the
            ready.synchronize()     # output copies of the batch's replays

    def transfer(self, flight: "InFlightBatch"):
        # one device->host copy of coords a batch, numpy slicing after
        # that; the distogram (the peak host-memory term at long N) stays
        # on the device behind a shared BatchDeviceOutput until a consumer
        # asks a LazyDistogram for it
        core = self.core
        coords_host = flight.out["coords"].float().cpu().numpy()
        disto = None
        if core.keep_distogram:
            darr = flight.out["distogram"]
            pinned = int(darr.numel() * darr.element_size())
            core.metrics.record_pinned(pinned)
            metrics = core.metrics   # bind: run() swaps metrics
            disto = BatchDeviceOutput(
                darr, nbytes=pinned,
                on_release=(lambda m=metrics, n=pinned:
                            m.record_pinned(-n)))
        fp_coords = (None if flight.fp_out is None
                     else flight.fp_out["coords"].float().cpu().numpy())
        return coords_host, disto, fp_coords

    def build_results(self, flight: "InFlightBatch", run_s: float,
                      payload) -> list[FoldResult]:
        coords_host, disto, fp_coords = payload
        core = self.core
        batch = flight.batch
        results = []
        for row, req in enumerate(batch.requests):
            coords = np.array(coords_host[row, :req.length])
            tm = None
            if core.fidelity:
                # on the host copies: the SVD of the superposition runs on
                # the CPU, never on the card
                tm = 1.0 if fp_coords is None else float(tm_score(
                    torch.from_numpy(coords),
                    torch.from_numpy(np.array(fp_coords[row, :req.length]))))
            results.append(FoldResult(
                request_id=req.request_id, length=req.length,
                bucket=flight.bucket, batch_size=len(batch.requests),
                coords=coords,
                distogram=None if disto is None else LazyDistogram(
                    disto, row, req.length,
                    int(flight.out["distogram"].shape[-1])),
                tm_vs_fp=tm,
                priority=req.priority,
                queue_wait_ms=(flight.batch_start - req.arrival_time) * 1e3,
                compile_ms=flight.compile_s * 1e3,
                run_ms=run_s * 1e3,
                launched_batch=flight.launched_b,
                occupancy=flight.occupancy,
                est_activation_bytes=flight.est,
                kernel_backend=flight.backend,
                placement=flight.placement.label,
                chunk_size=flight.chunk_size))
        return results
