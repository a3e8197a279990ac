"""repro_torch.serving: request-lifecycle serving (port of ``repro/serving``).

``FoldClient`` is the serving surface: ``submit()`` returns a ``FoldHandle``
(priority, deadline, ``cancel()``, blocking ``result()``), progress streams
as typed ``FoldEvent``s, and batches run on the bucketed ``EngineCore``
(one CUDA graph per (bucket, launch batch, scheme, placement, chunk) key on
the card, token-budget continuous batching, AAQ-aware admission control,
the long-fold chunk planner).  ``FoldEngine`` is the legacy blocking
wrapper over the same client.  ``LMClient`` serves the LM decode tenant
(``serving/lm.py``) through the same substrate, one CUDA graph per scheme.
``FoldHTTPServer`` serves a ``FleetRouter`` of client replicas over HTTP.
"""
from repro_torch.serving.admission import (ADMIT, DEFER, REJECT, AdmissionController,
                                           AdmissionDecision)
from repro_torch.serving.client import (ADMITTED, CANCELLED, DONE, EXPIRED,
                                        HANDLE_STATES, LEGAL_TRANSITIONS, QUEUED,
                                        REJECTED as HANDLE_REJECTED, RUNNING,
                                        TERMINAL_STATES, FoldClient, FoldHandle)
from repro_torch.serving.costmodel import (CostEntry, CostModel, calibrate,
                                           load_cost_table, prediction_error_factor)
from repro_torch.serving.engine import (BatchExecutionError, EngineCore,
                                        FoldEngine, InFlightBatch)
from repro_torch.serving.events import (EVENT_KINDS, EVENT_ORDER, TERMINAL_EVENTS,
                                        EventBus, EventStream, FoldEvent,
                                        check_request_order)
from repro_torch.serving.lm import (KV_SITE, LM_CSV_HEADER, LMClient,
                                    LMDecodeWorkload, LMEngineCore, LMKVAdmission,
                                    LMMetrics, lm_csv_row)
from repro_torch.serving.longfold import (DEFAULT_LONGFOLD_BUDGET_MB, ChunkPolicy,
                                          chunk_candidates, parse_chunk_spec)
from repro_torch.serving.metrics import (CSV_HEADER, CompileWatcher, EngineMetrics,
                                         csv_row, percentiles,
                                         reset_compile_watch)
from repro_torch.serving.observability import (PROMETHEUS_CONTENT_TYPE,
                                               MetricsRegistry, MetricsServer,
                                               Span, Tracer, pipeline_overlaps,
                                               profile, span_tree, step_annotation,
                                               validate_chrome_trace)
from repro_torch.serving.placement import (SHARDED, SINGLE, SINGLE_PLACEMENT, Placement,
                                           PlacementPolicy, ServingMesh,
                                           make_serving_mesh, parse_mesh_spec)
from repro_torch.serving.scheduler import (Rejection, ScheduledBatch,
                                           TokenBudgetScheduler, bucket_for,
                                           parse_buckets, pow2_buckets,
                                           static_batch_for)
from repro_torch.serving.types import (BatchDeviceOutput, FoldRequest, FoldResult,
                                       LazyDistogram, LMResult, pad_to_bucket)
from repro_torch.serving.workload import FoldWorkload, Workload
# transport last: it builds on client/events/observability above
from repro_torch.serving.transport import (FleetRecord, FleetRouter,
                                           FoldHTTPServer, ProtocolError, Replica)

__all__ = [
    # lifecycle client
    "FoldClient", "FoldHandle", "HANDLE_STATES", "LEGAL_TRANSITIONS",
    "TERMINAL_STATES", "QUEUED", "ADMITTED", "RUNNING", "DONE",
    "HANDLE_REJECTED", "CANCELLED", "EXPIRED",
    # events
    "FoldEvent", "EventBus", "EventStream", "EVENT_KINDS", "EVENT_ORDER",
    "TERMINAL_EVENTS", "check_request_order",
    # placement (single device, or the pair tensor sharded over a mesh)
    "Placement", "PlacementPolicy", "SINGLE", "SHARDED", "SINGLE_PLACEMENT",
    "ServingMesh", "make_serving_mesh", "parse_mesh_spec",
    # long-fold tier (chunked-trunk memory planning)
    "ChunkPolicy", "parse_chunk_spec", "chunk_candidates",
    "DEFAULT_LONGFOLD_BUDGET_MB",
    # engine core + legacy wrapper
    "EngineCore", "FoldEngine", "FoldRequest", "FoldResult",
    "InFlightBatch", "BatchExecutionError", "LazyDistogram",
    "BatchDeviceOutput",
    "AdmissionController", "AdmissionDecision", "ADMIT", "DEFER", "REJECT",
    "TokenBudgetScheduler", "ScheduledBatch", "Rejection", "pow2_buckets",
    "parse_buckets", "bucket_for", "static_batch_for", "EngineMetrics",
    "CompileWatcher", "CSV_HEADER", "csv_row", "percentiles", "pad_to_bucket",
    "reset_compile_watch",
    # measured cost model
    "CostModel", "CostEntry", "calibrate", "load_cost_table", "prediction_error_factor",
    # observability (tracing + metrics registry + scrape endpoint)
    "Span", "Tracer", "span_tree", "pipeline_overlaps",
    "validate_chrome_trace", "MetricsRegistry", "MetricsServer",
    "PROMETHEUS_CONTENT_TYPE", "profile", "step_annotation",
    # workload substrate
    "Workload", "FoldWorkload",
    # LM decode tenant
    "LMClient", "LMEngineCore", "LMDecodeWorkload", "LMKVAdmission",
    "LMMetrics", "LMResult", "LM_CSV_HEADER", "lm_csv_row", "KV_SITE",
    # transport (HTTP front-end + fleet router)
    "FoldHTTPServer", "FleetRouter", "FleetRecord", "Replica",
    "ProtocolError",
]
