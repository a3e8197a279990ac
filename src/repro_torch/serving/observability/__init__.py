"""repro_torch.serving.observability: tracing and metrics for the serving
stack (port of ``repro/serving/observability``).

  * ``tracing``: per-request and per-batch ``Span`` trees recorded by a
    bounded, clock-injectable ``Tracer``, exported as Chrome-trace/Perfetto
    JSON (``--trace-out``); ``pipeline_overlaps`` counts the in-flight
    ring's dispatch/retire overlap;
  * ``registry``: labeled Counter/Gauge/Histogram instruments with
    Prometheus text and JSON exposition (``FoldClient.metrics_text()`` /
    ``metrics_json()``);
  * ``profiler`` + ``httpd``: ``torch.profiler``/NVTX ranges around the
    engine's batch phases (``annotate``, ``step_annotation``), the
    run-level capture ``profile`` (``--profile``, the counterpart of the
    reference's ``jax_profile``) and the optional stdlib scrape endpoint
    (``--metrics-port``).
"""
from repro_torch.serving.observability.httpd import (BackgroundHTTPServer,
                                                     MetricsServer, QuietHandler,
                                                     parse_hostport)
from repro_torch.serving.observability.profiler import (annotate, profile,
                                                       step_annotation)
from repro_torch.serving.observability.registry import (FRACTION_BUCKETS,
                                                        LATENCY_BUCKETS,
                                                        PROMETHEUS_CONTENT_TYPE,
                                                        Counter, Gauge, Histogram,
                                                        MetricsRegistry)
from repro_torch.serving.observability.tracing import (PROC_ENGINE, PROC_REQUESTS,
                                                       Span, Tracer, iter_tree,
                                                       pipeline_overlaps,
                                                       span_tree,
                                                       validate_chrome_trace)

__all__ = [
    "Span", "Tracer", "span_tree", "iter_tree", "pipeline_overlaps",
    "validate_chrome_trace", "PROC_REQUESTS", "PROC_ENGINE",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS", "FRACTION_BUCKETS", "PROMETHEUS_CONTENT_TYPE",
    "MetricsServer", "BackgroundHTTPServer", "QuietHandler",
    "parse_hostport", "annotate", "step_annotation", "profile",
]
