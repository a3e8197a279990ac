"""A small thread-safe metrics registry with Prometheus text-format and
JSON exposition — zero dependencies, stdlib only.

Three instrument kinds, all labeled:

  * ``Counter`` — monotonically non-decreasing totals (requests served,
    compiles, admission verdicts, driver errors);
  * ``Gauge``   — set/inc/dec point-in-time values (queue depth, in-flight
    ring occupancy, lazy-distogram pinned bytes);
  * ``Histogram`` — cumulative-bucket distributions with ``_sum``/
    ``_count`` (queue-wait/run latency seconds, batch occupancy).

``MetricsRegistry.prometheus_text()`` renders the whole registry in the
Prometheus exposition format (text/plain; version=0.0.4) — exactly what a
scrape endpoint serves and what a multi-replica fleet router federates;
``as_dict()`` is the same data as JSON-ready structures.

One lock per registry guards every series mutation: the background driver
records batch results while cancel/expiry paths record from other threads
and a scrape renders concurrently — all three interleave safely.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Iterable

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default latency buckets (seconds): sub-ms dispatch turns through
#: multi-second cold compiles
LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
#: occupancy/fraction buckets: [0, 1] in tenths
FRACTION_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def _escape_label(v: object) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_key(labelnames: tuple[str, ...], labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(f"labels {sorted(labels)} != declared "
                         f"{sorted(labelnames)}")
    return tuple(str(labels[k]) for k in labelnames)


def _render_labels(labelnames: tuple[str, ...], key: tuple,
                   extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"'
             for n, v in list(zip(labelnames, key)) + list(extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Iterable[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self._registry = registry
        self._lock = registry._lock
        self._series: dict[tuple, float] = {}

    # -- exposition -------------------------------------------------------
    def _header(self) -> list[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.kind}"]

    def _const(self) -> tuple[tuple[str, str], ...]:
        return self._registry.const_labels

    def _sample_lines(self) -> list[str]:
        return [f"{self.name}"
                f"{_render_labels(self.labelnames, key, self._const())}"
                f" {_fmt(v)}"
                for key, v in sorted(self._series.items())]

    def _as_dict(self) -> dict:
        const = dict(self._const())
        return {
            "kind": self.kind, "help": self.help,
            "labelnames": list(self.labelnames),
            "series": [{"labels": {**dict(zip(self.labelnames, key)),
                                   **const},
                        "value": v}
                       for key, v in sorted(self._series.items())],
        }

    # -- reads ------------------------------------------------------------
    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(
                _labels_key(self.labelnames, labels), 0.0)

    def total(self) -> float:
        """Sum over every labeled series (counters/gauges)."""
        with self._lock:
            return sum(self._series.values())


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, "
                             f"got {amount}")
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_labels_key(self.labelnames, labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames=(), *,
                 buckets: Iterable[float] = LATENCY_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        # per label-key: [per-bucket counts..., +Inf count], sum
        self._hist: dict[tuple, tuple[list[int], float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _labels_key(self.labelnames, labels)
        with self._lock:
            counts, total = self._hist.get(
                key, ([0] * (len(self.buckets) + 1), 0.0))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._hist[key] = (counts, total + value)

    def count(self, **labels) -> int:
        with self._lock:
            counts, _ = self._hist.get(
                _labels_key(self.labelnames, labels), ([0], 0.0))
            return sum(counts)

    def _sample_lines(self) -> list[str]:
        const = self._const()
        lines = []
        for key, (counts, total) in sorted(self._hist.items()):
            cum = 0
            for bound, n in zip(self.buckets, counts):
                cum += n
                lines.append(
                    f"{self.name}_bucket"
                    f"{_render_labels(self.labelnames, key, const + (('le', _fmt(bound)),))}"
                    f" {cum}")
            cum += counts[-1]
            lines.append(
                f"{self.name}_bucket"
                f"{_render_labels(self.labelnames, key, const + (('le', '+Inf'),))}"
                f" {cum}")
            lines.append(f"{self.name}_sum"
                         f"{_render_labels(self.labelnames, key, const)}"
                         f" {_fmt(total)}")
            lines.append(f"{self.name}_count"
                         f"{_render_labels(self.labelnames, key, const)}"
                         f" {cum}")
        return lines

    def _as_dict(self) -> dict:
        const = dict(self._const())
        return {
            "kind": self.kind, "help": self.help,
            "labelnames": list(self.labelnames),
            "buckets": list(self.buckets),
            "series": [{"labels": {**dict(zip(self.labelnames, key)),
                                   **const},
                        "counts": list(counts), "sum": total,
                        "count": sum(counts)}
                       for key, (counts, total)
                       in sorted(self._hist.items())],
        }


class MetricsRegistry:
    """Named metrics, get-or-create semantics (re-registering the same
    name with the same kind returns the existing instrument; a kind or
    label mismatch is a programming error and raises).

    ``const_labels`` stamps every rendered sample with fixed labels —
    the multi-workload serving substrate marks each engine's registry
    with its workload (``{"workload": "lm"}``).  Opt-in: the default is
    no const labels and byte-identical exposition to an unlabeled
    registry, so existing ``fold_*`` scrapes/dashboards are unaffected.
    """

    def __init__(self, const_labels: dict[str, str] | None = None):
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}
        for ln in (const_labels or {}):
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid const label name {ln!r}")
        self.const_labels: tuple[tuple[str, str], ...] = tuple(
            sorted((const_labels or {}).items()))

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) \
                        or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}")
                return existing
            m = cls(self, name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, tuple(labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, tuple(labelnames))

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (), *,
                  buckets: Iterable[float] = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, tuple(labelnames),
                                   buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    # -- exposition -------------------------------------------------------
    def prometheus_text(self) -> str:
        """The full registry in Prometheus text exposition format
        (text/plain; version=0.0.4), metrics sorted by name."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
            lines: list[str] = []
            for m in metrics:
                lines.extend(m._header())
                lines.extend(m._sample_lines())
        return "\n".join(lines) + "\n"

    def as_dict(self) -> dict:
        with self._lock:
            return {name: self._metrics[name]._as_dict()
                    for name in sorted(self._metrics)}


#: content type a scrape endpoint should serve ``prometheus_text`` under
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
