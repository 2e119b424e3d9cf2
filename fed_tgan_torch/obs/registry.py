"""Metrics registry: counters, gauges, histograms
(counterpart of ``fed_tgan_tpu/obs/registry.py:43-300``).

Pure stdlib and thread-safe.  The serving layer's
:class:`~fed_tgan_torch.serve.metrics.ServiceMetrics` and
:class:`~fed_tgan_torch.serve.metrics.FleetMetrics` each hold an isolated
:class:`MetricsRegistry` and render it in Prometheus text exposition
format, with the JAX package's series names and text.  The process-wide
default (:func:`get_registry`, also :data:`DEFAULT`) collects what the
trainer (rounds, chunks, quarantines, drops, and the per-client
``fed_tgan_client_weight`` / ``fed_tgan_client_strikes`` series of up to
64 clients), the checkpoints, the watchdog, the transport and the
journal's schema sanitizer publish; the exporter
(:mod:`fed_tgan_torch.obs.exporter`) serves it at ``/metrics``.

``counter()`` / ``gauge()`` / ``histogram()`` are get-or-create: the
same name (and labels) always returns the same object, and a name
collision across metric kinds raises ``TypeError``.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "DEFAULT",
    "counter",
    "gauge",
    "get_registry",
    "histogram",
]

#: default histogram bucket upper bounds (seconds-flavoured, like
#: Prometheus client defaults) -- override per-histogram for other units
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Counter:
    """Monotonically increasing value.  ``inc(amount)`` with amount >= 0."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Instantaneous value: ``set`` / ``inc`` / ``dec``."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Distribution: Prometheus cumulative buckets + an exact-quantile
    reservoir.

    The bucket counts / sum / count follow the Prometheus histogram
    exposition; the bounded ``reservoir`` (most recent N observations)
    additionally gives exact ``quantile()`` answers over the recent
    window -- the serving p50/p99 contract predates this registry and
    is preserved by it.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 reservoir: int = 4096) -> None:
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(sorted(set(buckets)))
        self._lock = threading.Lock()
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._count = 0
        self._sum = 0.0
        self._reservoir: deque = deque(maxlen=max(1, int(reservoir)))

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._bucket_counts[idx] += 1
            self._count += 1
            self._sum += value
            self._reservoir.append(value)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def reservoir_values(self) -> List[float]:
        """Sorted copy of the recent-observation reservoir."""
        with self._lock:
            return sorted(self._reservoir)

    def quantile(self, q: float) -> float:
        """Exact nearest-rank quantile over the reservoir window."""
        lat = self.reservoir_values()
        if not lat:
            return 0.0
        idx = min(len(lat) - 1, max(0, round(q * (len(lat) - 1))))
        return lat[idx]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            counts = list(self._bucket_counts)
            total, s = self._count, self._sum
        out: Dict[str, float] = {"count": total, "sum": s}
        cum = 0
        for le, n in zip(self.buckets, counts):
            cum += n
            out[f"le_{le:g}"] = cum
        return out


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _series_key(name: str, labels: Optional[dict]) -> str:
    """Prometheus series identity: ``name`` or ``name{k="v",...}`` with
    labels in sorted key order — the registry key AND the exposition
    form, so labeled lookups and rendering cannot disagree."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe, get-or-create registry of named metrics.

    Metrics may carry Prometheus labels (``labels={"tenant": "a"}``):
    each label set is its own series (own counter object), sharing the
    base name's HELP/TYPE header in the exposition.  Unlabeled metrics
    are keyed, snapshotted, and rendered exactly as before.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Optional[dict] = None, **kwargs):
        key = _series_key(name, labels)
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(
                        f"metric {key!r} already registered as "
                        f"{existing.kind}, requested {cls.kind}")
                return existing
            metric = cls(name, help=help, **kwargs)
            metric.labels = dict(labels) if labels else None
            metric.series = key
            self._metrics[key] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  reservoir: int = 4096,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets, reservoir=reservoir)

    def get(self, name: str) -> Optional[object]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """``{series: value-or-dict}`` for every registered metric (the
        series key is the bare name for unlabeled metrics)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {getattr(m, "series", m.name): m.snapshot() for m in metrics}

    def render_prometheus(self) -> str:
        """Prometheus text exposition of every registered metric.  Labeled
        series of one base name share a single HELP/TYPE header."""
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: (m.name, getattr(m, "series",
                                                            m.name)))
        lines: List[str] = []
        headered = set()
        for m in metrics:
            if m.name not in headered:
                headered.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            labels = getattr(m, "labels", None)
            inner = ",".join(f'{k}="{v}"' for k, v in
                             sorted((labels or {}).items()))
            if isinstance(m, Histogram):
                snap = m.snapshot()
                suffix = f"{{{inner}}}" if inner else ""

                def bucket_label(le: str) -> str:
                    return (f'{{{inner},le="{le}"}}' if inner
                            else f'{{le="{le}"}}')

                cum = 0.0
                for le in m.buckets:
                    cum = snap[f"le_{le:g}"]
                    lines.append(f"{m.name}_bucket{bucket_label(f'{le:g}')} "
                                 f"{cum:g}")
                lines.append(f"{m.name}_bucket{bucket_label('+Inf')} "
                             f"{snap['count']:g}")
                lines.append(f"{m.name}_sum{suffix} {snap['sum']:g}")
                lines.append(f"{m.name}_count{suffix} {snap['count']:g}")
            else:
                series = getattr(m, "series", m.name)
                lines.append(f"{series} {m.snapshot():g}")
        return "\n".join(lines) + "\n"


#: the process-wide registry every subsystem publishes into
DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return DEFAULT


def counter(name: str, help: str = "") -> Counter:
    """Get-or-create ``name`` in :data:`DEFAULT`."""
    return DEFAULT.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return DEFAULT.gauge(name, help)


def histogram(name: str, help: str = "", **kwargs) -> Histogram:
    return DEFAULT.histogram(name, help, **kwargs)
