"""Observability of the port: metrics registry, span tracing, run journal
and the live exporter (counterpart of ``fed_tgan_tpu/obs/__init__.py``).

- :mod:`.registry` -- process-wide, thread-safe metrics (counters /
  gauges / histograms) in Prometheus text exposition; the serving layer
  keeps isolated registries of its own.
- :mod:`.trace` -- ``span(name, **attrs)`` host-side span tracing with a
  Chrome-trace exporter; while a device trace runs
  (``runtime/profiling.py``) every span is a ``torch.profiler`` range
  too, so host phases sit on the card's timeline.
- :mod:`.journal` -- a durable per-run JSONL event stream on the JAX
  package's schema (``schema.json``), summarized by ``python -m
  fed_tgan_torch.obs report <journal>...``.
- :mod:`.exporter` -- the live plane: an opt-in in-trainer HTTP exporter
  (``--obs-port``) serving ``/metrics``, ``/healthz`` and the journal as
  tailable NDJSON, watched live by ``python -m fed_tgan_torch.obs watch``.

Everything here except :mod:`.ledger` is pure stdlib and imports neither
torch nor numpy, so ``python -m fed_tgan_torch.obs report|slo|watch``
runs on a host that has only Python.  ``span`` and ``emit`` touch only
host clocks and Python objects, never a device tensor, so they add no
device-to-host copy and no synchronisation.
"""

from __future__ import annotations

from fed_tgan_torch.obs.exporter import (
    HealthState,
    TelemetryExporter,
    get_health,
)
from fed_tgan_torch.obs.journal import (
    RunJournal,
    emit,
    get_journal,
    read_journal,
    set_journal,
)
from fed_tgan_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from fed_tgan_torch.obs.trace import (
    Tracer,
    current_tracer,
    span,
    start_tracing,
    stop_tracing,
)

__all__ = [
    "Counter",
    "Gauge",
    "HealthState",
    "Histogram",
    "MetricsRegistry",
    "RunJournal",
    "TelemetryExporter",
    "Tracer",
    "current_tracer",
    "emit",
    "get_health",
    "get_journal",
    "get_registry",
    "read_journal",
    "set_journal",
    "span",
    "start_tracing",
    "stop_tracing",
]
