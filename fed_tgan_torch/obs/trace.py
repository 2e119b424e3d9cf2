"""Host-side span tracing with Chrome-trace / Perfetto JSON export
(counterpart of ``fed_tgan_tpu/obs/trace.py:38-170``).

``span(name, **attrs)`` is the one instrumentation point: a context
manager that records a complete ("X") event -- name, start, duration,
thread, nesting depth -- into the installed :class:`Tracer`.  With no
tracer installed and no device trace running it is a near-free no-op
(two global reads), so instrumented code pays nothing outside profiled
runs.

While a device trace is running
(:func:`fed_tgan_torch.runtime.profiling.device_trace`), ``span`` also
opens a ``torch.profiler.record_function`` range of the same name, so
the host phases sit on the card's timeline in the profiler's own Chrome
trace.  torch is imported only then: this module stays stdlib-only.

Spans touch only ``time.perf_counter`` and Python objects, never a
device tensor, so tracing adds no device-to-host copy and no
synchronisation.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "Tracer",
    "current_tracer",
    "record_span",
    "span",
    "start_tracing",
    "stop_tracing",
]


class Tracer:
    """Bounded in-memory trace-event collector."""

    def __init__(self, max_events: int = 200_000) -> None:
        self.max_events = int(max_events)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._local = threading.local()
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

    # ------------------------------------------------------------ record

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def _record(self, event: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(event)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record a complete event covering the with-block."""
        depth = self._depth()
        self._local.depth = depth + 1
        start = self._now_us()
        try:
            yield self
        finally:
            dur = self._now_us() - start
            self._local.depth = depth
            args: Dict[str, object] = {"depth": depth}
            args.update(attrs)
            self._record({
                "name": name, "ph": "X", "ts": start, "dur": dur,
                "pid": self._pid, "tid": threading.get_ident(),
                "args": args,
            })

    def complete(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record a complete event for a phase timed by the caller
        between ``time.perf_counter()`` readings ``t0`` and ``t1``."""
        args: Dict[str, object] = {"depth": self._depth()}
        args.update(attrs)
        self._record({
            "name": name, "ph": "X", "ts": (t0 - self._t0) * 1e6,
            "dur": (t1 - t0) * 1e6, "pid": self._pid,
            "tid": threading.get_ident(), "args": args,
        })

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration instant event (scope: thread)."""
        self._record({
            "name": name, "ph": "i", "s": "t", "ts": self._now_us(),
            "pid": self._pid, "tid": threading.get_ident(),
            "args": dict(attrs),
        })

    # ------------------------------------------------------------ export

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = [{
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": "fed_tgan_torch host"},
        }]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path``; returns ``path``."""
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)
        return path

    def phase_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name attribution: ``{name: {count, total_ms, mean_ms}}``
        over every recorded occurrence of the name."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events():
            if ev.get("ph") != "X":
                continue
            rec = out.setdefault(ev["name"],
                                 {"count": 0.0, "total_ms": 0.0})
            rec["count"] += 1
            rec["total_ms"] += ev.get("dur", 0.0) / 1e3
        for rec in out.values():
            rec["mean_ms"] = rec["total_ms"] / max(1.0, rec["count"])
        return out


_INSTALL_LOCK = threading.Lock()
_TRACER: Optional[Tracer] = None
# running device traces (runtime/profiling.py::device_trace); while > 0,
# spans are profiler ranges too
_DEVICE_TRACES = 0


def start_tracing(max_events: int = 200_000) -> Tracer:
    """Install (or return the already-installed) process tracer."""
    global _TRACER
    with _INSTALL_LOCK:
        if _TRACER is None:
            _TRACER = Tracer(max_events=max_events)
        return _TRACER


def stop_tracing() -> Optional[Tracer]:
    """Uninstall and return the process tracer (None when inactive)."""
    global _TRACER
    with _INSTALL_LOCK:
        t, _TRACER = _TRACER, None
        return t


def current_tracer() -> Optional[Tracer]:
    return _TRACER


def _device_trace_started(delta: int) -> None:
    """Bookkeeping of :func:`~fed_tgan_torch.runtime.profiling.
    device_trace`: +1 when a trace starts, -1 when it stops."""
    global _DEVICE_TRACES
    with _INSTALL_LOCK:
        _DEVICE_TRACES += delta


def record_span(name: str, t0: float, t1: float, **attrs) -> None:
    """A span of a phase the caller timed itself (``perf_counter``
    readings), recorded into the installed tracer; no-op without one."""
    t = _TRACER
    if t is not None:
        t.complete(name, t0, t1, **attrs)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Span against the installed tracer, and a profiler range while a
    device trace runs; a free no-op when neither is."""
    t = _TRACER
    if t is None and not _DEVICE_TRACES:
        yield None
        return
    with contextlib.ExitStack() as stack:
        if _DEVICE_TRACES:
            from torch.profiler import record_function

            stack.enter_context(record_function(name))
        if t is not None:
            stack.enter_context(t.span(name, **attrs))
        yield t
