"""Serving observability: the counters behind ``/healthz`` and
``/metrics`` (counterpart of ``fed_tgan_tpu/serve/metrics.py``:
``DrainRate`` ``:34``, ``QualityStore`` ``:62``, ``ServiceMetrics``
``:147``, ``FleetMetrics`` ``:300``).

The series names, labels, snapshot keys and Prometheus text are the JAX
package's, so a dashboard reads either service.  Thread-safe: the HTTP
threads record sheds, the batch workers completions; locking lives in the
:mod:`fed_tgan_torch.obs.registry` metric types.  Latency quantiles come
from a histogram's bounded reservoir of the most recent requests.  The
canary's per-tenant quality series (:class:`QualityStore`,
``fed_tgan_quality_*``) appear in both services' text only after a
promotion decision, so immediate mode's text is unchanged.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from fed_tgan_torch.obs.registry import MetricsRegistry

#: request lifecycle stages, in order.  ``queue_wait`` = enqueue ->
#: popped by the worker; ``batch_form`` = popped -> this request's own
#: processing starts (absorbs the wait behind earlier batch members, so
#: the five stages sum to ~the full server-side latency); ``dispatch``
#: = device program dispatch + host harvest; ``decode`` = inverse
#: feature transform; ``serialize`` = CSV bytes.
STAGES = ("queue_wait", "batch_form", "dispatch", "decode", "serialize")


class DrainRate:
    """Aggregate worker drain rate (requests/second), EWMA-smoothed.

    Every batch worker notes each batch it completes; the sample interval
    is measured between consecutive notes from ANY worker, so the
    estimate reflects the service's combined drain rate and scales with
    the worker count — the 503 Retry-After hint divides queue depth by
    this instead of assuming one worker's throughput."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rate = 0.0
        self._t = time.monotonic()

    def note(self, n_requests: int) -> None:
        now = time.monotonic()
        with self._lock:
            dt = max(now - self._t, 1e-6)
            self._t = now
            sample = n_requests / dt
            self._rate = sample if self._rate <= 0.0 \
                else 0.2 * sample + 0.8 * self._rate

    def rate(self) -> float:
        with self._lock:
            return self._rate


class QualityStore:
    """Per-tenant canary quality behind ``/metrics``: the latest scored
    candidate's Avg_JSD and Avg_WD and the promotion and rejection
    counts.  The series have fixed names, ``fed_tgan_quality_{jsd,wd}``
    and ``fed_tgan_quality_{promotions,rejections}_total`` labelled by
    tenant, whichever service exports them."""

    def __init__(self):
        # re-entrant: _state takes it again under the recording methods
        self._lock = threading.RLock()
        self._tenants: dict = {}  # tenant -> state dict

    def _state(self, tenant: str) -> dict:
        with self._lock:
            state = self._tenants.get(tenant)
            if state is None:
                state = {"avg_jsd": None, "avg_wd": None,
                         "promotions": 0, "rejections": 0}
                self._tenants[tenant] = state
            return state

    def record_scores(self, tenant: str, avg_jsd, avg_wd) -> None:
        """The latest shadow-scored candidate quality of ``tenant``."""
        if avg_jsd is None or avg_wd is None:
            return
        with self._lock:
            state = self._state(tenant)
            state["avg_jsd"] = float(avg_jsd)
            state["avg_wd"] = float(avg_wd)

    def record_decision(self, tenant: str, promoted: bool) -> None:
        with self._lock:
            state = self._state(tenant)
            state["promotions" if promoted else "rejections"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {tenant: dict(state)
                    for tenant, state in sorted(self._tenants.items())}

    def render_prometheus(self) -> str:
        """The per-tenant quality series; ``""`` while no decision has
        been recorded."""
        snap = self.snapshot()
        if not snap:
            return ""
        lines = []
        for key, kind in (("jsd", "gauge"), ("wd", "gauge"),
                          ("promotions_total", "counter"),
                          ("rejections_total", "counter")):
            field = {"jsd": "avg_jsd", "wd": "avg_wd"}.get(key, key[:-6])
            series = [(t, s[field]) for t, s in snap.items()
                      if s[field] is not None]
            if not series:
                continue
            lines.append(f"# TYPE fed_tgan_quality_{key} {kind}")
            lines.extend(f'fed_tgan_quality_{key}{{tenant="{t}"}} {v:g}'
                         for t, v in series)
        return "\n".join(lines) + "\n" if lines else ""


def _quantile(sorted_vals: list, q: float) -> float:
    """Nearest-rank quantile on an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _stage_stats(hist) -> dict:
    vals = hist.reservoir_values()
    return {
        "count": int(hist.count),
        "p50_ms": round(_quantile(vals, 0.50) * 1e3, 2),
        "p99_ms": round(_quantile(vals, 0.99) * 1e3, 2),
    }


class ServiceMetrics:
    """Request/batch counters for one :class:`~.service.SamplingService`.

    Each instance owns an isolated :class:`MetricsRegistry` by default
    (one service = one scrape target); pass ``registry=`` to publish
    into a shared one instead.
    """

    def __init__(self, reservoir: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.started_at = time.time()
        self._requests = self.registry.counter(
            "requests_total", "sampling requests answered")
        self._rows = self.registry.counter(
            "rows_total", "synthetic rows returned")
        self._batches = self.registry.counter(
            "batches_total", "worker micro-batches executed")
        self._shed = self.registry.counter(
            "shed_total", "requests shed at admission")
        self._errors = self.registry.counter(
            "errors_total", "requests failed")
        self._reloads = self.registry.counter(
            "reloads_total", "model hot reloads")
        # seconds, enqueue -> response ready
        self._latency = self.registry.histogram(
            "latency_seconds", "request latency (s)", reservoir=reservoir)
        # the queue-depth gauge the module docstring always advertised:
        # sampled by the batch worker each cycle, scrape-time fallback
        # in snapshot() keeps the pre-gauge callers working
        self._queue_depth = self.registry.gauge(
            "queue_depth", "requests parked in the admission queue")
        # per-stage latency attribution (seconds): one labeled series
        # per lifecycle stage, same exact-quantile reservoir contract
        # as the end-to-end histogram
        self._stages = {
            stage: self.registry.histogram(
                "stage_seconds", "request stage latency (s)",
                reservoir=reservoir, labels={"stage": stage})
            for stage in STAGES
        }
        # canary promotion state: empty, and absent from every export,
        # unless a gate records into it
        self.quality = QualityStore()

    # ------------------------------------------------- attribute compat
    # pre-registry callers read these as plain ints

    @property
    def requests_total(self) -> int:
        return int(self._requests.value)

    @property
    def rows_total(self) -> int:
        return int(self._rows.value)

    @property
    def batches_total(self) -> int:
        return int(self._batches.value)

    @property
    def shed_total(self) -> int:
        return int(self._shed.value)

    @property
    def errors_total(self) -> int:
        return int(self._errors.value)

    @property
    def reloads_total(self) -> int:
        return int(self._reloads.value)

    # ---------------------------------------------------------- record

    def record_batch(self, n_requests: int) -> None:
        self._batches.inc()

    def record_request(self, latency_s: float, rows: int) -> None:
        self._requests.inc()
        self._rows.inc(rows)
        self._latency.observe(latency_s)

    def record_shed(self) -> None:
        self._shed.inc()

    def record_error(self) -> None:
        self._errors.inc()

    def record_reload(self) -> None:
        self._reloads.inc()

    def record_stages(self, stages: dict) -> None:
        """Observe one request's per-stage seconds ({stage: s})."""
        for stage, seconds in stages.items():
            hist = self._stages.get(stage)
            if hist is not None:
                hist.observe(seconds)

    def set_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(int(depth))

    # --------------------------------------------------------- export

    def stage_snapshot(self) -> dict:
        """{stage: {count, p50_ms, p99_ms}} for stages with data."""
        return {stage: _stage_stats(hist)
                for stage, hist in self._stages.items() if hist.count}

    def snapshot(self, queue_depth: int = 0) -> dict:
        lat = self._latency.reservoir_values()
        uptime = max(time.time() - self.started_at, 1e-9)
        requests = self.requests_total
        rows = self.rows_total
        batches = self.batches_total
        return {
            "uptime_s": round(uptime, 3),
            "requests_total": requests,
            "rows_total": rows,
            "batches_total": batches,
            "shed_total": self.shed_total,
            "errors_total": self.errors_total,
            "reloads_total": self.reloads_total,
            "queue_depth": queue_depth,
            # requests coalesced per worker cycle; > 1 means
            # micro-batching is actually kicking in under load
            "batch_occupancy": round(requests / batches, 3)
            if batches else 0.0,
            "rows_per_sec": round(rows / uptime, 1),
            "latency_p50_ms": round(_quantile(lat, 0.50) * 1e3, 2),
            "latency_p99_ms": round(_quantile(lat, 0.99) * 1e3, 2),
        }

    def render_prometheus(self, queue_depth: int = 0,
                          prefix: str = "fed_tgan_serving") -> str:
        snap = self.snapshot(queue_depth)
        lines = []
        for key, value in snap.items():
            kind = "counter" if key.endswith("_total") else "gauge"
            lines.append(f"# TYPE {prefix}_{key} {kind}")
            lines.append(f"{prefix}_{key} {value}")
        stages = self.stage_snapshot()
        if stages:
            lines.append(f"# TYPE {prefix}_stage_p99_ms gauge")
            for stage, st in stages.items():
                lines.append(f'{prefix}_stage_p99_ms{{stage="{stage}"}} '
                             f"{st['p99_ms']}")
            lines.append(f"# TYPE {prefix}_stage_p50_ms gauge")
            for stage, st in stages.items():
                lines.append(f'{prefix}_stage_p50_ms{{stage="{stage}"}} '
                             f"{st['p50_ms']}")
        return "\n".join(lines) + "\n" + self.quality.render_prometheus()


class FleetMetrics:
    """Per-tenant labeled counters for one :class:`~.fleet.FleetService`.

    Every request-path metric carries a ``tenant`` label (one series per
    tenant on a shared base name, through the registry's labels), so
    a single ``/metrics`` scrape separates the tenants; sheds addition-
    ally carry ``reason`` ∈ {quota, capacity} — the 429/503 split is an
    admission contract and the metric must be able to prove which side
    fired.  Fleet-level gauges (cache occupancy, tenant count) are
    pushed in at scrape time from the lane cache's own stats.
    """

    #: per-tenant latency buckets: serving answers in ms-to-seconds
    LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                       0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, reservoir: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.started_at = time.time()
        self.reservoir = int(reservoir)
        self._tenants: dict = {}   # name -> per-tenant metric bundle
        self._tlock = threading.Lock()
        self._batches = self.registry.counter(
            "batches_total", "worker micro-batches executed")
        self._lane_dispatches = self.registry.counter(
            "lane_dispatches_total",
            "coalesced multi-tenant device dispatches")
        self._lane_requests = self.registry.counter(
            "lane_requests_total",
            "requests answered via a coalesced lane dispatch")
        self._cache_entries = self.registry.gauge(
            "program_cache_entries", "compiled programs held by the LRU")
        self._cache_bytes = self.registry.gauge(
            "program_cache_bytes", "estimated bytes held by the LRU")
        self._cache_hits = self.registry.gauge(
            "program_cache_hits_total", "LRU lookups served from cache")
        self._cache_misses = self.registry.gauge(
            "program_cache_misses_total", "LRU lookups that built")
        self._cache_evictions = self.registry.gauge(
            "program_cache_evictions_total", "LRU entries evicted")
        self._tenant_gauge = self.registry.gauge(
            "tenants", "tenant models currently hot")
        self._queue_depth = self.registry.gauge(
            "queue_depth", "requests parked in the admission queue")
        self._lanes_occupied = self.registry.gauge(
            "lanes_occupied",
            "lanes filled by the most recent coalesced dispatch")
        # row-pool gauges (all zero when no pool is configured): pushed
        # at scrape time from RowPool.stats(), same pattern as the LRU
        self._pool_gauges = {
            key: self.registry.gauge(
                f"row_pool_{key}", f"row pool {key.replace('_', ' ')}")
            for key in ("keys", "chunks", "rows", "hits", "misses",
                        "fills", "evictions")
        }
        # canary promotion state, the same fixed-name series as the
        # single-model service's
        self.quality = QualityStore()

    def _bundle(self, tenant: str) -> dict:
        with self._tlock:
            b = self._tenants.get(tenant)
            if b is None:
                lab = {"tenant": tenant}
                reg = self.registry
                b = {
                    "requests": reg.counter(
                        "requests_total", "sampling requests answered",
                        labels=lab),
                    "rows": reg.counter(
                        "rows_total", "synthetic rows returned", labels=lab),
                    "errors": reg.counter(
                        "errors_total", "requests failed", labels=lab),
                    "reloads": reg.counter(
                        "reloads_total", "model hot reloads", labels=lab),
                    "pool_hits": reg.counter(
                        "pool_hits_total",
                        "requests answered from the row pool", labels=lab),
                    "shed_quota": reg.counter(
                        "shed_total", "requests shed at admission",
                        labels={"tenant": tenant, "reason": "quota"}),
                    "shed_capacity": reg.counter(
                        "shed_total", "requests shed at admission",
                        labels={"tenant": tenant, "reason": "capacity"}),
                    "latency": reg.histogram(
                        "latency_seconds", "request latency (s)",
                        buckets=self.LATENCY_BUCKETS,
                        reservoir=self.reservoir, labels=lab),
                    "stages": {
                        stage: reg.histogram(
                            "stage_seconds", "request stage latency (s)",
                            buckets=self.LATENCY_BUCKETS,
                            reservoir=self.reservoir,
                            labels={"tenant": tenant, "stage": stage})
                        for stage in STAGES
                    },
                }
                self._tenants[tenant] = b
            return b

    # ---------------------------------------------------------- record

    def record_batch(self, n_requests: int) -> None:
        self._batches.inc()

    def record_lane_dispatch(self, n_requests: int) -> None:
        self._lane_dispatches.inc()
        self._lane_requests.inc(n_requests)

    def record_request(self, tenant: str, latency_s: float,
                       rows: int) -> None:
        b = self._bundle(tenant)
        b["requests"].inc()
        b["rows"].inc(rows)
        b["latency"].observe(latency_s)

    def record_pool_hit(self, tenant: str, latency_s: float,
                        rows: int) -> None:
        """A request answered from the row pool — it still counts as a
        served request (the rows/s figure and the quota math see it),
        but it never reaches a worker batch, so occupancy excludes it."""
        b = self._bundle(tenant)
        b["requests"].inc()
        b["rows"].inc(rows)
        b["pool_hits"].inc()
        b["latency"].observe(latency_s)

    def record_shed(self, tenant: str, reason: str) -> None:
        b = self._bundle(tenant)
        b["shed_quota" if reason == "quota" else "shed_capacity"].inc()

    def record_error(self, tenant: str) -> None:
        self._bundle(tenant)["errors"].inc()

    def record_reload(self, tenant: str) -> None:
        self._bundle(tenant)["reloads"].inc()

    def record_stages(self, tenant: str, stages: dict) -> None:
        """Observe one request's per-stage seconds for ``tenant``."""
        hists = self._bundle(tenant)["stages"]
        for stage, seconds in stages.items():
            hist = hists.get(stage)
            if hist is not None:
                hist.observe(seconds)

    def set_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(int(depth))

    def set_lanes_occupied(self, lanes: int) -> None:
        self._lanes_occupied.set(int(lanes))

    def set_fleet_state(self, n_tenants: int, cache_stats: dict) -> None:
        self._tenant_gauge.set(n_tenants)
        self._cache_entries.set(cache_stats.get("entries", 0))
        self._cache_bytes.set(cache_stats.get("bytes", 0))
        self._cache_hits.set(cache_stats.get("hits", 0))
        self._cache_misses.set(cache_stats.get("misses", 0))
        self._cache_evictions.set(cache_stats.get("evictions", 0))

    def set_pool_state(self, pool_stats: Optional[dict]) -> None:
        for key, gauge in self._pool_gauges.items():
            gauge.set(int((pool_stats or {}).get(key, 0)))

    # --------------------------------------------------------- export

    def stage_snapshots(self) -> dict:
        """{tenant: {stage: {count, p50_ms, p99_ms}}}, tenants with data."""
        with self._tlock:
            bundles = dict(self._tenants)
        out = {}
        for tenant, b in sorted(bundles.items()):
            stages = {stage: _stage_stats(hist)
                      for stage, hist in b["stages"].items() if hist.count}
            if stages:
                out[tenant] = stages
        return out

    def tenant_snapshot(self, tenant: str) -> dict:
        b = self._bundle(tenant)
        lat = b["latency"].reservoir_values()
        stages = {stage: _stage_stats(hist)
                  for stage, hist in b["stages"].items() if hist.count}
        extra = {"stages": stages} if stages else {}
        return {
            **extra,
            "requests_total": int(b["requests"].value),
            "rows_total": int(b["rows"].value),
            "pool_hits_total": int(b["pool_hits"].value),
            "errors_total": int(b["errors"].value),
            "reloads_total": int(b["reloads"].value),
            "shed_quota_total": int(b["shed_quota"].value),
            "shed_capacity_total": int(b["shed_capacity"].value),
            "latency_p50_ms": round(_quantile(lat, 0.50) * 1e3, 2),
            "latency_p99_ms": round(_quantile(lat, 0.99) * 1e3, 2),
        }

    def snapshot(self, queue_depth: int = 0) -> dict:
        with self._tlock:
            names = sorted(self._tenants)
        per_tenant = {name: self.tenant_snapshot(name) for name in names}
        uptime = max(time.time() - self.started_at, 1e-9)
        requests = sum(t["requests_total"] for t in per_tenant.values())
        rows = sum(t["rows_total"] for t in per_tenant.values())
        pool_hits = sum(t["pool_hits_total"] for t in per_tenant.values())
        batches = int(self._batches.value)
        # occupancy is a property of the DISPATCHED path: pool hits never
        # form a batch, so they are excluded from the numerator — a high
        # hit rate cannot mask a starved coalescer
        dispatched = requests - pool_hits
        return {
            "uptime_s": round(uptime, 3),
            "requests_total": requests,
            "rows_total": rows,
            "pool_hits_total": pool_hits,
            "batches_total": batches,
            "lane_dispatches_total": int(self._lane_dispatches.value),
            "lane_requests_total": int(self._lane_requests.value),
            "queue_depth": queue_depth,
            "lanes_occupied": int(self._lanes_occupied.value),
            "batch_occupancy": round(dispatched / batches, 3)
            if batches else 0.0,
            "rows_per_sec": round(rows / uptime, 1),
            "tenants": per_tenant,
        }

    def render_prometheus(self, queue_depth: int = 0,
                          prefix: str = "fed_tgan_fleet") -> str:
        # the registry already renders every labeled series; add the two
        # queue/uptime gauges the registry doesn't own
        head = (f"# TYPE {prefix}_queue_depth gauge\n"
                f"{prefix}_queue_depth {queue_depth}\n"
                f"# TYPE {prefix}_uptime_s gauge\n"
                f"{prefix}_uptime_s "
                f"{max(time.time() - self.started_at, 0.0):g}\n")
        return (head + self.registry.render_prometheus()
                + self.quality.render_prometheus())
