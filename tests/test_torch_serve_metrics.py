"""The port's serving metrics (``fed_tgan_torch/serve/metrics.py`` over
``fed_tgan_torch/obs/registry.py``) against the JAX package's: the same
sequence of ``record_*`` calls gives equal ``snapshot()`` dicts and equal
Prometheus text, apart from the values that read the clock (uptime and
rows per second).
"""

import re

import pytest

from fed_tgan_torch.obs.registry import MetricsRegistry
from fed_tgan_torch.serve import metrics as port
from fed_tgan_tpu.obs.registry import MetricsRegistry as JaxRegistry
from fed_tgan_tpu.serve import metrics as jax_metrics

CLOCK_KEYS = ("uptime_s", "rows_per_sec")
CLOCK_LINE = re.compile(r"(uptime_s|rows_per_sec)")


def without_clock(obj):
    if isinstance(obj, dict):
        return {k: without_clock(v) for k, v in obj.items()
                if k not in CLOCK_KEYS}
    return obj


def text_without_clock(text: str) -> list:
    return [line for line in text.splitlines()
            if not CLOCK_LINE.search(line)]


def drive_service(m):
    m.record_batch(3)
    for lat, rows in ((0.010, 100), (0.020, 250), (0.031, 7)):
        m.record_request(lat, rows=rows)
    m.record_shed()
    m.record_shed()
    m.record_error()
    m.record_reload()
    m.set_queue_depth(5)
    m.record_stages({"queue_wait": 0.001, "batch_form": 0.002,
                     "dispatch": 0.0125, "decode": 0.004,
                     "serialize": 0.0061, "not_a_stage": 1.0})
    m.record_stages({"dispatch": 0.02})
    m.record_batch(1)


def drive_fleet(m):
    m.record_batch(4)
    m.record_lane_dispatch(3)
    m.set_lanes_occupied(3)
    for tenant, lat, rows in (("alpha", 0.012, 500), ("beta", 0.2, 40),
                              ("alpha", 0.03, 5000), ("gamma", 2.5, 1)):
        m.record_request(tenant, lat, rows)
    m.record_pool_hit("beta", 0.0004, 128)
    m.record_shed("alpha", "quota")
    m.record_shed("gamma", "capacity")
    m.record_shed("gamma", "capacity")
    m.record_error("beta")
    m.record_reload("gamma")
    m.record_stages("alpha", {"queue_wait": 0.0, "dispatch": 0.011,
                              "serialize": 0.003})
    m.record_stages("gamma", {"decode": 0.07})
    m.set_queue_depth(9)
    m.set_fleet_state(3, {"entries": 2, "bytes": 4096, "hits": 7,
                          "misses": 2, "evictions": 1})
    m.set_pool_state({"keys": 1, "chunks": 4, "rows": 8192, "hits": 3,
                      "misses": 5, "fills": 4, "evictions": 0})


@pytest.mark.parametrize("queue_depth", [0, 7])
def test_service_metrics_equal_jax(queue_depth):
    ours, theirs = port.ServiceMetrics(), jax_metrics.ServiceMetrics()
    drive_service(ours)
    drive_service(theirs)
    assert without_clock(ours.snapshot(queue_depth)) == \
        without_clock(theirs.snapshot(queue_depth))
    assert ours.stage_snapshot() == theirs.stage_snapshot()
    assert text_without_clock(ours.render_prometheus(queue_depth)) == \
        text_without_clock(theirs.render_prometheus(queue_depth))
    for name in ("requests_total", "rows_total", "batches_total",
                 "shed_total", "errors_total", "reloads_total"):
        assert getattr(ours, name) == getattr(theirs, name)


@pytest.mark.parametrize("queue_depth", [0, 3])
def test_fleet_metrics_equal_jax(queue_depth):
    ours, theirs = port.FleetMetrics(), jax_metrics.FleetMetrics()
    drive_fleet(ours)
    drive_fleet(theirs)
    assert without_clock(ours.snapshot(queue_depth)) == \
        without_clock(theirs.snapshot(queue_depth))
    assert ours.stage_snapshots() == theirs.stage_snapshots()
    for tenant in ("alpha", "beta", "gamma"):
        assert ours.tenant_snapshot(tenant) == theirs.tenant_snapshot(tenant)
    assert text_without_clock(ours.render_prometheus(queue_depth)) == \
        text_without_clock(theirs.render_prometheus(queue_depth))


def test_empty_metrics_equal_jax():
    assert without_clock(port.FleetMetrics().snapshot()) == \
        without_clock(jax_metrics.FleetMetrics().snapshot())
    assert text_without_clock(port.ServiceMetrics().render_prometheus()) == \
        text_without_clock(jax_metrics.ServiceMetrics().render_prometheus())


def test_registry_text_equals_jax():
    def drive(reg):
        reg.counter("a_total", "as").inc(3)
        reg.counter("a_total", "as", labels={"t": "x"}).inc()
        reg.gauge("g", "a gauge").set(2.5)
        h = reg.histogram("h_seconds", "hist", buckets=(0.1, 1.0),
                          labels={"t": "y"})
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        with pytest.raises(TypeError):
            reg.gauge("a_total")
        return reg

    ours, theirs = drive(MetricsRegistry()), drive(JaxRegistry())
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.snapshot() == theirs.snapshot()
    assert ours.names() == theirs.names()


def test_drain_rate_equal_jax(monkeypatch):
    clock = iter([10.0, 10.5, 11.0, 11.25])
    monkeypatch.setattr(port.time, "monotonic", lambda: next(clock))
    ours = port.DrainRate()
    ours.note(4)
    ours.note(2)
    ours.note(5)
    clock = iter([10.0, 10.5, 11.0, 11.25])
    monkeypatch.setattr(jax_metrics.time, "monotonic", lambda: next(clock))
    theirs = jax_metrics.DrainRate()
    theirs.note(4)
    theirs.note(2)
    theirs.note(5)
    assert ours.rate() == theirs.rate()
