"""The port's front door (``fed_tgan_torch/serve/frontdoor.py``), row
pool (``serve/pool.py``) and multi-worker pipeline on the CPU: the JAX
package's ``tests/test_frontdoor.py`` ported (its compile budget as the
lane groups' build budget, the whole module under an armed lockwatch).
Every byte served through the asyncio door, the workers, a lane dispatch
or a pool hit equals the single-model engine's.
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from fed_tgan_torch.serve.demo import build_random_artifact
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.fleet import (
    FleetRegistry,
    FleetService,
    ProgramCache,
    TokenBucket,
    _FleetRequest,
)
from fed_tgan_torch.serve.metrics import DrainRate
from fed_tgan_torch.serve.pool import RowPool
from fed_tgan_torch.serve.registry import ModelRegistry, open_model
from fed_tgan_torch.train.steps import TrainConfig

torch.set_num_threads(2)

SMALL = TrainConfig(embedding_dim=16, gen_dims=(32, 32), dis_dims=(32, 32),
                    batch_size=50)
_silent = lambda *a, **k: None  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def _lockwatch_armed():
    """Arm the runtime deadlock sanitizer for the whole module: every
    lock the front door allocates is watched, and any lock-order cycle
    or re-entry the tests drive fails the module at teardown."""
    from fed_tgan_torch.analysis import lockwatch

    with lockwatch.watch(on_deadlock="record"):
        yield
        bad = lockwatch.reports("cycle") + lockwatch.reports("reentry")
        assert bad == [], [r.detail for r in bad]


@pytest.fixture(scope="module")
def tenant_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_frontdoor")
    return {name: build_random_artifact(str(base / name), seed=seed,
                                        cfg=SMALL)
            for name, seed in (("alpha", 0), ("beta", 3))}


@pytest.fixture(scope="module")
def fleet(tenant_roots):
    reg = FleetRegistry(program_cache=ProgramCache(max_entries=16),
                        device="cpu", log=_silent)
    for name, root in tenant_roots.items():
        reg.load(name, root)
    return reg


@pytest.fixture(scope="module")
def async_service(fleet):
    """A 4-worker fleet behind the asyncio front door, with a row pool."""
    pool = RowPool(fleet, chunk_rows=128, hot_after=3,
                   fill_interval_s=0.005)
    svc = FleetService(fleet, port=0, max_batch=8, queue_size=64,
                       max_lanes=4, reload_interval_s=0, workers=4,
                       coalesce_window_s=0.002, row_pool=pool,
                       http_mode="asyncio", log=_silent).start()
    yield svc
    svc.shutdown(drain=False)


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _req(tenant, n=10, seed=0, offset=0):
    return _FleetRequest(tenant=tenant, n=n, seed=seed, offset=offset,
                         condition=None, header=True)


# -------------------------------------------- multi-worker byte identity


def test_multiworker_bytes_match_single_model_engine(async_service,
                                                     tenant_roots):
    """Bytes served by 4 concurrent workers through the asyncio door, lane
    dispatches and pool hits included, equal the single-model engine's."""
    want = {name: SamplingEngine(open_model(root, device="cpu"))
            .sample_csv_bytes(30, seed=5)
            for name, root in tenant_roots.items()}
    results, errors = {}, []

    def fetch(name, i):
        try:
            results[(name, i)] = _get(f"{async_service.url}/t/{name}/sample"
                                      "?rows=30&seed=5")
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            errors.append((name, exc))

    threads = [threading.Thread(target=fetch, args=(n, i))
               for n in tenant_roots for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for (name, _i), got in results.items():
        assert got == want[name]


def test_asyncio_chunked_offsets_equal_one_request(async_service):
    whole = _get(f"{async_service.url}/t/alpha/sample?rows=80&seed=11")
    first = _get(f"{async_service.url}/t/alpha/sample?rows=50&seed=11")
    rest = _get(f"{async_service.url}/t/alpha/sample"
                "?rows=30&seed=11&offset=50&header=0")
    assert first + rest == whole


def test_asyncio_routes_and_errors(async_service):
    health = json.loads(_get(f"{async_service.url}/healthz"))
    assert health["status"] == "ok"
    assert "batch_occupancy" in health
    metrics = _get(f"{async_service.url}/metrics").decode()
    assert "row_pool_hits" in metrics
    assert "fed_tgan_fleet_queue_depth" in metrics
    for path, want in [("/t/alpha/sample?rows=0", 400),
                       ("/t/alpha/sample?rows=5&offset=-1", 400),
                       ("/t/alpha/sample?rows=5&column=nope&value=x", 400),
                       ("/t/nobody/sample?rows=5", 404),
                       ("/nothing", 404)]:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{async_service.url}{path}")
        assert err.value.code == want


def test_asyncio_keep_alive_pipeline(async_service):
    """Several requests ride ONE persistent connection."""
    conn = http.client.HTTPConnection("127.0.0.1", async_service.port,
                                      timeout=60)
    try:
        bodies = []
        for i in range(3):
            conn.request("GET",
                         f"/t/alpha/sample?rows=5&seed=9&offset={5 * i}")
            resp = conn.getresponse()
            assert resp.status == 200
            bodies.append(resp.read())
        whole = _get(f"{async_service.url}/t/alpha/sample?rows=15&seed=9")
        assert bodies[0] + b"".join(
            b.partition(b"\n")[2] for b in bodies[1:]) == whole
    finally:
        conn.close()


def test_asyncio_post_admin_load_evict(async_service, tenant_roots):
    conn = http.client.HTTPConnection("127.0.0.1", async_service.port,
                                      timeout=60)
    try:
        body = json.dumps({"action": "load", "tenant": "delta",
                           "root": tenant_roots["alpha"]})
        conn.request("POST", "/fleet", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert json.loads(resp.read())["loaded"] == "delta"
        conn.request("POST", "/fleet",
                     body=json.dumps({"action": "evict", "tenant": "delta"}))
        resp = conn.getresponse()
        assert json.loads(resp.read())["evicted"] == "delta"
        conn.request("POST", "/fleet", body="not json{")
        resp = conn.getresponse()
        assert resp.status == 400
        resp.read()
    finally:
        conn.close()


# ------------------------------------------------------ occupancy seam


def test_occupancy_at_least_4_with_backlog(fleet):
    """A backlog enqueued before the workers start coalesces into full
    batches: 32 requests over 4 workers' shards form 4 batches of 8."""
    svc = FleetService(fleet, port=0, max_batch=8, queue_size=64,
                       max_lanes=4, reload_interval_s=0, workers=4,
                       log=_silent)
    reqs = [_req("alpha", n=5, seed=2, offset=5 * i) for i in range(32)]
    for r in reqs:
        assert svc.submit(fleet.get("alpha"), r) is None
    svc.start_workers()
    for r in reqs:
        assert r.done.wait(timeout=60)
        assert r.status == 200
    svc.shutdown(drain=True)
    snap = svc.metrics.snapshot()
    assert snap["requests_total"] == 32
    assert snap["batch_occupancy"] >= 4.0, snap
    engine = fleet.get("alpha").engine
    assert b"".join(r.result if i == 0 else r.result.partition(b"\n")[2]
                    for i, r in enumerate(reqs)) == \
        engine.sample_csv_bytes(160, seed=2)


# ----------------------------------------------------------- row pool


def test_pool_hit_parity_with_cold_dispatch(fleet):
    """A pool hit returns byte for byte what a cold dispatch would: same
    header, same rows, same slicing at arbitrary offsets."""
    pool = RowPool(fleet, chunk_rows=64, hot_after=1)
    engine = fleet.get("alpha").engine
    cold = engine.sample_csv_bytes(50, seed=4, offset=30)
    assert pool.get("alpha", 4, 30, 50, None, True) is None  # cold miss
    assert pool.fill_now("alpha", seed=4, offset=30, n=50) >= 1
    segments = pool.get("alpha", 4, 30, 50, None, True)
    assert segments is not None
    assert b"".join(segments) == cold
    # headerless slice crossing a chunk boundary
    cold2 = engine.sample_csv_bytes(40, seed=4, offset=60, header=False)
    assert pool.fill_now("alpha", seed=4, offset=60, n=40) >= 0
    seg2 = pool.get("alpha", 4, 60, 40, None, False)
    assert seg2 is not None and b"".join(seg2) == cold2
    stats = pool.stats()
    assert stats["hits"] == 2 and stats["fills"] >= 2


def test_csv_segments_join_to_csv_bytes(fleet):
    engine = fleet.get("beta").engine
    header, rows = engine.sample_csv_segments(77, seed=6, offset=13)
    assert len(rows) == 77
    assert header + b"".join(rows) == engine.sample_csv_bytes(77, seed=6,
                                                              offset=13)


def test_pool_invalidate_drops_tenant(fleet):
    pool = RowPool(fleet, chunk_rows=32, hot_after=1)
    pool.fill_now("alpha", seed=0, n=10)
    assert pool.get("alpha", 0, 0, 10, None, True) is not None
    pool.invalidate("alpha")
    assert pool.get("alpha", 0, 0, 10, None, True) is None


def test_quota_charged_before_pool_hit(fleet):
    """A quota tenant is shed with 429 even when every row it wants is
    already pooled."""
    pool = RowPool(fleet, chunk_rows=32, hot_after=1)
    pool.fill_now("beta", seed=0, n=10)
    svc = FleetService(fleet, port=0, reload_interval_s=0, row_pool=pool,
                       log=_silent)
    beta = fleet.get("beta")
    old_bucket = beta.bucket
    beta.bucket = TokenBucket(rate=0.001, burst=2.0)
    try:
        ok = svc._route_sample("beta", {"rows": "10", "seed": "0"}, None)
        assert ok.status == 200 and ok.body_bytes()
        ok = svc._route_sample("beta", {"rows": "10", "seed": "0"}, None)
        assert ok.status == 200
        shed = svc._route_sample("beta", {"rows": "10", "seed": "0"}, None)
        assert shed.status == 429  # burst spent: pool coverage is no bypass
        assert "Retry-After" in (shed.headers or {})
        snap = svc.metrics.tenant_snapshot("beta")
        assert snap["pool_hits_total"] == 2
        assert snap["shed_quota_total"] == 1
    finally:
        beta.bucket = old_bucket


# ------------------------------------------------------- graceful drain


def test_graceful_drain_with_n_workers(fleet):
    """Requests accepted before shutdown are answered by all workers
    before they exit."""
    svc = FleetService(fleet, port=0, max_batch=4, queue_size=64,
                       reload_interval_s=0, workers=4, log=_silent)
    reqs = [_req("alpha", n=3, seed=6, offset=3 * i) for i in range(12)]
    for r in reqs:
        assert svc.submit(fleet.get("alpha"), r) is None
    svc.start_workers()
    svc.shutdown(drain=True)
    for r in reqs:
        assert r.done.is_set()
        assert r.status == 200 and r.result is not None
    assert svc.submit(fleet.get("alpha"), _req("alpha")) == "capacity"


# ---------------------------------------------- shared cache under racing


def test_program_cache_single_build_under_race():
    """N threads missing the same key run ONE builder; the rest wait and
    hit."""
    cache = ProgramCache()
    builds = []
    gate = threading.Event()

    def builder():
        gate.wait(timeout=10)
        time.sleep(0.01)
        builds.append(1)
        return "P"

    out = []
    threads = [threading.Thread(
        target=lambda: out.append(cache.get_or_build("k", builder)))
        for _ in range(8)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join()
    assert out == ["P"] * 8
    assert len(builds) == 1
    stats = cache.stats()
    assert stats["misses"] == 1 and stats["hits"] == 7


def test_program_cache_builder_failure_releases_waiters():
    cache = ProgramCache()
    calls = []

    def failing():
        calls.append(1)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        cache.get_or_build("k", failing)
    # the key is not poisoned: the next caller builds fresh
    assert cache.get_or_build("k", lambda: "OK") == "OK"
    assert len(calls) == 1


# ------------------------------------------------- Retry-After regression


def test_retry_after_scales_with_worker_drain_rate(fleet):
    """The 503 hint divides queued work by the measured drain rate of all
    workers: doubling the drain halves the advertised wait."""
    svc = FleetService(fleet, port=0, queue_size=8, reload_interval_s=0,
                       log=_silent)
    assert svc.capacity_retry_after() == 1.0  # nothing measured yet: 1 s
    svc._drain_rate.rate = lambda: 2.0
    slow = svc.capacity_retry_after()
    assert slow == pytest.approx(0.5)  # (depth 0 + 1) / 2
    svc._drain_rate.rate = lambda: 4.0
    assert svc.capacity_retry_after() == pytest.approx(slow / 2)
    svc._drain_rate.rate = lambda: 1e9  # clamped to the floor, never 0
    assert svc.capacity_retry_after() == 0.05
    svc._drain_rate.rate = lambda: 1e-9  # and to the ceiling
    assert svc.capacity_retry_after() == 30.0


def test_drain_rate_ewma_reflects_all_workers():
    dr = DrainRate()
    assert dr.rate() == 0.0
    dr.note(5)
    assert dr.rate() > 0
    time.sleep(0.01)
    dr.note(5)
    time.sleep(0.01)
    dr.note(5)
    assert dr.rate() > 0


# ----------------------------------------------- single-model service


def test_sampling_service_multiworker_drain(tenant_roots):
    from fed_tgan_torch.serve.service import SamplingService, _Request

    svc = SamplingService(
        ModelRegistry(tenant_roots["alpha"], device="cpu", log=_silent),
        port=0, workers=2, coalesce_window_s=0.002, reload_interval_s=0,
        log=_silent).start()
    reference = svc.engine.sample_csv_bytes(20, seed=3)
    assert _get(f"{svc.url}/sample?rows=20&seed=3") == reference
    reqs = [_Request(n=5, seed=1, offset=5 * i, condition=None, header=True)
            for i in range(8)]
    for r in reqs:
        assert svc.submit(r)
    svc.shutdown(drain=True)
    for r in reqs:
        assert r.done.is_set() and r.status == 200


def test_multiworker_build_budget_holds(tenant_roots):
    """Armed build counter: 4 workers racing the same lane groups still
    build each group at most once fleet-wide, and serve the single
    engine's bytes."""
    from fed_tgan_torch.analysis.sanitizers import (
        check_fleet_budget,
        sanitize,
    )

    with sanitize() as counter:
        reg = FleetRegistry(program_cache=ProgramCache(max_entries=16),
                            device="cpu", log=_silent)
        for name in ("alpha", "beta"):
            reg.load(name, tenant_roots[name])
        svc = FleetService(reg, port=0, max_batch=8, queue_size=64,
                           max_lanes=4, reload_interval_s=0, workers=4,
                           log=_silent)
        reqs = [_FleetRequest(tenant=("alpha", "beta")[i % 2], n=5, seed=1,
                              offset=5 * i, condition=None, header=True)
                for i in range(16)]
        for r in reqs:
            assert svc.submit(reg.get(r.tenant), r) is None
        svc.start_workers()
        for r in reqs:
            assert r.done.wait(timeout=120) and r.status == 200
        svc.shutdown(drain=True)
        assert check_fleet_budget(reg.cache, counter) == []
        assert all(v == 1 for k, v in counter.counts().items()
                   if k.startswith("lanes["))
    for name in ("alpha", "beta"):
        engine = SamplingEngine(open_model(tenant_roots[name], device="cpu"))
        for r in reqs:
            if r.tenant == name:
                assert r.result == engine.sample_csv_bytes(
                    5, seed=1, offset=r.offset)
