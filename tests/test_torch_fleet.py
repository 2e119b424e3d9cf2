"""The port's multi-tenant fleet (``fed_tgan_torch/serve/fleet.py``) on
the CPU: the JAX package's ``tests/test_fleet.py`` ported (its compile
budget as the lane groups' build budget, and the whole module under an
armed lockwatch), and the lane dispatch: its bytes equal the
single-model engine's, exactly, at every lane count and step count, with
one activation call per dispatch.

Tenants are random-weight Intrusion-shaped port artifacts at a small
width; ``alpha`` and ``beta`` are the same bytes, ``gamma`` has other
weights (and the same layout, so it shares their lanes).
"""

import json
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fed_tgan_torch.models.ctgan import StackedEvalGenerator
from fed_tgan_torch.serve import fleet as fleet_mod
from fed_tgan_torch.serve.demo import build_random_artifact
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.fleet import (
    FleetRegistry,
    FleetService,
    ProgramCache,
    TokenBucket,
    _FleetRequest,
    _Member,
)
from fed_tgan_torch.serve.registry import ModelRegistry, open_model
from fed_tgan_torch.train.steps import TrainConfig

torch.set_num_threads(2)

SMALL = TrainConfig(embedding_dim=16, gen_dims=(32, 32), dis_dims=(32, 32),
                    batch_size=50)
_silent = lambda *a, **k: None  # noqa: E731


def build(root, seed):
    return build_random_artifact(str(root), seed=seed, cfg=SMALL)


@pytest.fixture(scope="module", autouse=True)
def _lockwatch_armed():
    """Arm the runtime deadlock sanitizer for the whole module: every
    lock the fleet allocates is watched, and any lock-order cycle or
    re-entry the tests drive fails the module at teardown."""
    from fed_tgan_torch.analysis import lockwatch

    with lockwatch.watch(on_deadlock="record"):
        yield
        bad = lockwatch.reports("cycle") + lockwatch.reports("reentry")
        assert bad == [], [r.detail for r in bad]


@pytest.fixture(scope="module")
def tenant_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_fleet")
    return {name: build(base / name, seed)
            for name, seed in (("alpha", 0), ("beta", 0), ("gamma", 7))}


@pytest.fixture(scope="module")
def fleet(tenant_roots):
    reg = FleetRegistry(program_cache=ProgramCache(max_entries=16),
                        device="cpu", log=_silent)
    for name, root in tenant_roots.items():
        reg.load(name, root)
    return reg


@pytest.fixture(scope="module")
def fleet_service(fleet):
    svc = FleetService(fleet, port=0, max_batch=8, queue_size=64,
                       max_lanes=4, reload_interval_s=0, log=_silent).start()
    yield svc
    svc.shutdown(drain=False)


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _get_resp(req, timeout=60):
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def reference(root, n, seed, offset=0, condition=None, header=True):
    return SamplingEngine(open_model(root, device="cpu")).sample_csv_bytes(
        n, seed=seed, offset=offset, condition=condition, header=header)


# ------------------------------------------------------------ token bucket


def test_token_bucket_rate_and_burst():
    bucket = TokenBucket(rate=1.0, burst=3.0)
    assert [bucket.allow() for _ in range(3)] == [True, True, True]
    assert not bucket.allow()  # burst spent, refill is 1/s
    assert bucket.retry_after_s() > 0


def test_token_bucket_unlimited_when_rate_nonpositive():
    bucket = TokenBucket(rate=0.0)
    assert all(bucket.allow() for _ in range(1000))
    assert bucket.retry_after_s() == 0.0


# --------------------------------------------------------------- lane LRU


def test_lru_evicts_in_lru_order_under_entry_budget():
    cache = ProgramCache(max_entries=2)
    cache.get_or_build("a", lambda: "A")
    cache.get_or_build("b", lambda: "B")
    cache.get_or_build("a", lambda: "A")  # touch: a becomes MRU
    cache.get_or_build("c", lambda: "C")  # evicts b, the LRU entry
    assert cache.keys() == ["a", "c"]
    stats = cache.stats()
    assert stats["evictions"] == 1 and stats["hits"] == 1
    assert stats["misses"] == 3


def test_lru_enforces_byte_budget():
    cache = ProgramCache(max_entries=100, max_bytes=100)
    cache.get_or_build("a", lambda: "A", est_bytes=60)
    cache.get_or_build("b", lambda: "B", est_bytes=60)  # 120 > 100: drop a
    assert cache.keys() == ["b"]
    assert cache.stats()["bytes"] == 60


def test_lru_never_evicts_the_just_inserted_sole_entry():
    cache = ProgramCache(max_entries=4, max_bytes=10)
    assert cache.get_or_build("huge", lambda: "H", est_bytes=10_000) == "H"
    assert cache.keys() == ["huge"]


def test_lru_hit_returns_cached_program_without_rebuilding():
    cache = ProgramCache()
    builds = []
    for _ in range(3):
        cache.get_or_build("k", lambda: builds.append(1) or "P")
    assert len(builds) == 1
    assert cache.stats() == {
        "entries": 1, "bytes": 0, "max_entries": 64,
        "max_bytes": 256 * 1024 * 1024, "hits": 2, "misses": 1,
        "evictions": 0,
    }


# ---------------------------------------------------------- fleet registry


def test_fleet_load_evict_and_sole(tenant_roots):
    reg = FleetRegistry(device="cpu", log=_silent)
    assert reg.sole() is None
    reg.load("only", tenant_roots["alpha"])
    assert reg.sole() is not None and reg.names() == ["only"]
    reg.load("other", tenant_roots["beta"])
    assert reg.sole() is None  # ambiguous: /sample alias must 400
    assert reg.evict("other") and not reg.evict("other")
    assert reg.names() == ["only"]


def test_fleet_registry_device_defaults_to_cuda(tenant_roots):
    reg = FleetRegistry(log=_silent)
    assert reg.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            reg.load("alpha", tenant_roots["alpha"])


def test_identical_layouts_share_one_lane_group(fleet):
    """Same-layout tenants share a layout key; a lane group is built once
    for a given set of members and reused by every later dispatch."""
    keys = {name: SamplingEngine.layout_key(fleet.get(name).engine.model)
            for name in ("alpha", "beta", "gamma")}
    assert keys["alpha"] == keys["beta"] == keys["gamma"]
    svc = FleetService(fleet, max_lanes=4, log=_silent)
    snaps = [fleet.get(n).engine.snapshot() for n in ("alpha", "gamma")]
    before = fleet.cache.stats()
    first = svc.lane_group(snaps)
    assert svc.lane_group(snaps) is first
    after = fleet.cache.stats()
    assert after["misses"] == before["misses"] + 1
    assert after["hits"] == before["hits"] + 1
    a = fleet.get("alpha").engine.sample_csv_bytes(25, seed=3)
    assert a == fleet.get("beta").engine.sample_csv_bytes(25, seed=3)
    assert a != fleet.get("gamma").engine.sample_csv_bytes(25, seed=3)


# --------------------------------------------------- served-byte identity


def test_fleet_served_bytes_match_single_model_engine(fleet_service,
                                                      tenant_roots):
    """Bytes served through the coalescing fleet equal the single-model
    engine's, per tenant."""
    want = {name: reference(root, 30, 5)
            for name, root in tenant_roots.items()}
    results, errors = {}, []

    def fetch(name):
        try:
            results[name] = _get(f"{fleet_service.url}/t/{name}/sample"
                                 "?rows=30&seed=5")
        except Exception as exc:  # noqa: BLE001 — collected for the assert
            errors.append((name, exc))

    threads = [threading.Thread(target=fetch, args=(n,))
               for n in tenant_roots]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert results == want


def test_fleet_chunked_offsets_equal_one_request(fleet_service):
    whole = _get(f"{fleet_service.url}/t/alpha/sample?rows=80&seed=11")
    first = _get(f"{fleet_service.url}/t/alpha/sample?rows=50&seed=11")
    rest = _get(f"{fleet_service.url}/t/alpha/sample"
                "?rows=30&seed=11&offset=50&header=0")
    assert first + rest == whole


def test_fleet_http_status_and_admin(fleet_service, tenant_roots):
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(f"{fleet_service.url}/t/nobody/sample?rows=5")
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(f"{fleet_service.url}/sample?rows=5")  # >1 tenant: ambiguous
    assert err.value.code == 400
    status = json.loads(_get(f"{fleet_service.url}/fleet"))
    assert sorted(t["name"] for t in status["tenants"]) \
        == ["alpha", "beta", "gamma"]
    assert status["device"] == "cpu"
    req = urllib.request.Request(
        f"{fleet_service.url}/fleet", method="POST",
        data=json.dumps({"action": "load", "tenant": "delta",
                         "root": tenant_roots["alpha"]}).encode())
    assert json.loads(_get_resp(req))["loaded"] == "delta"
    assert _get(f"{fleet_service.url}/t/delta/sample?rows=1")
    req = urllib.request.Request(
        f"{fleet_service.url}/fleet", method="POST",
        data=json.dumps({"action": "evict", "tenant": "delta"}).encode())
    assert json.loads(_get_resp(req))["evicted"] == "delta"
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(f"{fleet_service.url}/t/delta/sample?rows=1")
    assert err.value.code == 404


# ------------------------------------------------------- quotas / shedding


def _req(tenant, n=1, seed=0, offset=0, condition=None):
    return _FleetRequest(tenant=tenant, n=n, seed=seed, offset=offset,
                         condition=condition, header=True)


def test_quota_shed_is_per_tenant_and_fair(fleet):
    """A tenant over its token-bucket quota is shed with "quota" (429)
    while every other tenant keeps being admitted."""
    svc = FleetService(fleet, port=0, queue_size=8, queue_share=0.5,
                       log=_silent)  # NOT started: nothing drains
    capped = fleet.get("alpha")
    capped.bucket = TokenBucket(rate=0.001, burst=2.0)
    try:
        assert svc.submit(capped, _req("alpha")) is None
        assert svc.submit(capped, _req("alpha")) is None
        assert svc.submit(capped, _req("alpha")) == "quota"  # burst spent
        other = fleet.get("beta")
        for _ in range(svc.tenant_cap()):
            assert svc.submit(other, _req("beta")) is None  # unaffected
        # beta now holds its fair share of the queue: capacity, not quota
        assert svc.submit(other, _req("beta")) == "capacity"
        # and gamma STILL gets in — the cap is per-tenant
        assert svc.submit(fleet.get("gamma"), _req("gamma")) is None
        snap = svc.metrics.snapshot()
        assert snap["tenants"]["alpha"]["shed_quota_total"] == 1
        assert snap["tenants"]["beta"]["shed_capacity_total"] == 1
    finally:
        capped.bucket = TokenBucket(0.0)
        for q in svc._queues:  # drop the never-drained requests
            while not q.empty():
                q.get_nowait()


def test_submit_sheds_capacity_when_draining(fleet):
    svc = FleetService(fleet, port=0, queue_size=8, log=_silent)
    svc._draining.set()
    assert svc.submit(fleet.get("alpha"), _req("alpha")) == "capacity"


# --------------------------------------------- hot reload under in-flight


def test_snapshot_survives_adopt_mid_batch(tenant_roots, tmp_path):
    """A batch formed against a snapshot keeps sampling the OLD model even
    when a hot reload adopts a new generation mid-flight, and fresh
    requests see the new one."""
    root = str(tmp_path / "tenant")
    shutil.copytree(tenant_roots["alpha"], root)
    registry = ModelRegistry(root, device="cpu", log=_silent)
    engine = SamplingEngine(registry.get())
    before = engine.sample_csv_bytes(20, seed=2)
    snap = engine.snapshot()  # the batch forms HERE

    build(root, seed=13)  # republish: new generation
    assert registry.maybe_reload()
    assert engine.adopt(registry.get())

    assert engine.sample_csv_bytes(20, seed=2, snap=snap) == before
    after = engine.sample_csv_bytes(20, seed=2)  # fresh snapshot
    assert after != before


def test_hot_reload_under_fire(tenant_roots, tmp_path):
    """Concurrent clients keep getting answers while the artifact is
    republished and adopted under them: every body is the old model's
    bytes or the new model's, and the new one is served after."""
    root = str(tmp_path / "tenant")
    shutil.copytree(tenant_roots["alpha"], root)
    fleet = FleetRegistry(device="cpu", log=_silent)
    fleet.load("hot", root)
    svc = FleetService(fleet, port=0, max_batch=4, queue_size=32,
                       reload_interval_s=0.05, log=_silent).start()
    url = f"{svc.url}/t/hot/sample?rows=10&seed=4"
    try:
        old = _get(url)
        seen, errors, stop = [], [], threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    seen.append(_get(url))
                except Exception as exc:  # noqa: BLE001 — fail the test
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        build(root, seed=21)  # republish under fire
        new = reference(root, 10, 4)
        assert new != old
        for _ in range(200):  # wait for the worker's poll to adopt it
            if _get(url) == new:
                break
            stop.wait(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        assert seen and all(body in (old, new) for body in seen)
        assert _get(url) == new
        assert svc.metrics.tenant_snapshot("hot")["reloads_total"] == 1
    finally:
        svc.shutdown(drain=False)


def test_registry_does_not_retry_a_failed_generation(tenant_roots,
                                                    tmp_path):
    """A generation that passes the probe but fails to load is logged
    once and not loaded again until another publish."""
    root = str(tmp_path / "tenant")
    shutil.copytree(tenant_roots["alpha"], root)
    logs = []
    registry = ModelRegistry(root, device="cpu", log=logs.append)
    first = registry.get().model_id
    weights = f"{root}/models/synthesizer_torch/weights.npz"
    with np.load(weights) as data:
        arrays = {k: data[k] for k in data.files if k != "cond.p_train"}
    with open(weights, "wb") as f:
        np.savez(f, **arrays)
    assert registry.maybe_reload() is False
    assert registry.maybe_reload() is False
    assert registry.get().model_id == first
    assert sum("reload failed" in line for line in logs) == 1
    build(root, seed=5)
    assert registry.maybe_reload() is True


def test_registry_skips_torn_generation_once(tenant_roots, tmp_path):
    """A torn publish keeps the current model serving and is not retried
    every poll; the next good publish is picked up."""
    root = str(tmp_path / "tenant")
    shutil.copytree(tenant_roots["alpha"], root)
    logs = []
    registry = ModelRegistry(root, device="cpu", log=logs.append)
    first = registry.get().model_id
    art_weights = f"{root}/models/synthesizer_torch/weights.npz"
    with open(art_weights, "r+b") as f:
        f.truncate(100)
    assert registry.maybe_reload() is False
    assert registry.maybe_reload() is False
    assert registry.get().model_id == first
    build(root, seed=5)
    assert registry.maybe_reload() is True
    assert registry.get().model_id != first


# ----------------------------------------------------------- lane dispatch


def test_concurrent_same_bucket_requests_coalesce_into_lanes(fleet):
    """A backlog of same-bucket requests from three tenants rides shared
    lane dispatches, and each tenant still gets its own decode."""
    svc = FleetService(fleet, port=0, max_batch=8, queue_size=64,
                       max_lanes=4, reload_interval_s=0, log=_silent)
    reqs = {(n, s): _req(n, n=40, seed=s)
            for n in ("alpha", "beta", "gamma") for s in (31, 32)}
    for (name, _), r in reqs.items():
        assert svc.submit(fleet.get(name), r) is None
    svc.start_workers()
    for r in reqs.values():
        assert r.done.wait(timeout=60) and r.status == 200, r.error
    svc.shutdown(drain=True)
    for s in (31, 32):
        assert reqs[("alpha", s)].result == reqs[("beta", s)].result
        assert reqs[("gamma", s)].result != reqs[("alpha", s)].result
        assert reqs[("alpha", s)].result == \
            fleet.get("alpha").engine.sample_csv_bytes(40, seed=s)
    snap = svc.metrics.snapshot()
    assert snap["lane_dispatches_total"] >= 1
    assert snap["lane_requests_total"] == 6


def _members(fleet, specs):
    """_Member objects for (tenant, rows, seed, offset, condition)."""
    out = []
    for name, n, seed, offset, condition in specs:
        rt = fleet.get(name)
        snap = rt.engine.snapshot()
        first, skip = divmod(offset, snap.cfg.batch_size)
        out.append(_Member(_FleetRequest(name, n, seed, offset, condition,
                                         True), rt, snap, first, skip))
    return out


@pytest.mark.parametrize("lanes", [1, 2, 3, 8])
@pytest.mark.parametrize("steps", [1, 4, 16])
@pytest.mark.parametrize("conditional", [False, True])
def test_lane_rows_equal_single_engine(fleet, lanes, steps, conditional):
    """Contract 1 at the decoded rows: every lane of a dispatch equals its
    tenant's single-engine rows bit for bit (here on the CPU; on the card
    in ``test_torch_gpu.py``)."""
    names = ["alpha", "gamma", "beta"]
    values = ["udp", "tcp", "icmp"]  # each lane may fix another option
    B = SMALL.batch_size
    engine = fleet.get("alpha").engine
    specs = [(names[i % 3], steps * B - 7, 40 + i, 7 + i * 3 * B,
              engine.resolve_condition("protocol_type", values[i % 3])
              if conditional else None)
             for i in range(lanes)]
    members = _members(fleet, specs)
    svc = FleetService(fleet, max_lanes=8, log=_silent)
    host = svc.lane_pass(members, steps)
    assert host.shape[0] == lanes  # one lane per member, none padded
    for i, m in enumerate(members):
        want = m.rt.engine.sample_decoded(m.req.n, seed=m.req.seed,
                                          offset=m.req.offset,
                                          condition=m.req.condition)
        got = host[i, m.skip:m.skip + m.req.n]
        np.testing.assert_array_equal(got, want)


def test_lane_dispatch_calls_the_activation_once(fleet, monkeypatch):
    """One lane dispatch = one call of the activation over lanes * steps *
    B rows (the wrapper launches K1 once per call on the card)."""
    calls = []
    real = fleet_mod.fused_apply_activate

    def counting(x, spec, u):
        calls.append(tuple(x.shape))
        return real(x, spec, u)

    monkeypatch.setattr(fleet_mod, "fused_apply_activate", counting)
    svc = FleetService(fleet, max_batch=8, max_lanes=8, reload_interval_s=0,
                       log=_silent)
    reqs = [_req(n, n=120, seed=s) for n in ("alpha", "beta", "gamma")
            for s in (1, 2)]
    for r in reqs:
        assert svc.submit(fleet.get(r.tenant), r) is None
    svc.start_workers()
    for r in reqs:
        assert r.done.wait(timeout=60) and r.status == 200
    svc.shutdown(drain=True)
    snap = svc.metrics.snapshot()
    assert len(calls) == snap["lane_dispatches_total"] == 1
    assert calls == [(6 * 4 * SMALL.batch_size, calls[0][1])]  # 6 lanes
    assert snap["lanes_occupied"] == 6


def test_failed_lane_dispatch_answers_each_request_500(fleet, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("lane failure")

    monkeypatch.setattr(fleet_mod, "fused_apply_activate", boom)
    svc = FleetService(fleet, max_batch=8, reload_interval_s=0, log=_silent)
    reqs = [_req(n, n=20, seed=1) for n in ("alpha", "gamma")]
    for r in reqs:
        assert svc.submit(fleet.get(r.tenant), r) is None
    svc.start_workers()
    for r in reqs:
        assert r.done.wait(timeout=60)
        assert r.status == 500 and "lane failure" in r.error
    svc.shutdown(drain=True)
    snap = svc.metrics.snapshot()
    assert snap["lane_dispatches_total"] == 0
    assert all(snap["tenants"][n]["errors_total"] == 1
               for n in ("alpha", "gamma"))


@pytest.mark.parametrize("lanes", [1, 2, 3])
def test_stacked_eval_generator_equals_generator(fleet, lanes):
    gens = [fleet.get(n).engine.model.synth.generator
            for n in ("alpha", "gamma", "beta")[:lanes]]
    B = SMALL.batch_size
    x = torch.randn((lanes, 3 * B, gens[0].blocks[0].fc.in_features),
                    generator=torch.Generator().manual_seed(lanes))
    got = StackedEvalGenerator(gens)(x, block_rows=B)
    with torch.no_grad():
        for i, g in enumerate(gens):
            want = torch.cat([g(b) for b in x[i].split(B)])
            assert torch.equal(got[i], want)


def test_cross_tenant_build_budget_one_per_name(tenant_roots):
    """Under an armed build counter, lane groups of same-layout tenants
    are built at most once per key fleet-wide (``check_fleet_budget``
    clean); with evictions the budget is entries + evictions."""
    from fed_tgan_torch.analysis.sanitizers import (
        check_fleet_budget,
        sanitize,
    )

    with sanitize() as counter:
        reg = FleetRegistry(program_cache=ProgramCache(max_entries=16),
                            device="cpu", log=_silent)
        for name in ("alpha", "gamma"):
            reg.load(name, tenant_roots[name])
        svc = FleetService(reg, max_lanes=8, log=_silent)
        for seed in (1, 2):
            for steps in (1, 2):
                svc.lane_pass(_members(reg, [("alpha", 40, seed, 0, None),
                                             ("gamma", 40, seed, 0, None)]),
                              steps)
            for name in ("alpha", "gamma"):
                reg.get(name).engine.sample_csv_bytes(60, seed=seed)
        counts = {k: v for k, v in counter.counts().items()
                  if k.startswith("lanes[")}
        assert len(counts) == 1 and all(v == 1 for v in counts.values())
        assert check_fleet_budget(reg.cache, counter) == []

        tight = FleetRegistry(program_cache=ProgramCache(max_entries=1),
                              device="cpu", log=_silent)
        for name in ("alpha", "beta", "gamma"):
            tight.load(name, tenant_roots[name])
        svc = FleetService(tight, max_lanes=8, log=_silent)
        counter.reset()
        for pair in (("alpha", "gamma"), ("gamma", "alpha"),
                     ("alpha", "gamma")):
            svc.lane_pass(_members(tight, [(n, 40, 1, 0, None)
                                            for n in pair]), 1)
        stats = tight.cache.stats()
        assert stats["evictions"] == 2 and counter.count("lanes[") == 3
        assert check_fleet_budget(tight.cache, counter) == []
