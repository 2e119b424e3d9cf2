"""The port's serving process on the CPU: the registry's hot reload, the
engine's snapshot and stages, and the batching HTTP service with its
metrics, 503/504 and drain (the JAX package's ``tests/test_serve.py``
ported to ``fed_tgan_torch/serve``), on a random-weight Intrusion-shaped
port artifact at a small width.
"""

import json
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fed_tgan_torch.__main__ import main as port_main
from fed_tgan_torch.runtime.checkpoint import checkpoint_fingerprint
from fed_tgan_torch.serve.demo import build_random_artifact
from fed_tgan_torch.serve.engine import ConditionError, SamplingEngine
from fed_tgan_torch.serve.metrics import STAGES, ServiceMetrics
from fed_tgan_torch.serve.registry import (
    ArtifactError,
    ModelRegistry,
    open_model,
    resolve_artifact,
)
from fed_tgan_torch.serve.service import (
    SamplingService,
    _Request,
    client_main,
)
from fed_tgan_torch.train.steps import TrainConfig

torch.set_num_threads(2)

SMALL = TrainConfig(embedding_dim=16, gen_dims=(32, 32), dis_dims=(32, 32),
                    batch_size=50)
_silent = lambda *a, **k: None  # noqa: E731


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    return build_random_artifact(
        str(tmp_path_factory.mktemp("torch_service")), seed=0, cfg=SMALL)


@pytest.fixture(scope="module")
def model(artifact_dir):
    return open_model(artifact_dir, device="cpu")


@pytest.fixture(scope="module")
def engine(model):
    return SamplingEngine(model)


@pytest.fixture(scope="module")
def service(artifact_dir):
    svc = SamplingService(
        ModelRegistry(artifact_dir, device="cpu", log=_silent),
        port=0, max_batch=4, queue_size=32, log=_silent).start()
    yield svc
    svc.shutdown(drain=False)


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _request(n=1, **kw):
    return _Request(n=n, seed=kw.get("seed", 0), offset=kw.get("offset", 0),
                    condition=None, header=True)


# ---------------------------------------------------------------- registry


def test_model_id_is_content_hash(model, artifact_dir):
    assert len(model.model_id) == 12
    int(model.model_id, 16)  # hex
    assert model.model_id == checkpoint_fingerprint(
        resolve_artifact(artifact_dir).synth_dir)


def test_registry_device_defaults_to_cuda(artifact_dir):
    registry = ModelRegistry(artifact_dir, log=_silent)
    assert registry.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            registry.get()


def test_registry_hot_reload_swaps_on_new_generation(artifact_dir, tmp_path):
    """A republished artifact (same layout, new weights) is picked up by
    maybe_reload, and the engine adopts it with its layout key kept."""
    root = str(tmp_path / "artifact")
    shutil.copytree(artifact_dir, root)
    reg = ModelRegistry(root, device="cpu", log=_silent)
    first_id = reg.get().model_id
    eng = SamplingEngine(reg.get())
    assert reg.maybe_reload() is False  # nothing changed yet

    build_random_artifact(root, seed=1, cfg=SMALL)
    assert reg.maybe_reload() is True
    assert reg.get().model_id != first_id
    assert eng.adopt(reg.get()) is True  # layout unchanged
    assert reg.maybe_reload() is False


def test_registry_missing_root_raises(tmp_path):
    with pytest.raises(ArtifactError):
        ModelRegistry(str(tmp_path), device="cpu", log=_silent).get()


# ------------------------------------------------------------------ engine


def test_engine_chunked_draws_match_one_shot(engine):
    whole = engine.sample_decoded(120, seed=5)
    parts = np.concatenate([
        engine.sample_decoded(40, seed=5, offset=0),
        engine.sample_decoded(80, seed=5, offset=40),
    ])
    np.testing.assert_array_equal(whole, parts)
    np.testing.assert_array_equal(
        whole[55:62], engine.sample_decoded(7, seed=5, offset=55))


def test_engine_cold_vs_warm_identical(engine, model):
    cold = SamplingEngine(model)
    np.testing.assert_array_equal(
        cold.sample_decoded(60, seed=9), engine.sample_decoded(60, seed=9))


def test_engine_seeds_are_independent_streams(engine):
    a = engine.sample_decoded(50, seed=1)
    b = engine.sample_decoded(50, seed=2)
    assert not np.array_equal(a, b)


def test_engine_chunk_plan_buckets_are_powers_of_two(engine):
    for total in (1, 3, 5, 128, 129, 300):
        plan = engine._chunk_plan(0, total)
        covered = 0
        for start, steps in plan:
            assert start == covered
            assert steps <= engine.max_chunk_steps
            assert steps & (steps - 1) == 0  # power of two
            covered += steps
        assert covered >= total
    assert engine._chunk_plan(0, 300) == [(0, 128), (128, 128), (256, 64)]


def test_engine_rejects_bad_args(engine):
    with pytest.raises(ValueError, match="at least one row"):
        engine.sample_decoded(0)
    with pytest.raises(ValueError, match="must be >= 0"):
        engine.sample_decoded(10, offset=-1)


def test_engine_conditional_position_and_errors(engine):
    spec = engine.spec
    names = list(engine.model.meta.column_names)
    pos = engine.resolve_condition("service", "ftp")
    col_idx = names.index("service")
    lo = int(spec.cond_offsets[col_idx])
    assert lo <= pos < lo + int(spec.cond_sizes[col_idx])
    a = engine.sample_decoded(50, seed=3, condition=pos)
    np.testing.assert_array_equal(
        a, engine.sample_decoded(50, seed=3, condition=pos))
    assert np.isfinite(a).all()
    assert not np.array_equal(a, engine.sample_decoded(50, seed=3))
    with pytest.raises(ConditionError, match="unknown column"):
        engine.resolve_condition("nope", "x")
    with pytest.raises(ConditionError, match="continuous"):
        engine.resolve_condition("duration", "1.0")
    with pytest.raises(ConditionError):
        engine.resolve_condition("service", "plaid")


def test_engine_stages_cover_dispatch_decode_serialize(engine):
    stages = {}
    blob = engine.sample_csv_bytes(70, seed=8, stages=stages)
    assert blob == engine.sample_csv_bytes(70, seed=8)
    assert set(stages) == {"dispatch", "decode", "serialize"}
    assert all(v >= 0 for v in stages.values())


def test_engine_layout_key_and_adopt_to_another_layout(engine, tmp_path):
    """A model of another width has another layout key; adopting it
    reports the change and serves the new model."""
    other = open_model(build_random_artifact(
        str(tmp_path / "wide"), seed=0,
        cfg=TrainConfig(embedding_dim=16, gen_dims=(48,), batch_size=50)),
        device="cpu")
    eng = SamplingEngine(engine.model)
    assert eng.layout_key(other) != eng.layout_key(engine.model)
    assert eng.adopt(other) is False
    assert eng.snapshot().model is other
    assert eng.sample_csv_bytes(30, seed=1) == \
        SamplingEngine(other).sample_csv_bytes(30, seed=1)


# ----------------------------------------------------------------- service


def test_served_bytes_match_one_shot_cli_file(service, artifact_dir,
                                              tmp_path):
    """A served /sample response equals the CSV that the one-shot
    ``--sample-from`` path writes for the same (rows, seed)."""
    served = _get(f"{service.url}/sample?rows=40&seed=7")
    out = tmp_path / "rows.csv"
    assert port_main(["--sample-from", artifact_dir, "--sample-rows", "40",
                      "--seed", "7", "--out", str(out),
                      "--device", "cpu"]) == 0
    assert out.read_bytes() == served


def test_served_chunked_equals_one_request(service):
    whole = _get(f"{service.url}/sample?rows=90&seed=4")
    parts = (_get(f"{service.url}/sample?rows=30&seed=4&offset=0")
             + _get(f"{service.url}/sample?rows=60&seed=4&offset=30&header=0"))
    assert whole == parts


def test_served_post_equals_get(service):
    req = urllib.request.Request(
        f"{service.url}/sample", method="POST",
        data=json.dumps({"rows": 25, "seed": 6}).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.read() == _get(f"{service.url}/sample?rows=25&seed=6")


def test_sample_client_chunked_equals_one_shot(service, tmp_path):
    one, many = str(tmp_path / "one.csv"), str(tmp_path / "many.csv")
    assert client_main(["--url", service.url, "--rows", "50", "--seed", "2",
                        "--out", one]) == 0
    assert client_main(["--url", service.url, "--rows", "50", "--seed", "2",
                        "--chunks", "3", "--out", many]) == 0
    with open(one, "rb") as f1, open(many, "rb") as f2:
        assert f1.read() == f2.read()
    assert port_main(["sample-client", "--url", service.url, "--rows", "5",
                      "--seed", "2", "--out", one]) == 0
    with open(one, "rb") as f:
        assert f.read() == _get(f"{service.url}/sample?rows=5&seed=2")


def test_healthz_and_metrics_endpoints(service):
    _get(f"{service.url}/sample?rows=10&seed=1")
    snap = json.loads(_get(f"{service.url}/healthz"))
    assert snap["status"] == "ok"
    assert snap["model_id"] == service.registry.get().model_id
    assert snap["model_name"] == "Intrusion"
    assert snap["device"] == "cpu"
    assert snap["requests_total"] >= 1
    assert set(snap["stages"]) == set(STAGES)

    text = _get(f"{service.url}/metrics").decode()
    assert "# TYPE fed_tgan_serving_requests_total counter" in text
    assert "fed_tgan_serving_batch_occupancy" in text
    assert "fed_tgan_serving_rows_per_sec" in text
    assert 'fed_tgan_serving_stage_p99_ms{stage="dispatch"}' in text


def test_http_errors(service):
    for path, want in [("/sample?rows=0", 400),
                       ("/sample?rows=5&offset=-1", 400),
                       ("/sample?rows=5&column=nope&value=x", 400),
                       ("/nothing", 404)]:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{service.url}{path}")
        assert err.value.code == want


def test_submit_sheds_when_queue_full_or_draining(artifact_dir):
    """The worker never starts: the first request parks in the 1-slot
    queue and the second must shed."""
    svc = SamplingService(ModelRegistry(artifact_dir, device="cpu",
                                        log=_silent),
                          queue_size=1, log=_silent)  # never start()ed
    assert svc.submit(_request()) is True
    assert svc.submit(_request()) is False
    assert svc.metrics.shed_total == 1
    svc._draining.set()
    assert svc.submit(_request()) is False


def _http_only(svc):
    """Start ``svc``'s HTTP server without its workers: whatever is
    queued stays queued."""
    import threading
    from http.server import ThreadingHTTPServer

    from fed_tgan_torch.serve.service import _make_handler

    svc._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(svc))
    threading.Thread(target=svc._httpd.serve_forever, daemon=True).start()
    return svc


def test_full_queue_answers_503_with_retry_after(artifact_dir):
    svc = _http_only(SamplingService(
        ModelRegistry(artifact_dir, device="cpu", log=_silent),
        queue_size=1, log=_silent))
    try:
        assert svc.submit(_request())  # the only slot
        svc._drain_rate.rate = lambda: 4.0
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{svc.url}/sample?rows=5")
        assert err.value.code == 503
        assert float(err.value.headers["Retry-After"]) == 0.5  # (1 + 1) / 4
        assert svc.metrics.shed_total == 1
    finally:
        svc.shutdown(drain=False)


def test_request_timeout_answers_504(artifact_dir):
    """A request still queued past --request-timeout gets 504."""
    svc = _http_only(SamplingService(
        ModelRegistry(artifact_dir, device="cpu", log=_silent),
        request_timeout_s=0.2, log=_silent))
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"{svc.url}/sample?rows=5")
        assert err.value.code == 504
    finally:
        svc.shutdown(drain=False)


def test_shutdown_drains_queued_requests(artifact_dir):
    svc = SamplingService(ModelRegistry(artifact_dir, device="cpu",
                                        log=_silent),
                          port=0, log=_silent).start()
    req = _request(n=10)
    assert svc.submit(req)
    svc.shutdown(drain=True)
    assert req.done.is_set()
    assert req.status == 200 and req.result is not None
    assert not svc.submit(_request())


def test_service_hot_reload_under_fire(artifact_dir, tmp_path):
    """Worker 0's poll adopts a republished generation; every response
    meanwhile is the old model's bytes or the new one's."""
    import threading

    root = str(tmp_path / "artifact")
    shutil.copytree(artifact_dir, root)
    svc = SamplingService(ModelRegistry(root, device="cpu", log=_silent),
                          port=0, reload_interval_s=0.05, workers=2,
                          log=_silent).start()
    url = f"{svc.url}/sample?rows=12&seed=4"
    try:
        old = _get(url)
        seen, stop = [], threading.Event()

        def hammer():
            while not stop.is_set():
                seen.append(_get(url))

        threads = [threading.Thread(target=hammer) for _ in range(2)]
        for t in threads:
            t.start()
        build_random_artifact(root, seed=9, cfg=SMALL)
        new = SamplingEngine(open_model(root, device="cpu")).sample_csv_bytes(
            12, seed=4)
        for _ in range(200):
            if _get(url) == new:
                break
            stop.wait(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert seen and all(b in (old, new) for b in seen)
        assert _get(url) == new
        assert svc.metrics.reloads_total == 1
    finally:
        svc.shutdown(drain=False)


# ----------------------------------------------------------------- metrics


def test_metrics_occupancy_and_quantiles():
    m = ServiceMetrics()
    m.record_batch(3)
    for lat in (0.010, 0.020, 0.030):
        m.record_request(lat, rows=100)
    snap = m.snapshot(queue_depth=2)
    assert snap["requests_total"] == 3
    assert snap["rows_total"] == 300
    assert snap["batches_total"] == 1
    assert snap["batch_occupancy"] == 3.0
    assert snap["queue_depth"] == 2
    assert snap["latency_p50_ms"] == 20.0
    text = m.render_prometheus()
    assert "# TYPE fed_tgan_serving_batch_occupancy gauge" in text
    assert "fed_tgan_serving_batch_occupancy 3.0" in text
