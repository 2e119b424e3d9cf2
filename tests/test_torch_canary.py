"""The port's canary promotion on the CPU: reference statistics, scores,
the W1 scorer, the ML probe, the degrade fault and the quality series held
against the JAX package on the same numpy inputs; then the gate's
behaviour on the port's own demo artifact (the cases of the JAX package's
``tests/test_canary.py`` that read no journal): a degraded generation
rejected while the old model keeps serving bit for bit, a clean one
promoted to the bytes immediate mode serves, the quarantine, the failed
load remembered, the per-tenant fleet gates and the ``--promote canary``
commands.  Servers bind port 0; every HTTP call has a timeout; reload
polls are driven by hand.
"""

import json
import os
import shutil
import urllib.request

import numpy as np
import pytest
import torch

from fed_tgan_torch.__main__ import main as port_main
from fed_tgan_torch.federation.sketch import column_grids, wd_scores
from fed_tgan_torch.interop import convert_jax_artifact
from fed_tgan_torch.runtime.checkpoint import (
    SYNTH_DIR,
    checkpoint_fingerprint,
    is_valid_synthesizer,
)
from fed_tgan_torch.serve import service as service_mod
from fed_tgan_torch.serve.canary import (
    CanaryConfig,
    CanaryGate,
    compute_reference_stats,
    load_reference_stats,
    ml_efficacy_probe,
    reference_stats_path,
    score_frame,
)
from fed_tgan_torch.serve.demo import (
    build_demo_artifact,
    demo_frame,
    republish_demo_candidate,
)
from fed_tgan_torch.serve.fleet import FleetRegistry, FleetService
from fed_tgan_torch.serve.metrics import QualityStore
from fed_tgan_torch.serve.registry import (
    ModelRegistry,
    load_model,
    resolve_artifact,
)
from fed_tgan_torch.serve.service import SamplingService
from fed_tgan_torch.testing.faults import (
    FaultPlan,
    degrade_checkpoint,
    install_plan,
)

torch.set_num_threads(2)

_silent = lambda *a, **k: None  # noqa: E731


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    return build_demo_artifact(str(tmp_path_factory.mktemp("torch_canary")),
                               device="cpu")


@pytest.fixture
def root(artifact_dir, tmp_path):
    path = str(tmp_path / "artifact")
    shutil.copytree(artifact_dir, path)
    return path


def _synth(root):
    return os.path.join(root, "models", SYNTH_DIR)


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _canary_service(root, **kw):
    return SamplingService(
        ModelRegistry(root, device="cpu", log=_silent), port=0, max_batch=4,
        queue_size=32, promote="canary",
        canary_config=CanaryConfig(shadow_rows=256), log=_silent,
        **kw).start()


def _frame_pair(rows=400, seed=3):
    """The same demo table as the port's column dict and a DataFrame."""
    import pandas as pd

    frame = demo_frame(rows, seed)
    return frame, pd.DataFrame({k: np.asarray(v) for k, v in frame.items()})


# ------------------------------------------------------ parity with JAX


def test_demo_frame_draws_equal_jax():
    from fed_tgan_tpu.serve.demo import demo_frame as jax_frame

    frame, theirs = demo_frame(300, 5), jax_frame(300, 5)
    assert list(frame) == list(theirs.columns)
    for col in frame:
        np.testing.assert_array_equal(np.asarray(frame[col]),
                                      theirs[col].to_numpy())


def test_reference_stats_equal_jax(tmp_path):
    """Equal dicts on the demo table and on a CSV with integer,
    float and string categories, missing cells and count ties (freqs and
    values compared with ``==``)."""
    import pandas as pd

    from fed_tgan_torch.data.csvio import read_csv
    from fed_tgan_tpu.serve.canary import compute_reference_stats as jax_stats

    frame, df = _frame_pair()
    assert compute_reference_stats(frame, ["color", "flag"], probe_rows=64,
                                   name="demo") == \
        jax_stats(df, ["color", "flag"], probe_rows=64, name="demo")
    rng = np.random.default_rng(7)
    path = tmp_path / "mixed.csv"
    with open(path, "w") as f:
        f.write("k,x,s,y\n")
        for i in range(300):
            k = "" if i % 17 == 0 else str(rng.integers(0, 4))
            s = "" if i % 23 == 0 else rng.choice(["b", "a", "c"])
            y = "" if i % 29 == 0 else f"{rng.normal():.4f}"
            f.write(f"{k},{rng.integers(0, 3)}.5,{s},{y}\n")
    ours = compute_reference_stats(read_csv(str(path)), ["k", "x", "s"],
                                   max_values=32, probe_rows=40)
    theirs = jax_stats(pd.read_csv(path), ["k", "x", "s"], max_values=32,
                       probe_rows=40)
    # the probe rows hold NaN (never == itself): compare the JSON text,
    # which keeps every key's order and every float's digits
    assert json.dumps(ours) == json.dumps(theirs)
    assert {k: v for k, v in ours.items() if k != "probe"} == \
        {k: v for k, v in theirs.items() if k != "probe"}


@pytest.mark.parametrize("case", ["own", "shifted", "dropped"])
def test_score_frame_matches_jax(case):
    from fed_tgan_tpu.serve.canary import compute_reference_stats as jax_stats
    from fed_tgan_tpu.serve.canary import score_frame as jax_score

    frame, df = _frame_pair()
    stats = compute_reference_stats(frame, ["color", "flag"])
    other, odf = _frame_pair(256, 11)
    if case == "shifted":
        other["amount"] = other["amount"] + 1000.0
        odf["amount"] = odf["amount"] + 1000.0
    elif case == "dropped":
        del other["score"]
        odf = odf.drop(columns=["score"])
    ours = score_frame(stats, other, device="cpu")
    theirs = jax_score(jax_stats(df, ["color", "flag"]), odf)
    assert abs(ours["avg_jsd"] - theirs["avg_jsd"]) <= 1e-12
    assert abs(ours["avg_wd"] - theirs["avg_wd"]) <= 1e-5
    assert set(ours["per_column"]) == set(theirs["per_column"])
    for col, got in ours["per_column"].items():
        want = theirs["per_column"][col]
        assert got["kind"] == want["kind"]
        tol = 1e-12 if got["kind"] == "jsd" else 1e-5
        assert abs(got["value"] - want["value"]) <= tol, col


@pytest.mark.parametrize("n,c,k", [(2, 4, 256), (2, 3, 9), (3, 2, 5)])
def test_wd_scores_match_jax_impl(n, c, k):
    import jax.numpy as jnp

    from fed_tgan_tpu.federation.sketch import _wd_fn

    rng = np.random.default_rng(n * 100 + k)
    means = rng.normal(0.0, 1.0, (n, c, k))
    stds = rng.uniform(1e-3, 0.5, (n, c, k))
    weights = rng.uniform(0.0, 1.0, (n, c, k))
    weights[:, :, -1] = 0.0  # zero-weight padding
    weights /= weights.sum(-1, keepdims=True)
    omega = np.zeros(n)
    omega[0] = 1.0
    grid = column_grids(means, stds, weights)
    args = (means, stds, weights, omega, grid)
    want = np.asarray(_wd_fn()(*(jnp.asarray(a, jnp.float32) for a in args)))
    got = wd_scores(*(torch.tensor(a, dtype=torch.float32) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_ml_efficacy_probe_matches_jax():
    pytest.importorskip("sklearn")
    from fed_tgan_tpu.serve.canary import ml_efficacy_probe as jax_probe

    frame, df = _frame_pair()
    stats = compute_reference_stats(frame, ["flag", "color"], probe_rows=64)
    other, odf = _frame_pair(300, 9)
    got = ml_efficacy_probe(stats, other)
    assert got is not None and got == jax_probe(stats, odf)


def test_degraded_weights_equal_jax(artifact_dir, tmp_path):
    """JAX's degraded artifact converted to the port equals the port's
    degrade of the converted clean artifact: the same matrix scaled, and
    nothing else."""
    from fed_tgan_tpu.serve.demo import build_demo_artifact as jax_build
    from fed_tgan_tpu.testing.faults import degrade_checkpoint as jax_degrade

    jax_root = jax_build(str(tmp_path / "jax"), rows=120, epochs=0)
    convert_jax_artifact(jax_root, str(tmp_path / "clean"))
    degrade_checkpoint(_synth(str(tmp_path / "clean")), 100.0)
    jax_degrade(os.path.join(jax_root, "models", "synthesizer"), 100.0)
    convert_jax_artifact(jax_root, str(tmp_path / "degraded"))
    with np.load(os.path.join(_synth(str(tmp_path / "clean")),
                              "weights.npz")) as a, \
            np.load(os.path.join(_synth(str(tmp_path / "degraded")),
                                 "weights.npz")) as b:
        assert a.files == b.files
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert os.path.exists(reference_stats_path(
        str(tmp_path / "clean" / "models"), "demo"))


def test_quality_store_text_equals_jax():
    from fed_tgan_tpu.serve.metrics import QualityStore as JaxStore

    ours, theirs = QualityStore(), JaxStore()
    for store in (ours, theirs):
        assert store.render_prometheus() == ""
        store.record_scores("b", 0.5, None)
        store.record_decision("b", True)
        store.record_scores("a", 0.0125, 0.25)
        store.record_decision("a", False)
        store.record_decision("a", True)
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.snapshot() == theirs.snapshot()


# -------------------------------------------------------- the port alone


def test_build_demo_artifact_writes_reference_stats(artifact_dir):
    stats = load_reference_stats(reference_stats_path(
        os.path.join(artifact_dir, "models"), "demo"))
    assert stats["source"] == "training_data"
    assert sorted(stats["categorical"]) == ["color", "flag"]
    assert sorted(stats["continuous"]) == ["amount", "score"]
    amount = stats["continuous"]["amount"]
    assert amount["min"] < amount["max"] and amount["values"]
    assert len(stats["probe"]["rows"]) == 64
    # the statistics file is never taken for a run meta
    assert resolve_artifact(artifact_dir, log=_silent).name == "demo"


def test_score_frame_self_score_near_zero_and_orders_shift():
    frame = demo_frame(rows=400, seed=3)
    stats = compute_reference_stats(frame, ["color", "flag"])
    own = score_frame(stats, frame, device="cpu")
    assert own["avg_jsd"] == pytest.approx(0.0, abs=1e-9)
    assert own["avg_wd"] < 0.05
    assert set(own["per_column"]) == {"amount", "score", "color", "flag"}
    shifted = dict(frame, amount=frame["amount"] + 1000.0)
    bad = score_frame(stats, shifted, device="cpu")
    assert bad["avg_wd"] > own["avg_wd"]
    assert bad["per_column"]["amount"]["value"] > 0.5
    dropped = {k: v for k, v in frame.items() if k != "score"}
    assert score_frame(stats, dropped, device="cpu")["per_column"][
        "score"]["value"] == 1.0


def test_degrade_checkpoint_valid_but_new_fingerprint(root):
    before = checkpoint_fingerprint(_synth(root))
    degrade_checkpoint(_synth(root), 100.0)
    assert is_valid_synthesizer(_synth(root))
    assert checkpoint_fingerprint(_synth(root)) != before
    load_model(resolve_artifact(root, log=_silent), device="cpu")


def test_degrade_snapshot_fault_parsing():
    plan = FaultPlan.parse("degrade_snapshot:100")
    assert (plan.degrade_factor, plan.degrade_nth) == (100.0, 1)
    plan = FaultPlan.parse("degrade_snapshot:factor=0.5,nth=2")
    assert (plan.degrade_factor, plan.degrade_nth) == (0.5, 2)
    with pytest.raises(ValueError, match="needs factor"):
        FaultPlan.parse("degrade_snapshot:nth=2")
    with pytest.raises(ValueError, match="degrade_snapshot"):
        FaultPlan.parse("degrade_snapsho:100")


def test_degrade_fault_fires_on_nth_snapshot_publish(root):
    npz = os.path.join(_synth(root), "weights.npz")

    def first_weight():
        with np.load(npz) as z:
            return z["generator.blocks.0.fc.weight"], {
                k: z[k] for k in z.files
                if k != "generator.blocks.0.fc.weight"}

    before, rest = first_weight()
    install_plan(FaultPlan.parse("degrade_snapshot:factor=50,nth=2"))
    try:
        republish_demo_candidate(root, device="cpu")  # publish 1: clean
        np.testing.assert_array_equal(first_weight()[0], before)
        republish_demo_candidate(root, device="cpu")  # publish 2: degraded
        after, rest_after = first_weight()
        np.testing.assert_array_equal(after, (before * 50.0)
                                      .astype(before.dtype))
        for key, val in rest.items():
            np.testing.assert_array_equal(rest_after[key], val)
    finally:
        install_plan(None)


def test_degraded_snapshot_rejected_old_model_serves(root):
    svc = _canary_service(root)
    try:
        first_id = svc.registry.get().model_id
        before = _get(f"{svc.url}/sample?rows=40&seed=7")
        degrade_checkpoint(_synth(root), 100.0)
        svc._maybe_reload()
        decision = svc.gate.last_decision
        assert decision is not None and decision["promoted"] is False
        assert decision["tripped"] and decision["per_column"]
        assert any(abs(v["delta"]) > 0
                   for v in decision["per_column"].values())
        assert decision["model_id"] == first_id
        assert decision["candidate"] != first_id
        assert svc.registry.get().model_id == first_id
        assert _get(f"{svc.url}/sample?rows=40&seed=7") == before
        # quarantine: the same bytes re-statted are never scored again
        scored = svc.gate.scored_total
        os.utime(os.path.join(_synth(root), "weights.npz"))
        svc._maybe_reload()
        assert svc.gate.scored_total == scored
        assert svc.gate.rejections == 1
        metrics = _get(f"{svc.url}/metrics").decode()
        assert 'fed_tgan_quality_rejections_total{tenant="demo"} 1' \
            in metrics
        assert 'fed_tgan_quality_jsd{tenant="demo"}' in metrics
        health = json.loads(_get(f"{svc.url}/healthz"))
        assert health["promotion"]["mode"] == "canary"
        assert health["promotion"]["rejections"] == 1
        assert health["promotion"]["quarantined"] == [decision["candidate"]]
        assert health["model_id"] == first_id
        assert svc.metrics.reloads_total == 0
    finally:
        svc.shutdown(drain=False)


def test_clean_candidate_promotes_bit_identical_to_immediate(root,
                                                             tmp_path):
    svc = _canary_service(root)
    try:
        first_id = svc.registry.get().model_id
        republish_demo_candidate(root, device="cpu")
        svc._maybe_reload()
        decision = svc.gate.last_decision
        assert decision["promoted"] is True and not decision["tripped"]
        assert svc.registry.get().model_id != first_id
        served = _get(f"{svc.url}/sample?rows=40&seed=7")
        metrics = _get(f"{svc.url}/metrics").decode()
        assert 'fed_tgan_quality_promotions_total{tenant="demo"} 1' \
            in metrics
    finally:
        svc.shutdown(drain=False)
    out = tmp_path / "rows.csv"
    assert port_main(["--sample-from", root, "--sample-rows", "40", "--seed",
                      "7", "--out", str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == served
    # and an immediate-mode service of the same generation serves them
    plain = SamplingService(ModelRegistry(root, device="cpu", log=_silent),
                            port=0, log=_silent).start()
    try:
        assert _get(f"{plain.url}/sample?rows=40&seed=7") == served
        assert "fed_tgan_quality" not in \
            _get(f"{plain.url}/metrics").decode()
        assert json.loads(_get(f"{plain.url}/healthz"))["promotion"] == {
            "mode": "immediate"}
    finally:
        plain.shutdown(drain=False)


def test_ml_probe_gates_on_the_accuracy_drop(root):
    """``ml_probe`` adds the accuracy drop against the probe rows to the
    figures the budgets read (sklearn where it imports)."""
    pytest.importorskip("sklearn")
    reg = ModelRegistry(root, device="cpu", log=_silent)
    svc = SamplingService(reg, port=0, promote="canary", log=_silent,
                          canary_config=CanaryConfig(shadow_rows=256,
                                                     ml_probe=True))
    republish_demo_candidate(root, device="cpu")
    svc._maybe_reload()
    decision = svc.gate.last_decision
    assert "ml_acc_delta" in decision
    assert decision["promoted"] is (decision["ml_acc_delta"] <= 0.2
                                    and not decision["tripped"])


def test_derived_stats_reject_the_degraded_generation(root):
    """Without a statistics file the gate derives them from the serving
    model's own shadow sample and still rejects a degraded generation."""
    os.remove(reference_stats_path(os.path.join(root, "models"), "demo"))
    engine_reg = ModelRegistry(root, device="cpu", log=_silent)
    svc = SamplingService(engine_reg, port=0, promote="canary",
                          canary_config=CanaryConfig(shadow_rows=256),
                          log=_silent)
    first_id = engine_reg.get().model_id
    degrade_checkpoint(_synth(root), 100.0)
    svc._maybe_reload()
    decision = svc.gate.last_decision
    assert decision["promoted"] is False and decision["tripped"]
    assert svc.gate._stats_cache.stats["source"] == "derived_incumbent"
    assert engine_reg.get().model_id == first_id
    # the statistics sample, the baseline and the candidate
    assert svc.gate.shadow_samples == 3


def test_unsampleable_candidate_is_rejected_not_promoted(root,
                                                         monkeypatch):
    reg = ModelRegistry(root, device="cpu", log=_silent)
    svc = SamplingService(reg, port=0, promote="canary", log=_silent)
    first_id = reg.get().model_id

    def broken(model):
        raise RuntimeError("no shadow path")

    monkeypatch.setattr(svc.engine, "shadow_snapshot", broken)
    republish_demo_candidate(root, device="cpu")
    svc._maybe_reload()
    decision = svc.gate.last_decision
    assert decision["promoted"] is False
    assert decision["tripped"] == ["shadow_error"]
    assert "no shadow path" in decision["error"]
    assert reg.get().model_id == first_id


def test_reload_failure_remembered_not_respammed(artifact_dir, root):
    """A generation that fails to load is logged once, not on every poll,
    by the immediate reload and by the gate alike."""
    enc = os.path.join(root, "models", "label_encoders_demo.json")
    logs = []
    reg = ModelRegistry(root, device="cpu", log=logs.append)
    first_id = reg.get().model_id
    gate_logs = []
    gate_reg = ModelRegistry(root, device="cpu", log=gate_logs.append)
    gate_reg.get()
    gate = CanaryGate(gate_reg, None, tenant="demo", log=gate_logs.append)
    republish_demo_candidate(root, device="cpu")  # moves the signature
    # the encoder file is not in the signature: the garbage passes the
    # validity probe and fails inside the load
    with open(enc, "w") as f:
        f.write("not json")
    assert reg.maybe_reload() is False
    assert reg.get().model_id == first_id
    assert any("reload failed" in line for line in logs)
    n_logs = len(logs)
    assert reg.maybe_reload() is False  # remembered: no retry storm
    assert len(logs) == n_logs
    for _ in range(2):
        assert gate.consider() is None
        assert sum("failed to load" in line for line in gate_logs) == 1
    assert gate.scored_total == 0 and gate.rejections == 0


def test_fleet_canary_gates_decide_per_tenant(artifact_dir, tmp_path):
    """Two tenants under canary: one gets a degraded publish, the other a
    clean one.  Each decides alone, the rejected model never enters a
    lane group, and ``/fleet`` shows both states."""
    roots = {}
    for name in ("good", "bad"):
        roots[name] = str(tmp_path / name)
        shutil.copytree(artifact_dir, roots[name])
    fleet = FleetRegistry(promote="canary", device="cpu", log=_silent)
    for name, path in roots.items():
        assert isinstance(fleet.load(name, path).gate, CanaryGate)
    svc = FleetService(fleet, port=0, log=_silent)  # not started
    before = {n: fleet.get(n).registry.get().model_id for n in roots}
    republish_demo_candidate(roots["good"], device="cpu")
    degrade_checkpoint(_synth(roots["bad"]), 100.0)
    svc._maybe_reload()
    good, bad = fleet.get("good").gate, fleet.get("bad").gate
    assert good.last_decision["promoted"] is True
    assert bad.last_decision["promoted"] is False
    rejected = bad.last_decision["candidate"]
    assert fleet.get("good").registry.get().model_id != before["good"]
    assert fleet.get("bad").registry.get().model_id == before["bad"]
    status = {t["name"]: t["promotion"]
              for t in svc.fleet_status()["tenants"]}
    assert status["good"]["promotions"] == 1
    assert status["bad"]["quarantined"] == [rejected]
    text = svc.metrics.render_prometheus()
    assert 'fed_tgan_quality_promotions_total{tenant="good"} 1' in text
    assert 'fed_tgan_quality_rejections_total{tenant="bad"} 1' in text
    # a lane dispatch of both tenants: the rejected id is in no group
    snaps = [fleet.get(n).engine.snapshot() for n in ("good", "bad")]
    svc.lane_group(snaps)
    assert not any(rejected in str(key) for key in fleet.cache.keys())
    # the default immediate policy keeps the tenant gate-free
    plain = FleetRegistry(device="cpu", log=_silent).load("t0", artifact_dir)
    assert plain.gate is None


def test_quality_store_renders_only_after_decisions():
    store = QualityStore()
    assert store.render_prometheus() == ""
    store.record_scores("demo", 0.01, 0.02)
    store.record_decision("demo", False)
    text = store.render_prometheus()
    assert 'fed_tgan_quality_jsd{tenant="demo"} 0.01' in text
    assert 'fed_tgan_quality_wd{tenant="demo"} 0.02' in text
    assert 'fed_tgan_quality_rejections_total{tenant="demo"} 1' in text


@pytest.mark.parametrize("command", ["serve", "fleet"])
def test_promote_canary_commands_start(command, artifact_dir, monkeypatch,
                                       capsys):
    """``serve`` and ``fleet`` take ``--promote canary``: the service
    starts with a gate and answers ``/healthz`` with its state."""
    seen = {}

    def stop(name, service):
        seen["health"] = json.loads(_get(f"{service.url}/healthz"))
        seen["fleet"] = (json.loads(_get(f"{service.url}/fleet"))
                         if name == "fleet" else None)
        service.shutdown(drain=False)

    monkeypatch.setattr(service_mod, "wait_for_interrupt", stop)
    from fed_tgan_torch.serve import fleet as fleet_mod

    monkeypatch.setattr(fleet_mod, "wait_for_interrupt", stop)
    target = artifact_dir if command == "serve" else f"a={artifact_dir}"
    assert port_main([command, target, "--device", "cpu", "--port", "0",
                      "--promote", "canary", "--quiet"]) == 0
    if command == "serve":
        assert seen["health"]["promotion"]["mode"] == "canary"
    else:
        assert seen["fleet"]["tenants"][0]["promotion"]["mode"] == "canary"
    assert "serving" in capsys.readouterr().out
