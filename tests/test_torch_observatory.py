"""The port's live observatory against the JAX package's: the cases of
``tests/test_observatory.py`` on ``fed_tgan_torch.obs``, and the port held
to JAX where both speak:

- **exporter**: lifecycle and endpoints, the installed journal as
  fallback, ``?follow=1`` keeping up with concurrent writes, ``obs watch``
  over a URL and its live SLO alarm;
- **cross-reading**: journals written by either package summarize alike
  through either package's ``summarize`` / ``summarize_many`` (the
  multi-rank merge order-independent), and every reader skips a torn
  last line with a warning as JAX's does;
- **schema**: every event of journaled CPU runs of the port -- fedavg
  with a ``scale_update`` quarantine, the monitor, checkpoints and a
  resume; churn; a cohort with a buffered straggler; a 2-participant
  world; the canary and the fleet -- passes JAX's
  ``RunJournal._check_schema``;
- **contributions**: on injected JAX draws (the round-parity harness of
  ``test_torch_federated.py``) the port's ``client_contribution`` weights
  equal JAX's within 1e-6 and its losses lie within the round tolerance;
- **host copies and results**: a journaled, exported round makes as many
  ``FederatedTrainer._to_host`` copies as a plain one and ends
  ``torch.equal`` to it.

The module's autouse fixture asserts that the port's
``validation_violations()`` stay empty.
"""

import argparse
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

os.environ.setdefault("FED_TGAN_TORCH_VALIDATE_JOURNAL", "1")

from fed_tgan_torch import cli as port_cli  # noqa: E402
from fed_tgan_torch.obs import (  # noqa: E402
    HealthState,
    RunJournal,
    TelemetryExporter,
    get_health,
    get_registry,
    read_journal,
    set_journal,
)
from fed_tgan_torch.obs import report as port_report  # noqa: E402
from fed_tgan_torch.obs import slo as port_slo  # noqa: E402
from fed_tgan_torch.obs import watch as port_watch  # noqa: E402
from fed_tgan_torch.obs.journal import validation_violations  # noqa: E402
from fed_tgan_torch.serve.demo import write_intrusion_csv  # noqa: E402
from fed_tgan_tpu.obs import report as jax_report  # noqa: E402
from fed_tgan_tpu.obs import slo as jax_slo  # noqa: E402
from fed_tgan_tpu.obs import watch as jax_watch  # noqa: E402
from fed_tgan_tpu.obs.journal import RunJournal as JaxJournal  # noqa: E402

pytestmark = pytest.mark.obs
torch.set_num_threads(1)
_silent = lambda *a, **k: None  # noqa: E731


@pytest.fixture(autouse=True)
def _obs_uninstalled():
    """No test leaks a process journal or health fields, and no journal
    of the port saw an event off the schema."""
    yield
    set_journal(None)
    get_health().reset()
    assert validation_violations() == []


def _get(url: str, timeout: float = 10.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _jax_check(events: list) -> list:
    """``(type, problem, field)`` of every event JAX's sanitizer rejects."""
    bad = []
    for e in events:
        fields = {k: v for k, v in e.items() if k not in ("ts", "type")}
        bad += [(e["type"], *p) for p in
                JaxJournal._check_schema(None, e["type"], fields)]
    return bad


# ------------------------------------------------------ exporter lifecycle


def test_exporter_lifecycle_and_endpoints(tmp_path):
    jpath = str(tmp_path / "run.jsonl")
    with RunJournal(jpath, run_id="lifecycle") as j:
        j.emit("round", first=0, last=0, rounds=1, per_round_s=0.5)
    health = HealthState()
    health.update(status="training", round=7)
    get_registry().counter("obsv_lifecycle_total", "test counter").inc(3)
    exp = TelemetryExporter(port=0, journal_path=jpath, health=health)
    with exp:
        assert exp.port != 0
        assert "obsv_lifecycle_total 3" in _get(exp.url + "/metrics").decode()
        snap = json.loads(_get(exp.url + "/healthz"))
        assert snap["status"] == "training" and snap["round"] == 7
        with urllib.request.urlopen(exp.url + "/journal", timeout=10) as r:
            body = r.read().decode()
            offset = int(r.headers["X-Journal-Offset"])
        assert [json.loads(ln)["type"] for ln in body.splitlines()] == \
            ["run_start", "round", "run_end"]
        assert offset == os.path.getsize(jpath)
        with urllib.request.urlopen(f"{exp.url}/journal?offset={offset}",
                                    timeout=10) as r:
            assert r.read() == b""
        with pytest.raises(urllib.error.HTTPError):
            _get(exp.url + "/nope")
    with pytest.raises(OSError):
        _get(exp.url + "/metrics", timeout=1.0)


def test_exporter_journal_falls_back_to_installed(tmp_path):
    with TelemetryExporter(port=0) as exp:
        with pytest.raises(urllib.error.HTTPError):  # none installed
            _get(exp.url + "/journal")
        j = RunJournal(str(tmp_path / "late.jsonl"), run_id="late")
        set_journal(j)
        try:
            assert '"run_start"' in _get(exp.url + "/journal").decode()
        finally:
            set_journal(None)
            j.close()


def test_journal_follow_streams_concurrent_writes(tmp_path):
    jpath = str(tmp_path / "follow.jsonl")
    journal = RunJournal(jpath, run_id="follow")
    exp = TelemetryExporter(port=0, journal_path=jpath).start()
    got: list = []
    done = threading.Event()

    def reader():
        with urllib.request.urlopen(exp.url + "/journal?follow=1",
                                    timeout=30) as resp:
            buf = b""
            while True:
                chunk = resp.read(1)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    got.append(json.loads(line))
        done.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        for i in range(20):
            journal.emit("round", first=i, last=i, rounds=1)
            time.sleep(0.005)
        deadline = time.time() + 10
        while time.time() < deadline and sum(
                e.get("type") == "round" for e in got) < 20:
            time.sleep(0.05)
        assert [e["first"] for e in got if e.get("type") == "round"] == \
            list(range(20))
    finally:
        exp.shutdown()
        journal.close()
    assert done.wait(timeout=10), "follow stream did not end on drain"


# ------------------------------------------------- crash-tolerant readers


def _torn_journal(tmp_path) -> str:
    path = str(tmp_path / "torn.jsonl")
    with RunJournal(path, run_id="torn") as j:
        j.emit("round", first=0, last=0, rounds=1, per_round_s=0.25)
        j.emit("round", first=1, last=1, rounds=1, per_round_s=0.25)
    with open(path) as fh:
        lines = fh.readlines()
    with open(path, "w") as fh:
        fh.writelines(lines[:-1])
        fh.write(lines[-1][:20])
    return path


def _watch_args(sources, **kw):
    return argparse.Namespace(**{**dict(
        source=list(sources), follow=False, interval=0.05, slo_every=25,
        budgets=None, max_seconds=None), **kw})


@pytest.mark.parametrize("tool", ["report", "slo", "watch"])
def test_readers_skip_a_torn_tail_as_jax_does(tmp_path, capsys, tool):
    """A crashed writer's last line is skipped with a warning on stderr,
    and the rest read as the JAX reader reads it."""
    path = _torn_journal(tmp_path)
    outs = []
    for mods in ((port_report, port_slo, port_watch),
                 (jax_report, jax_slo, jax_watch)):
        report, slo, watch = mods
        if tool == "report":
            warnings: list = []
            s = report.summarize(path, on_skip=warnings.append)
            assert s["events"] == 3 and len(warnings) == 1
            code = report.report_main(path, fmt="json")
        elif tool == "slo":
            code = slo.check_slo(path, slo.default_budgets_path())[0]
        else:
            code = watch.watch_main(_watch_args([path]))
        out, err = capsys.readouterr()
        assert code == 0 and "truncated journal line" in err
        outs.append((out.replace(path, "P"), err.replace(
            "obs report", "obs").replace("obs watch", "obs")))
    if tool == "report":
        port, ref = (json.loads(o[0]) for o in outs)
        assert port == ref
    else:
        assert outs[0] == outs[1]
    if tool == "watch":
        assert "[watch] round 1 (2 seen)" in outs[0][0]


def test_watch_breach_alerts_and_lands_in_journal(tmp_path, capsys):
    path = str(tmp_path / "run.jsonl")
    with RunJournal(path, run_id="breach") as j:
        j.emit("round", first=0, last=0, rounds=1, per_round_s=0.5)
        j.emit("program_cost", name="toy_prog", family="toy", flops=5000,
               bytes_accessed=10, peak_bytes=10)
    budgets = tmp_path / "budgets.json"
    budgets.write_text(json.dumps({"schema": 1, "budgets": [
        {"name": "toy-flops-ceiling", "metric": "program/toy_prog/flops",
         "max": 1000.0}]}))
    args = _watch_args([path], slo_every=1, budgets=str(budgets))
    assert port_watch.watch_main(args) == 1
    out = capsys.readouterr().out
    assert "ALERT REGRESSION toy-flops-ceiling" in out
    assert "slo BREACH" in out
    breaches = [e for e in read_journal(path) if e["type"] == "slo_breach"]
    assert len(breaches) == 1 and breaches[0]["rules"] == \
        ["toy-flops-ceiling"]
    assert not _jax_check(breaches)
    assert port_report.summarize(path)["by_type"]["slo_breach"] == 1


def test_watch_polls_exporter_url(tmp_path, capsys):
    jpath = str(tmp_path / "url.jsonl")
    journal = RunJournal(jpath, run_id="url")
    set_journal(journal)
    exp = TelemetryExporter(port=0).start()
    try:
        journal.emit("round", first=0, last=0, rounds=1, per_round_s=0.2)
        assert port_watch.watch_main(_watch_args([exp.url])) == 0
        assert "[watch] round 0 (1 seen)" in capsys.readouterr().out
    finally:
        exp.shutdown()
        set_journal(None)
        journal.close()


# ------------------------------------------------- multi-rank journal merge


def _rank_journals(tmp_path, journal_cls=RunJournal):
    """A 2-participant run: rank 0's rounds, each participant's rounds
    and its client's contributions."""
    paths = []
    for rank, client in ((0, None), (1, 0), (2, 1)):
        path = str(tmp_path / f"journal_rank{rank}.jsonl")
        with journal_cls(path, run_id="mh") as j:
            for rnd in range(3):
                if rank == 0:
                    j.emit("round", first=rnd, last=rnd, rounds=1,
                           role="server", per_round_s=0.5)
                else:
                    j.emit("round", first=rnd, last=rnd, rounds=1,
                           role="client", rank=rank, per_round_s=0.6)
                    j.emit("client_contribution", round=rnd, first=rnd,
                           rounds_per_program=1, rank=rank,
                           clients=[client], weights=[0.5],
                           loss_d=[-0.1 * (client + 1)],
                           loss_g=[0.2 * (client + 1)],
                           quarantined=[0], strikes=[0])
        paths.append(path)
    return paths


def _normalized(summary):
    s = dict(summary)
    for k in ("path", "paths", "run_id", "duration_s"):
        s.pop(k, None)
    return s


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_multirank_merge_reads_alike_in_both_packages(tmp_path, writer):
    """Rank journals written by either package merge into one federation
    view (3 rounds, not 9; both clients' contributions) that the port and
    JAX summarize alike, whatever the order of the files."""
    paths = _rank_journals(tmp_path, RunJournal if writer == "port"
                           else JaxJournal)
    port = _normalized(port_report.summarize_many(paths))
    assert port == _normalized(port_report.summarize_many(paths[::-1]))
    assert port == _normalized(jax_report.summarize_many(paths))
    assert port["rounds"]["total_rounds"] == 3
    cl = port["clients"]
    assert cl["tracked"] == 2 and cl["rounds"] == 3
    assert cl["per_client"]["1"]["loss_g_last"] == pytest.approx(0.4)
    text = port_report.render_text(port_report.summarize_many(paths))
    assert "clients: 2 tracked over 3 round(s)" in text


def test_merge_without_server_prefers_lowest_rank(tmp_path):
    paths = _rank_journals(tmp_path)[1:]
    assert port_report.summarize_many(paths)["rounds"]["total_rounds"] == 3


# ----------------------------------- the trainer: ledger, health, copies


def _small_cfg(**kw):
    from fed_tgan_torch.train.steps import TrainConfig

    return TrainConfig(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),
                       batch_size=40, pac=4, **kw)


def _init(n_clients=2, seed=3):
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize

    rng = np.random.default_rng(seed)
    tables = [{"x": np.round(rng.normal(0, 1, 120), 3),
               "c": rng.choice(["a", "b", "c"], 120).astype(object)}
              for _ in range(n_clients)]
    return federated_initialize(
        [TablePreprocessor(table=t, categorical_columns=["c"])
         for t in tables], seed=0, device="cpu")


@pytest.fixture(scope="module")
def init2():
    return _init(2)


def _state(tr):
    st = tr.stack
    return [st.generator.params, st.generator.bn_state,
            st.discriminator.params, st.opt_g.exp_avg_sq, st.opt_d.exp_avg,
            st.opt_d.count] + [g.get_state() for g in tr.gens]


def test_contribution_ledger_rides_the_one_host_copy(init2, tmp_path):
    """With a journal and the exporter, two rounds emit one
    client_contribution per round, refresh the labelled series and answer
    live scrapes -- with as many host copies as a plain run and a final
    state torch.equal to it."""
    from fed_tgan_torch.train.federated import FederatedTrainer

    plain = FederatedTrainer(init2, _small_cfg(), seed=0, device="cpu")
    plain.fit(2)
    tr = FederatedTrainer(init2, _small_cfg(), seed=0, device="cpu")
    jpath = str(tmp_path / "gate.jsonl")
    journal = RunJournal(jpath, run_id="gate")
    set_journal(journal)
    try:
        with TelemetryExporter(port=0, journal_path=jpath) as exp:
            tr.fit(2)
            metrics = _get(exp.url + "/metrics").decode()
            health = json.loads(_get(exp.url + "/healthz"))
    finally:
        set_journal(None)
        journal.close()
    assert tr.host_copies == plain.host_copies == 2
    for a, b in zip(_state(plain), _state(tr)):
        assert torch.equal(a, b)
    contribs = [e for e in read_journal(jpath)
                if e["type"] == "client_contribution"]
    assert [e["round"] for e in contribs] == [0, 1]
    for ev in contribs:
        assert ev["clients"] == [0, 1] and ev["first"] == ev["round"]
        assert ev["quarantined"] == [0, 0] and ev["strikes"] == [0, 0]
        assert all(isinstance(v, float) for v in ev["loss_d"] + ev["loss_g"])
        assert abs(sum(ev["weights"]) - 1.0) <= 1e-6
        np.testing.assert_array_equal(ev["weights"], tr.weights)
    for c in ("0", "1"):
        assert f'fed_tgan_client_weight{{client="{c}"}}' in metrics
        assert f'fed_tgan_client_strikes{{client="{c}"}}' in metrics
    assert health["status"] == "training"
    assert health["round"] == 1 and health["live_clients"] == 2
    cl = port_report.summarize(jpath)["clients"]
    assert cl["tracked"] == 2 and cl["rounds"] == 2
    assert not _jax_check(list(read_journal(jpath)))


def test_no_journal_means_no_ledger_but_health(init2):
    from fed_tgan_torch.train.federated import FederatedTrainer

    tr = FederatedTrainer(init2, _small_cfg(), seed=0, device="cpu")
    tr.fit(1)
    health = get_health().snapshot()
    assert health["status"] == "training" and health["population"] == 2
    assert tr.host_copies == 1


def test_quarantine_forensics_name_client_round_and_test(tmp_path):
    """A ``scale_update`` fault on client 1 is journaled as quarantines
    naming the client, the round and the test (``norm_outlier``), then
    its drop; ``obs report`` tells it so."""
    from fed_tgan_torch.testing.faults import FaultPlan, install_plan
    from fed_tgan_torch.train.federated import FederatedTrainer

    jpath = str(tmp_path / "faulty.jsonl")
    install_plan(FaultPlan.parse("scale_update:factor=1000,rank=2"))
    try:
        tr = FederatedTrainer(_init(3), _small_cfg(), seed=0, device="cpu",
                              min_clients=1, quarantine_strikes=2)
        with RunJournal(jpath, run_id="faulty") as j:
            set_journal(j)
            try:
                tr.fit(3)
            finally:
                set_journal(None)
    finally:
        install_plan(None)
    assert tr.dropped_clients == {1}
    s = port_report.summarize(jpath)
    forensics = s["clients"]["forensics"]
    assert forensics and all(f["client"] == 1 and f["test"] == "norm_outlier"
                             for f in forensics)
    assert any(f.get("dropped") for f in forensics)
    assert s["clients"]["per_client"]["1"]["quarantined_rounds"] >= 1
    text = port_report.render_text(s)
    assert "forensics: client 1" in text and "test=norm_outlier" in text
    assert _normalized(s) == _normalized(jax_report.summarize(jpath))
    assert not _jax_check(list(read_journal(jpath)))


def test_monitorlog_csv_byte_identical_and_similarity_event(tmp_path):
    from fed_tgan_torch.train.monitor import MonitorLog

    plain = tmp_path / "plain.csv"
    with MonitorLog(str(plain)) as log:
        log.append(0, 0.5, 0.125)
        log.append(2, 0.25, 0.0625)
    journaled = tmp_path / "journaled.csv"
    jpath = str(tmp_path / "mon.jsonl")
    with RunJournal(jpath, run_id="mon") as j:
        set_journal(j)
        try:
            with MonitorLog(str(journaled)) as log:
                log.append(0, 0.5, 0.125)
                log.append(2, 0.25, 0.0625,
                           extra={"per_column_jsd": {"color": 0.3}})
        finally:
            set_journal(None)
    assert plain.read_bytes() == journaled.read_bytes()
    sims = [e for e in read_journal(jpath) if e["type"] == "similarity"]
    assert [e["epoch"] for e in sims] == [0, 2]
    sim = port_report.summarize(jpath)["similarity"]
    assert sim["samples"] == 2 and sim["worst_columns"] == [["color", 0.3]]


# ------------------------------------- contributions on injected JAX draws


def test_contributions_equal_jax_on_injected_draws(tmp_path):
    """The round-parity harness (JAX's trainer and the port's from one
    init, the port drawing JAX's threefry draws): one journaled round
    each; the client_contribution weights agree within 1e-6 and the
    losses within the round tolerance."""
    from test_torch_federated import KW, client_frames, make_pair

    from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
    from fed_tgan_tpu.federation.init import federated_initialize
    from fed_tgan_tpu.obs.journal import set_journal as jax_set_journal

    jinit = federated_initialize(
        [JaxPre(frame=f, name="toy", **KW) for f in client_frames()],
        seed=0, backend="jax")
    jtr, tr, _ = make_pair(jinit)
    events = {}
    for name, trainer, cls, install in (
            ("jax", jtr, JaxJournal, jax_set_journal),
            ("port", tr, RunJournal, set_journal)):
        path = str(tmp_path / f"{name}.jsonl")
        with cls(path, validate=True) as j:
            install(j)
            try:
                trainer.fit(1)
            finally:
                install(None)
        events[name] = [e for e in read_journal(path)
                        if e["type"] == "client_contribution"]
    (je,), (pe,) = events["jax"], events["port"]
    assert pe["clients"] == je["clients"] == [0, 1, 2]
    np.testing.assert_allclose(pe["weights"], je["weights"], atol=1e-6)
    for k in ("loss_d", "loss_g"):
        np.testing.assert_allclose(pe[k], je[k], atol=1e-4, rtol=1e-3)
    assert pe["quarantined"] == je["quarantined"]
    assert pe["strikes"] == je["strikes"]


# ------------------------------ every event of the port passes JAX's schema


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_intrusion_csv(
        str(tmp_path_factory.mktemp("obsdata") / "intr.csv"), 600, 0)


def _argv(data, out, *extra):
    return ["--datapath", data, "--dataset", "intrusion", "--n-clients",
            "3", "-epochs", "2", "--sample-rows", "120", "--batch-size",
            "50", "--embedding-dim", "16", "--out-dir", str(out), "--seed",
            "1", "--device", "cpu", "--quiet", *extra]


def _cli_journal(data, tmp_path, *extra, resume=()) -> list:
    from fed_tgan_torch.testing.faults import ENV_VAR, install_plan

    jpath = str(tmp_path / "run.jsonl")
    try:
        assert port_cli.main(_argv(data, tmp_path, "--journal", jpath,
                                   *extra)) == 0
        if resume:
            assert port_cli.main(_argv(data, tmp_path, "--journal", jpath,
                                       *resume)) == 0
    finally:
        install_plan(None)
        os.environ.pop(ENV_VAR, None)
    return list(read_journal(jpath))


def _serving_events(tmp_path) -> list:
    """The canary and the fleet under one journal: a fleet of two canary
    tenants (one republished clean, one degraded), a request served, a
    tenant evicted, then a canary service's rejection."""
    from fed_tgan_torch.runtime.checkpoint import SYNTH_DIR
    from fed_tgan_torch.serve.canary import CanaryConfig
    from fed_tgan_torch.serve.demo import (
        build_demo_artifact,
        republish_demo_candidate,
    )
    from fed_tgan_torch.serve.fleet import FleetRegistry, FleetService
    from fed_tgan_torch.serve.registry import ModelRegistry
    from fed_tgan_torch.serve.service import SamplingService
    from fed_tgan_torch.testing.faults import degrade_checkpoint

    art = build_demo_artifact(str(tmp_path / "art"), device="cpu")
    roots = {}
    for name in ("good", "bad"):
        roots[name] = str(tmp_path / name)
        shutil.copytree(art, roots[name])
    jpath = str(tmp_path / "serve.jsonl")
    with RunJournal(jpath, run_id="serve") as j:
        set_journal(j)
        try:
            fleet = FleetRegistry(promote="canary", device="cpu",
                                  log=_silent)
            for name, path in roots.items():
                fleet.load(name, path)
            svc = FleetService(fleet, port=0, log=_silent,
                               http_mode="threaded").start()
            try:
                _get(f"{svc.url}/t/good/sample?rows=20&seed=1")
                republish_demo_candidate(roots["good"], device="cpu")
                degrade_checkpoint(os.path.join(roots["bad"], "models",
                                                SYNTH_DIR), 100.0)
                svc._maybe_reload()
            finally:
                svc.shutdown()
            fleet.evict("bad")
            one = SamplingService(
                ModelRegistry(art, device="cpu", log=_silent), port=0,
                promote="canary", canary_config=CanaryConfig(shadow_rows=256),
                log=_silent).start()
            try:
                _get(f"{one.url}/sample?rows=20&seed=2")
            finally:
                one.shutdown()
        finally:
            set_journal(None)
    return list(read_journal(jpath))


SCENARIOS = {
    "fedavg_quarantine_monitor_resume": (
        ("--monitor-every", "1", "--save-every", "1", "--faults",
         "scale_update:factor=1000,rank=2", "--quarantine-strikes", "5",
         "--eval"),
        ("-epochs", "3", "--resume", "--eval", "--save-every", "1"),
        ("quarantine", "similarity", "checkpoint", "checkpoint_restore",
         "client_contribution", "round", "aggregate", "init_phase")),
    "churn": (
        ("-epochs", "3", "--elastic-capacity", "8", "--drift-every", "1",
         "--save-every", "1", "--watchdog", "--faults",
         "join:round=2,count=2;leave:client=1,round=2;"
         "drift:client=0,round=2,shift=2.0"), (),
        ("client_joined", "client_left", "client_dropped", "drift_window")),
    "cohort": (
        ("--population", "3", "--cohort", "2"), (),
        ("cohort", "client_contribution")),
    "buffered": (
        ("--aggregation", "buffered", "--faults",
         "straggle:rank=2,delay=1,round=1,until=1"), (),
        ("cohort", "aggregate")),
}


@pytest.mark.parametrize("scenario", [*SCENARIOS, "world", "serving"])
def test_every_port_event_passes_the_jax_schema(data, tmp_path, scenario):
    """The events of a journaled CPU run of each path pass JAX's schema
    check and the port's, and hold the path's own event types."""
    if scenario == "world":
        from test_torch_cli import _shards, _world_argv
        from test_torch_world import launch_world

        out = tmp_path / "out"
        res = launch_world(str(tmp_path), _world_argv(
            out, "--journal", str(out / "journal.jsonl"), "--save-every",
            "1"), _shards(data, tmp_path))
        assert [rc for rc, _, _ in res] == [0, 0, 0], res
        paths = [str(out / f"journal_rank{r}.jsonl") for r in range(3)]
        events = [e for p in paths for e in read_journal(p)]
        merged = port_report.summarize_many(paths)
        assert merged["rounds"]["total_rounds"] == 1
        assert merged["clients"]["tracked"] == 2
        assert _normalized(merged) == _normalized(
            jax_report.summarize_many(paths[::-1]))
        want = ("round", "client_contribution", "checkpoint")
    elif scenario == "serving":
        events = _serving_events(tmp_path)
        want = ("fleet_load", "fleet_evict", "serve_stages", "serve_reload",
                "promotion_promoted", "promotion_rejected")
    else:
        extra, resume, want = SCENARIOS[scenario]
        events = _cli_journal(data, tmp_path, *extra, resume=resume)
    types = {e["type"] for e in events}
    assert set(want) <= types, sorted(types)
    assert "schema_violation" not in types
    assert _jax_check(events) == []
