"""The port's telemetry layer (``fed_tgan_torch/obs``) against the JAX
package's (``fed_tgan_tpu/obs``): the cases of ``tests/test_obs.py`` and
of ``tests/test_ledger.py``'s SLO gate, on the port's modules, and the
two held equal where they must be:

- ``schema.json`` equal as parsed JSON, and the budgets a subset of
  JAX's rules, equal rule for rule;
- ``journal_figures`` / ``check_figures`` / ``check_slo`` equal on the
  same events and files, torn tails included;
- a journaled federated round: round -> aggregate -> checkpoint, the
  round's spans, as many host copies as without a journal and a final
  state ``torch.equal`` to the plain run's; its ``program_cost`` measured
  on the real first dispatch (``FlopCounterMode`` through the gradient
  penalty's double backward) with the state unchanged.

Every journal here validates against the schema; the module's autouse
fixture asserts that the port's ``validation_violations()`` stay empty.
"""

import argparse
import json
import os
import threading

import numpy as np
import pytest
import torch

os.environ.setdefault("FED_TGAN_TORCH_VALIDATE_JOURNAL", "1")

from fed_tgan_torch.obs import (  # noqa: E402
    MetricsRegistry,
    RunJournal,
    Tracer,
    emit,
    get_registry,
    read_journal,
    set_journal,
    span,
    start_tracing,
    stop_tracing,
)
from fed_tgan_torch.obs import slo as port_slo  # noqa: E402
from fed_tgan_torch.obs.journal import validation_violations  # noqa: E402
from fed_tgan_torch.obs.ledger import CostEntry, CostLedger  # noqa: E402
from fed_tgan_torch.obs.report import render_text, summarize  # noqa: E402
from fed_tgan_tpu.obs import slo as jax_slo  # noqa: E402

pytestmark = pytest.mark.obs
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _obs_uninstalled():
    """No test leaks a process journal or tracer, and no journal of the
    port saw an event off the schema."""
    yield
    set_journal(None)
    stop_tracing()
    assert validation_violations() == []


# ------------------------------------------------------ the schema copy


def test_schema_equals_the_jax_registry():
    """The port's registry is JAX's, except that the two backend events
    (which only the JAX package's journals carry) have every field
    ``external``, so the port's obslint needs no emit site for them."""
    with open(os.path.join(REPO, "fed_tgan_torch", "obs",
                           "schema.json")) as f:
        port = json.load(f)
    with open(os.path.join(REPO, "fed_tgan_tpu", "obs", "schema.json")) as f:
        ref = json.load(f)
    for name in ("backend_probe", "backend_plugin_registered"):
        ev = ref["events"][name]
        ev["external"] = sorted(set(ev["external"]) | set(ev["required"])
                                | set(ev["optional"]))
        ev["required"], ev["optional"] = [], []
    assert port == ref
    from fed_tgan_torch.obs.journal import EVENT_TYPES
    from fed_tgan_tpu.obs.journal import EVENT_TYPES as JAX_TYPES

    assert EVENT_TYPES == JAX_TYPES and len(EVENT_TYPES) == 37


def test_budgets_are_jax_rules_without_speed_figures():
    """Every packaged rule is JAX's rule as it stands; none bounds a time
    or a rate measured on a CPU or a TPU."""
    jax_rules = {r["name"]: r for r in jax_slo.load_budgets(
        jax_slo.default_budgets_path())}
    rules = port_slo.load_budgets(port_slo.default_budgets_path())
    assert sorted(r["name"] for r in rules) == sorted([
        "quality-jsd-delta", "quality-wd-delta", "quality-ml-acc-drop",
        "drift-alarm-coverage", "drift-weight-recompute-window",
        "drift-max-jsd-rise", "churn-join-recompiles"])
    for r in rules:
        assert r == jax_rules[r["name"]]
        assert "backend" not in (r.get("select") or {})


# ----------------------------------------------------- metrics registry


def test_counter_threaded_increments():
    reg = MetricsRegistry()
    c = reg.counter("t_total", "threaded")

    def work():
        for _ in range(1000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 8000
    with pytest.raises(ValueError):
        c.inc(-1)


def test_registry_get_or_create_identity_and_kind_collision():
    reg = MetricsRegistry()
    a = reg.counter("x_total")
    assert reg.counter("x_total") is a
    with pytest.raises(TypeError):
        reg.gauge("x_total")
    g = reg.gauge("depth")
    g.set(3)
    g.dec()
    assert g.value == 2


def test_histogram_buckets_and_quantile():
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.02, 0.02, 0.5, 2.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 5
    assert (snap["le_0.01"], snap["le_0.1"], snap["le_1"]) == (1, 3, 4)
    assert h.quantile(0.0) == 0.005 and h.quantile(1.0) == 2.0


def test_prometheus_rendering_equals_jax():
    from fed_tgan_tpu.obs.registry import MetricsRegistry as JaxRegistry

    texts = []
    for cls in (MetricsRegistry, JaxRegistry):
        reg = cls()
        reg.counter("req_total", "requests").inc(4)
        reg.histogram("lat", buckets=(0.1, 1.0)).observe(0.05)
        reg.gauge("fed_tgan_client_weight", "w",
                  labels={"client": "0"}).set(0.25)
        texts.append(reg.render_prometheus())
    assert texts[0] == texts[1]
    assert 'lat_bucket{le="+Inf"} 1' in texts[0]
    assert 'fed_tgan_client_weight{client="0"} 0.25' in texts[0]


def test_default_registry_is_process_wide():
    from fed_tgan_torch.obs import registry

    c = get_registry().counter("obs_test_shared_total")
    assert get_registry().counter("obs_test_shared_total") is c
    assert registry.DEFAULT is get_registry()


# --------------------------------------------------------- span tracing


def test_span_nesting_depth_and_chrome_json():
    tr = Tracer()
    with tr.span("outer", phase="a"):
        with tr.span("inner"):
            pass
    tr.instant("marker", note=1)
    by_name = {e["name"]: e for e in tr.events()}
    assert by_name["inner"]["args"]["depth"] == 1
    assert by_name["outer"]["args"] == {"depth": 0, "phase": "a"}
    assert by_name["inner"]["dur"] <= by_name["outer"]["dur"]
    assert by_name["marker"]["ph"] == "i"
    chrome = json.loads(json.dumps(tr.to_chrome()))
    assert chrome["displayTimeUnit"] == "ms"
    assert chrome["traceEvents"][0]["ph"] == "M"


def test_tracer_bounded_and_phase_summary():
    tr = Tracer(max_events=2)
    for _ in range(4):
        with tr.span("p"):
            pass
    assert len(tr.events()) == 2 and tr.dropped == 2
    assert tr.phase_summary()["p"]["count"] == 2


def test_module_span_noop_without_tracer():
    assert stop_tracing() is None
    with span("free", k=1) as t:
        assert t is None
    tr = start_tracing()
    assert start_tracing() is tr
    with span("counted") as t:
        assert t is tr
    assert stop_tracing() is tr
    assert "counted" in tr.phase_summary()


# ---------------------------------------------------------- run journal


def test_journal_round_trip_and_schema(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with RunJournal(path, run_id="rt", validate=False) as j:
        j.emit("round", first=0, last=3, rounds=4, per_round_s=0.25)
        circular = {}
        circular["self"] = circular
        j.emit("weird", obj=circular)  # unserializable: degraded, not lost
    events = list(read_journal(path))
    assert [e["type"] for e in events] == \
        ["run_start", "round", "weird", "run_end"]
    assert events[0]["schema"] == 1 and events[0]["run_id"] == "rt"
    assert events[2]["error"] == "unserializable fields dropped"
    with open(path, "a") as fh:
        fh.write('{"type": "round", "first":')
    assert len(list(read_journal(path))) == 4


def test_module_emit_noop_when_uninstalled(tmp_path):
    set_journal(None)
    assert emit("round", first=0) is None
    j = RunJournal(str(tmp_path / "m.jsonl"), run_id="m")
    set_journal(j)
    assert emit("round", first=0)["type"] == "round"
    set_journal(None)
    j.close()
    assert [e["type"] for e in read_journal(j.path)] == \
        ["run_start", "round", "run_end"]


@pytest.mark.parametrize("bad", [
    ("no_such_event", {}, "unknown_type", None),
    ("round", {}, "missing_field", "first"),
    ("round", {"first": 0, "colour": 1}, "unknown_field", "colour")])
def test_armed_journal_records_violations_like_jax(tmp_path, bad):
    """An armed journal never raises: each distinct violation is one
    ``schema_violation`` event and one count of the registry series, the
    problem named as the JAX package's sanitizer names it."""
    from fed_tgan_tpu.obs.journal import RunJournal as JaxJournal

    kind, fields, problem, field = bad
    counter = get_registry().counter("fed_tgan_journal_schema_violations_total")
    before = counter.value
    got = []
    for cls, name in ((RunJournal, "port"), (JaxJournal, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        with cls(path, validate=True) as j:
            j.emit(kind, **fields)
            j.emit(kind, **fields)  # the same violation: once
            assert j.schema_violations == 1
        got.append([{k: v for k, v in e.items() if k != "ts"}
                    for e in read_journal(path)
                    if e["type"] == "schema_violation"])
    assert got[0] == got[1] == [
        {"type": "schema_violation", "event": kind, "problem": problem,
         **({"field": field} if field else {})}]
    assert counter.value == before + 1


def test_report_summarize(tmp_path):
    path = str(tmp_path / "r.jsonl")
    with RunJournal(path, run_id="rep", validate=False) as j:
        j.emit("round", first=0, last=7, rounds=8, per_round_s=0.5)
        j.emit("aggregate", first=0, last=7, aggregator="fedavg", clients=2)
        j.emit("watchdog_alarm", reason="boom", round=7)
        j.emit("quarantine", client=1, rounds=2)
        j.emit("compile", program="epoch_local")
        j.emit("checkpoint", path="/tmp/ck", kind="federated", round=8)
    s = summarize(path)
    assert s["run_id"] == "rep" and s["events"] == 8
    assert s["rounds"] == {"chunks": 1, "total_rounds": 8,
                           "per_round_s_mean": 0.5, "per_round_s_max": 0.5}
    assert s["watchdog"]["alarms"] == 1
    assert s["robustness"]["quarantine_events"] == 1
    assert s["checkpoints"]["saved"] == 1
    text = render_text(s)
    assert "rounds: 8 in 1 chunk(s)" in text and "watchdog: 1 alarm(s)" in text


# ------------------------------------------------------------ SLO gate


def _write(path, doc):
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return str(path)


def _budgets(path, rules):
    return _write(path, {"schema": 1, "budgets": rules})


@pytest.mark.parametrize("case", ["pass", "regression", "stale"])
def test_slo_exit_codes_equal_jax(tmp_path, case):
    """Pass -> 0, a violated budget -> 1 with a REGRESSION line, a value
    far inside one -> 0 with a stale-budget line; the same lines as the
    JAX gate's."""
    p99 = {"pass": 20.0, "regression": 80.0, "stale": 2.0}[case]
    rec = _write(tmp_path / "rec.json",
                 {"metric": "bench_serving(test)(cpu)", "value": 50000,
                  "p99_ms": p99})
    bud = _budgets(tmp_path / "b.json", [
        {"name": "p99", "metric": "p99_ms", "max": 35.0}])
    code, lines = port_slo.check_slo(rec, bud)
    assert (code, lines) == jax_slo.check_slo(rec, bud)
    assert code == (1 if case == "regression" else 0)
    word = {"pass": "ok p99", "regression": "REGRESSION p99",
            "stale": "stale budget p99"}[case]
    assert any(line.startswith(word) for line in lines)


def test_slo_malformed_budgets_exits_2(tmp_path, capsys):
    rec = _write(tmp_path / "rec.json", {"metric": "x", "p99_ms": 1.0})
    bad = _write(tmp_path / "bad.json", {"not_budgets": []})
    with pytest.raises(port_slo.SLOError):
        port_slo.check_slo(rec, bad)
    assert port_slo.slo_main(argparse.Namespace(input=rec, budgets=bad)) == 2
    assert "slo:" in capsys.readouterr().out


def test_slo_malformed_input_exits_2(tmp_path):
    bad = _write(tmp_path / "notes.json", {"no": "metric here"})
    with pytest.raises(port_slo.SLOError):
        port_slo.check_slo(bad, port_slo.default_budgets_path())


FOLD_EVENTS = [
    {"type": "program_cost", "name": "train_step[stack4@f32]",
     "flops": 100.0, "peak_bytes": 10},
    {"type": "program_cost", "name": "train_step[stack4@f32]",
     "flops": 120.0, "peak_bytes": 12, "bytes_accessed": 7},
    {"type": "serve_stages",
     "stages": {"dispatch": {"count": 3, "p50_ms": 1.0, "p99_ms": 4.0}}},
    {"type": "serve_stages", "tenant": "a",
     "stages": {"dispatch": {"count": 5, "p50_ms": 2.0, "p99_ms": 9.0}}},
    {"type": "init_phase", "phase": "local_bgm_fit", "seconds": 2.5},
    {"type": "init_phase", "phase": "local_bgm_fit", "seconds": 1.5},
    {"type": "promotion_rejected", "candidate": "c", "tenant": "t",
     "avg_jsd": 0.3, "jsd_delta": 0.2, "wd_delta": 0.01},
    {"type": "promotion_promoted", "candidate": "d", "tenant": "t",
     "avg_jsd": 0.1, "jsd_delta": -0.01, "wd_delta": 0.02},
    {"type": "drift_window", "round": 4, "alarms": 1, "evicted": [2],
     "max_jsd_rise": 0.4, "max_wd_rise": 1.2, "recompute_lag_rounds": 0,
     "live": 3},
    {"type": "client_joined", "client": 4, "repacked": False},
    {"type": "client_left", "client": 2},
]


def test_journal_figures_fold_equal_jax():
    figs = port_slo.journal_figures(FOLD_EVENTS)
    assert figs == jax_slo.journal_figures(FOLD_EVENTS)
    assert figs["program/train_step[stack4@f32]/flops"] == 120.0
    assert figs["stage/dispatch/p99_ms"] == 9.0
    assert figs["init/local_bgm_fit/seconds"] == 4.0
    assert figs["quality/jsd_delta"] == 0.2
    assert figs["drift/alarms_total"] == 1.0
    assert figs["churn/join_repacks"] == 0.0
    rules = port_slo.load_budgets(port_slo.default_budgets_path())
    assert port_slo.check_figures(figs, rules) == \
        jax_slo.check_figures(figs, rules)
    regressions, _, matched, lines = port_slo.check_figures(figs, rules)
    assert regressions == 1 and matched == 6  # jsd_delta 0.2 > 0.15
    assert any(ln.startswith("REGRESSION quality-jsd-delta") for ln in lines)


def test_slo_journal_input_and_torn_tail_equal_jax(tmp_path, capsys):
    jpath = tmp_path / "journal.jsonl"
    with open(jpath, "w") as fh:
        for ev in FOLD_EVENTS:
            fh.write(json.dumps(ev) + "\n")
        fh.write('{"type": "round", "fi')  # a crashed writer's last line
    bud = _budgets(tmp_path / "b.json", [
        {"name": "dispatch-p99", "metric": "stage/dispatch/p99_ms",
         "max": 5.0, "stale_frac": 0.0}])
    got = port_slo.check_slo(str(jpath), bud)
    port_err = capsys.readouterr().err
    assert got == jax_slo.check_slo(str(jpath), bud)
    assert port_err == capsys.readouterr().err
    assert "truncated journal line" in port_err
    assert got[0] == 1


# ----------------------------------------------------------- cost ledger


def test_ledger_note_compile_then_record_merges():
    led = CostLedger()
    led.note_compile("p")
    led.note_compile("p")
    led.record(CostEntry(name="p", flops=5.0))
    assert led.snapshot()["p"]["compiles"] == 2
    assert led.snapshot()["p"]["flops"] == 5.0
    led.clear()
    assert led.entries() == {}


# ------------------------------------- a journaled round of the trainer


def _init():
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize

    rng = np.random.default_rng(3)
    tables = [{"x": np.round(rng.normal(0, 1, n), 3),
               "c": rng.choice(["a", "b", "c"], n).astype(object)}
              for n in (120, 80)]
    return federated_initialize(
        [TablePreprocessor(table=t, categorical_columns=["c"])
         for t in tables], seed=0, device="cpu")


CFG = dict(embedding_dim=8, gen_dims=(16,), dis_dims=(16,), batch_size=40,
           pac=4)


@pytest.fixture(scope="module")
def init2():
    return _init()


def _state(tr):
    st = tr.stack
    return [st.generator.params, st.generator.bn_state,
            st.discriminator.params, st.opt_g.exp_avg_sq, st.opt_d.exp_avg,
            st.opt_d.count] + [g.get_state() for g in tr.gens]


def test_instrumented_round_adds_no_host_copy_and_changes_nothing(
        init2, tmp_path):
    """Two rounds with a journal and a tracer, then a checkpoint: the
    journal reads round -> aggregate -> checkpoint, the spans are there,
    the chunk made as many host copies as an unjournaled run and the state
    is torch.equal to it -- the first chunk's program_cost (measured with
    FlopCounterMode and the bytes mode around the real dispatch, double
    backward included) changed nothing."""
    from fed_tgan_torch.runtime.checkpoint import save_federated
    from fed_tgan_torch.train.federated import FederatedTrainer
    from fed_tgan_torch.train.steps import TrainConfig

    cfg = TrainConfig(**CFG)
    plain = FederatedTrainer(init2, cfg, seed=0, device="cpu").fit(2)
    rounds = get_registry().counter("fed_tgan_training_rounds_total")
    before = rounds.value
    tr = FederatedTrainer(init2, cfg, seed=0, device="cpu")
    journal = RunJournal(str(tmp_path / "run.jsonl"), run_id="gate")
    set_journal(journal)
    tracer = start_tracing()
    tr.fit(2)
    save_federated(tr, str(tmp_path / "ckpt"))
    set_journal(None)
    journal.close()
    assert tr.host_copies == plain.host_copies == 2
    for a, b in zip(_state(plain), _state(tr)):
        assert torch.equal(a, b)
    types = [e["type"] for e in read_journal(journal.path)]
    assert types.index("round") < types.index("aggregate") \
        < types.index("checkpoint")
    assert rounds.value == before + 2
    phases = tracer.phase_summary()
    assert {"train.local_steps", "train.aggregate.sync",
            "train.monitor"} <= set(phases)
    assert phases["train.local_steps"]["count"] == 2
    s = summarize(journal.path)
    assert s["rounds"]["total_rounds"] == 2
    assert s["checkpoints"]["saved"] == 1
    (cost,) = [e for e in read_journal(journal.path)
               if e["type"] == "program_cost"]
    assert cost["name"] == "train_step[stack2@f32]"
    assert cost["family"] == "train_live"
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0


def test_measured_flops_scale_with_the_rounds(init2):
    """The flop count is a function of the work: a chunk of two rounds
    counts twice a chunk of one (every step's products, the gradient
    penalty's double backward among them), and the count is the same
    whether the chunk is measured or not."""
    from fed_tgan_torch.obs.ledger import measure_dispatch
    from fed_tgan_torch.train.federated import FederatedTrainer
    from fed_tgan_torch.train.steps import TrainConfig

    cfg = TrainConfig(**CFG)
    one, two = CostEntry(name="r1"), CostEntry(name="r2")
    with measure_dispatch(one, "cpu"):
        FederatedTrainer(init2, cfg, seed=0, device="cpu").fit(1)
    measured = FederatedTrainer(init2, cfg, seed=0, device="cpu")
    with measure_dispatch(two, "cpu"):
        measured.fit(2, max_rounds_per_call=2)
    assert one.flops > 0 and two.flops == 2 * one.flops
    assert two.bytes_accessed > one.bytes_accessed > 0
    plain = FederatedTrainer(init2, cfg, seed=0, device="cpu").fit(2)
    for a, b in zip(_state(plain), _state(measured)):
        assert torch.equal(a, b)
