"""The port's runtime sanitizers (``fed_tgan_torch/analysis/sanitizers.py``)
against ``fed_tgan_tpu/analysis/sanitizers.py``'s contract.

- JAX's unit tests on the port: the build counter counts each cached
  build once per name, the hot region guards from its second entry (or
  its first under ``guard_warmup``), the torch state is restored, the
  NaN guard raises, a budget violation's message, budgets inert without
  a counter;
- the sync guard's decisions on the CPU, with injected sync warnings:
  unguarded (outside a region, or its warm-up entry), guarded (raised
  from the call, naming region and site), sanctioned, from another
  thread, and a warning swallowed before it reached its caller (raised
  at the region's exit);
- the satellites: a sanitized federated run keeps the training budget
  and is ``torch.equal`` to a plain one (JAX's
  ``test_training_compile_budget_and_determinism``), a sanitized engine
  keeps the serving budget over two chunk sizes and serves the same
  bytes (``test_serving_compile_budget_and_determinism``), and
  ``--sanitize-nans`` names the op of a ``nan_update`` fault.
"""

import os
import threading
import warnings

import numpy as np
import pytest
import torch

from fed_tgan_torch.analysis import sanitizers
from fed_tgan_torch.analysis.sanitizers import (
    SYNC_MESSAGE,
    SyncGuardError,
    check_compile_budgets,
    check_fleet_budget,
    check_serving_budget,
    check_training_budget,
    compile_report,
    hot_region,
    note_build,
    sanctioned_sync,
    sanitize,
    sanitizing,
    sync_census,
)
from fed_tgan_torch.ops import activate_cuda
from fed_tgan_torch.ops.segments import SegmentSpec, cond_tables

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _sanitizers_off():
    yield
    sanitizers.disable_sanitizers()
    assert not torch.are_deterministic_algorithms_enabled()


def _sync():
    """What ``torch.cuda.set_sync_debug_mode("warn")`` raises at a
    synchronising call, injected (the CPU has no CUDA sync)."""
    warnings.warn(SYNC_MESSAGE, UserWarning)


# ------------------------------------------------------------ unit tests

def test_build_counter_counts_each_cached_build_once():
    a = SegmentSpec.from_output_info([(1, "tanh"), (3, "softmax")])
    b = SegmentSpec.from_output_info([(1, "tanh"), (4, "softmax")])
    cond_tables.cache_clear()
    activate_cuda._plan.cache_clear()
    with sanitize() as counter:
        cond_tables(a, torch.device("cpu"))
        cond_tables(a, torch.device("cpu"))  # cached: no build
        assert counter.count("tables[cond:") == 1
        cond_tables(b, torch.device("cpu"))
        assert counter.count("tables[cond:") == 2
        for rows in (500, 500, 2000):
            activate_cuda._plan(rows, 282, 40, 132, 4)
        assert counter.count("plan[") == 2
        assert counter.counts()[f"tables[cond:{a.tag}@cpu]"] == 1
        counter.reset()
        assert counter.count("plan[") == 0
    assert a.tag != b.tag


def test_builds_are_journaled_as_compile_events(tmp_path):
    from fed_tgan_torch.obs.journal import RunJournal, read_journal, set_journal
    from fed_tgan_torch.obs.ledger import get_ledger

    path = str(tmp_path / "j.jsonl")
    journal = RunJournal(path, validate=True)
    prev = set_journal(journal)
    try:
        with sanitize():
            note_build("plan[7x3s1b4@1sm]")
        note_build("plan[7x3s1b4@1sm]")  # off: not counted
    finally:
        set_journal(prev)
        journal.close()
    events = [e for e in read_journal(path) if e["type"] == "compile"]
    assert [e["program"] for e in events] == ["plan[7x3s1b4@1sm]"]
    assert journal.schema_violations == 0
    assert get_ledger().entries()["plan[7x3s1b4@1sm]"].compiles >= 1


def test_hot_region_guards_from_second_entry():
    with hot_region("inactive"):
        _sync()  # no-op: sanitizers off (the warning is just a warning)
    with sanitize(build_counter=False):
        assert sanitizing()
        with hot_region("region-a"):
            _sync()  # warm-up entry: set-up may synchronise
        with pytest.raises(SyncGuardError) as exc:
            with hot_region("region-a"):
                _sync()
        assert "'region-a' (entry 2)" in str(exc.value)
        assert "test_torch_sanitizers.py" in str(exc.value)
        with hot_region("region-b"):
            _sync()  # independent warm-up per name
        _sync()  # outside any region
        census = sync_census()
    assert not sanitizing()
    by_region = {(c["region"], c["entry"]): c["count"] for c in census}
    assert by_region == {("region-a", 1): 1, ("region-a", 2): 1,
                         ("region-b", 1): 1, (None, 0): 1}


def test_hot_region_strict_warmup():
    with sanitize(build_counter=False, guard_warmup=True):
        with pytest.raises(SyncGuardError):
            with hot_region("strict"):
                _sync()


def test_sanctioned_sync_is_legal_and_counted():
    with sanitize(build_counter=False):
        for _ in range(3):
            with hot_region("copy"):
                with sanctioned_sync():
                    _sync()
                    _sync()  # the same line twice: not deduplicated
        census = sync_census()
        report = sanitizers.sync_report()
    assert sum(c["count"] for c in census if c["sanctioned"]) == 6
    assert "copy entry 3: 0 unsanctioned, 2 sanctioned" in report


def test_other_thread_sync_never_trips_this_region():
    errors = []

    def other():
        try:
            for _ in range(20):
                _sync()
        except SyncGuardError as exc:  # pragma: no cover - the failure
            errors.append(exc)

    with sanitize(build_counter=False):
        with hot_region("main"):
            pass
        with hot_region("main"):  # guarded on this thread only
            t = threading.Thread(target=other)
            t.start()
            t.join()
        census = sync_census()
    assert errors == []
    assert [c for c in census if c["region"] is None][0]["count"] == 20


def test_swallowed_sync_raises_at_region_exit():
    """A warning that never reached its caller (raised on a thread of the
    library's own, or swallowed) is raised when the region exits."""
    with sanitize(build_counter=False):
        with hot_region("r"):
            pass
        with pytest.raises(SyncGuardError):
            with hot_region("r"):
                try:
                    _sync()
                except SyncGuardError:
                    pass


def test_sanitize_restores_torch_and_warnings_state():
    show, n_filters = warnings.showwarning, len(warnings.filters)
    assert not torch.are_deterministic_algorithms_enabled()
    with sanitize(nan_debug=True) as counter:
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_anomaly_enabled()
        assert warnings.showwarning is not show
        assert sanitizers.enable_sanitizers() is counter  # idempotent
        # uninitialised memory is filled, so reading it cannot vary
        assert torch.isnan(torch.empty(4)).all()
    assert not torch.are_deterministic_algorithms_enabled()
    assert not torch.is_anomaly_enabled()
    assert warnings.showwarning is show
    assert len(warnings.filters) == n_filters
    assert sanitizers._STATE.nan_mode is None


def test_nan_debug_raises_naming_the_op():
    poisoned = torch.tensor([0.0, float("nan")])  # made before the guard
    with sanitize(nan_debug=True):
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor([-1.0, 2.0]))
        # an infinity is a legitimate value (the max reductions' start)
        torch.full((3,), -torch.inf)
        with sanitizers.nan_sentinels():  # a sentinel by design
            torch.where(torch.tensor([True, False]), 1.0, torch.nan)
        with pytest.raises(FloatingPointError, match="K1"):
            sanitizers.check_kernel_output("K1 fused_apply_activate",
                                           poisoned)
        sanitizers.check_kernel_output("K1 fused_apply_activate",
                                       torch.zeros(3))
    with pytest.raises(FloatingPointError, match="aten.div"):
        with sanitize(nan_debug=True):
            x = torch.zeros(2, requires_grad=True)
            (x / x).sum()
    # a NaN made by the backward alone (0 * d log(x) at 0), named there
    with sanitize(nan_debug=True):
        x = torch.zeros(3, requires_grad=True)
        loss = torch.where(x > 0, torch.log(x), torch.zeros_like(x)).sum()
        with pytest.raises(FloatingPointError, match="aten.div"):
            loss.backward()
    # off: NaN flows silently again
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_compile_budget_violation_message():
    with sanitize() as counter:
        for _ in range(3):  # one rebuild per call: a cache miss
            note_build("plan[9x3s1b4@1sm]")
        problems = check_compile_budgets({"plan[9x3s1b4": 1}, counter)
        assert len(problems) == 1 and "3x" in problems[0]
        assert check_compile_budgets({"plan[9x3s1b4": 3}, counter) == []
        assert "plan[9x3s1b4@1sm]" in compile_report(counter)


def test_budget_checks_inert_without_counter():
    assert check_compile_budgets({"anything": 0}) == []
    assert check_training_budget(object()) == []
    assert check_serving_budget(object()) == []
    assert check_fleet_budget(None) == []


def test_training_and_serving_budgets_flag_rebuilds():
    class Trainer:
        step_rows = {80}

    class Engine:
        chunk_rows = {40}

    with sanitize() as counter:
        note_build("plan[80x5s2b4@1sm]")
        note_build("tables[cond:5d2s:x@cpu]")
        assert check_training_budget(Trainer(), counter) == []
        note_build("tables[cond:5d2s:x@cpu]")
        note_build("plan[80x5s2b2@1sm]")  # a second plan for 80 rows
        problems = check_training_budget(Trainer(), counter)
        assert any("built 2x" in p for p in problems)
        assert any("2 launch plans for 1 stacked row count" in p
                   for p in problems)
        note_build("plan[40x5s2b4@1sm]")
        note_build("plan[40x5s2b4@1sm]")
        assert any("plan[40x5s2b4@1sm]" in p
                   for p in check_serving_budget(Engine(), counter))


# ----------------------------------------------------- training (satellite)

def _small_cfg(**kw):
    from fed_tgan_torch.train.steps import TrainConfig

    return TrainConfig(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),
                       batch_size=40, pac=4, **kw)


@pytest.fixture(scope="module")
def init3():
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize

    rng = np.random.default_rng(5)
    tables = [{"x": np.round(rng.normal(0, 1, 120), 3),
               "c": rng.choice(["a", "b", "c"], 120).astype(object)}
              for _ in range(3)]
    return federated_initialize(
        [TablePreprocessor(table=t, categorical_columns=["c"])
         for t in tables], seed=0, device="cpu")


def _fit(init, rounds=2):
    from fed_tgan_torch.train.federated import FederatedTrainer

    tr = FederatedTrainer(init, _small_cfg(), seed=0, device="cpu")
    tr.fit(rounds)
    st = tr.stack
    return tr, [st.generator.params, st.generator.bn_state,
                st.discriminator.params, st.opt_g.exp_avg]


def test_training_build_budget_and_determinism(init3):
    """One table set per (layout, device) under an active sync guard and
    the deterministic mode, and bit-identical parameters to an
    unsanitized run."""
    cond_tables.cache_clear()
    with sanitize() as counter:
        tr, sane = _fit(init3)
        assert counter.count("tables[cond:") == 1
        assert tr.step_rows == {3 * 40}
        assert check_training_budget(tr, counter) == []
        steady = [c for c in sync_census() if c["region"] is not None]
    _, plain = _fit(init3)
    for a, b in zip(sane, plain):
        assert torch.equal(a, b)
    assert steady == []  # the CPU makes no CUDA sync


def test_unsanctioned_sync_in_a_steady_round_raises(init3, monkeypatch):
    """A synchronising call inside the round chunk passes in the warm-up
    round and raises, naming the region, in the next one."""
    from fed_tgan_torch.train.federated import FederatedTrainer

    real = FederatedTrainer._local_steps

    def leaky(self, e, part=None):
        _sync()
        return real(self, e, part)

    monkeypatch.setattr(FederatedTrainer, "_local_steps", leaky)
    tr = FederatedTrainer(init3, _small_cfg(), seed=0, device="cpu")
    with sanitize():
        tr.fit(1)
        with pytest.raises(SyncGuardError, match=r"train\.chunk\[stack3"):
            tr.fit(1)


# ------------------------------------------------------ serving (satellite)

@pytest.fixture(scope="module")
def serve_model(tmp_path_factory):
    from fed_tgan_torch.serve.demo import build_random_artifact
    from fed_tgan_torch.serve.registry import open_model

    root = build_random_artifact(str(tmp_path_factory.mktemp("art")),
                                 seed=2, cfg=_small_cfg())
    return open_model(root, device="cpu")


def test_serving_build_budget_and_determinism(serve_model):
    """A fresh engine serving two chunk sizes keeps the serving budget
    with the sync guard on every steady chunk, and its bytes are the
    unsanitized engine's."""
    from fed_tgan_torch.serve.engine import SamplingEngine

    B = serve_model.synth.cfg.batch_size
    with sanitize() as counter:
        eng = SamplingEngine(serve_model)
        eng.sample_csv_bytes(B, seed=3)             # 1 step
        sane = eng.sample_csv_bytes(3 * B, seed=3)  # 3 steps -> 4
        eng.sample_csv_bytes(3 * B, seed=4)         # steady: nothing new
        assert eng.chunk_rows == {B, 4 * B}
        assert check_serving_budget(eng, counter) == []
        entries = {(c["region"], c["entry"]) for c in sync_census()}
    assert entries <= {(None, 0)}
    assert SamplingEngine(serve_model).sample_csv_bytes(3 * B, seed=3) \
        == sane


def test_sanitize_nans_names_the_op_of_a_nan_update(tmp_path):
    """``--sanitize-nans`` with a ``nan_update`` fault raises
    FloatingPointError at the op that wrote the NaN; the same command
    without the fault exits 0 (``tests/test_torch_cli.py`` holds its
    output equal to a plain run)."""
    from fed_tgan_torch import cli
    from fed_tgan_torch.serve.demo import write_intrusion_csv
    from fed_tgan_torch.testing.faults import ENV_VAR, install_plan

    data = write_intrusion_csv(str(tmp_path / "d.csv"), 300, 0)
    argv = ["--datapath", data, "--dataset", "intrusion", "--n-clients", "3",
            "-epochs", "1", "--sample-every", "1", "--sample-rows", "60",
            "--batch-size", "50", "--embedding-dim", "8", "--out-dir",
            str(tmp_path / "out"), "--seed", "1", "--device", "cpu",
            "--quiet", "--sanitize-nans"]
    try:
        with pytest.raises(FloatingPointError, match="aten") as exc:
            cli.main(argv + ["--faults", "nan_update:rank=1,round=1"])
    finally:
        # the CLI exports its plan for the processes it starts: a later
        # test's subprocesses must not inherit it
        install_plan(None)
        os.environ.pop(ENV_VAR, None)
    assert "sanitize-nans" in str(exc.value)
    assert not sanitizing()


def test_cached_builds_run_once_under_racing_threads():
    """Two serving workers missing one key at once built it twice under
    ``functools.lru_cache`` (seen on the card as a layout's K1/K2 tables
    built 2x under ``fleet --sanitize``): ``built_once`` builds it once."""
    import time

    from fed_tgan_torch.runtime.cache import built_once

    calls = []

    @built_once(maxsize=4)
    def slow(key):
        calls.append(key)
        time.sleep(0.05)
        return key * 2

    threads = [threading.Thread(target=slow, args=(3,)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [3] and slow(3) == 6
    slow.cache_clear()
    assert slow(3) == 6 and calls == [3, 3]
