"""Elastic membership and drift in the port against ``tests/test_churn.py``'s
cases and JAX's ``ElasticFederation`` on the same shards (the toy table,
10 IID residents and 2 newcomers, the sketch init, capacity 16):

- the churn fault grammar and its fail-fast errors equal JAX's;
- ``drift_frame`` and the CLI's newcomer draw equal JAX's bit for bit;
- a join lands in padded slots (weights within 1e-4 of JAX's), a join
  past the capacity grows it to a power of two, a departure renormalizes
  the survivors, and a checkpoint round trip keeps capacity, membership,
  weights and strikes, and resumes bit-exactly;
- a silently drifted shard is detected, refitted and reweighted in one
  window (weights within 1e-4 of JAX's), and the next window is quiet; a
  departure suppresses the WD criterion for one window;
- the padded slots change no client's training;
- ``ElasticFederation.run`` applies a plan's churn once, even across a
  watchdog rollback, and two runs from one seed end bit-equal;
- a JAX elastic checkpoint converts with its capacity.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from fed_tgan_torch.cli import draw_newcomer_rows
from fed_tgan_torch.data.csvio import read_csv
from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.sharding import shard_table
from fed_tgan_torch.federation.elastic import DriftConfig, ElasticFederation
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.federation.streaming import OnboardingSession
from fed_tgan_torch.parallel.fedavg import agg_leaves
from fed_tgan_torch.runtime.checkpoint import load_federated, save_federated
from fed_tgan_torch.serve.demo import write_intrusion_csv
from fed_tgan_torch.testing.faults import (
    FaultPlan,
    drift_frame,
    install_plan,
)
from fed_tgan_torch.train.federated import FederatedTrainer
from fed_tgan_torch.train.steps import TrainConfig
from fed_tgan_torch.train.watchdog import (
    TrainingWatchdog,
    WatchdogAlarm,
    WatchdogConfig,
)
from fed_tgan_tpu.testing import faults as jfaults

torch.set_num_threads(1)
SMALL = dict(embedding_dim=8, gen_dims=(16,), dis_dims=(16,), batch_size=20,
             pac=4)
CFG = TrainConfig(**SMALL)
N_RES, N_POOL, CAPACITY = 10, 2, 16
W_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_plan():
    install_plan(None)
    yield
    install_plan(None)


def as_table(frame: pd.DataFrame) -> dict:
    return {c: frame[c].to_numpy() for c in frame.columns}


def make_world(toy_frame, toy_spec, seed=9):
    """Fresh residents, newcomers and a sketch init (the session mutates
    its init, so every test builds its own)."""
    shards = shard_table(as_table(toy_frame), N_RES + N_POOL, "iid",
                         seed=seed)
    residents = [TablePreprocessor(table=s, **toy_spec)
                 for s in shards[:N_RES]]
    pool = [TablePreprocessor(table=s, **toy_spec) for s in shards[N_RES:]]
    init = federated_initialize(residents, seed=0, similarity="sketch",
                                device="cpu")
    return residents, pool, init


def elastic(init, residents, **kw):
    tr = FederatedTrainer(init, CFG, seed=3, capacity=CAPACITY,
                          min_clients=2, device="cpu")
    return tr, ElasticFederation(tr, OnboardingSession(init, device="cpu"),
                                 list(residents), **kw)


def jax_world(toy_frame, toy_spec, seed=9, **kw):
    """JAX's elastic federation over the same shards (its ``jax`` fit)."""
    from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
    from fed_tgan_tpu.data.sharding import shard_dataframe
    from fed_tgan_tpu.federation.elastic import ElasticFederation as JaxEl
    from fed_tgan_tpu.federation.init import federated_initialize as jinit
    from fed_tgan_tpu.federation.streaming import OnboardingSession as JaxSes
    from fed_tgan_tpu.parallel.mesh import client_mesh
    from fed_tgan_tpu.train import steps as jsteps
    from fed_tgan_tpu.train.federated import FederatedTrainer as JaxTrainer

    shards = shard_dataframe(toy_frame, N_RES + N_POOL, "iid", seed=seed)
    residents = [JaxPre(frame=s, **toy_spec) for s in shards[:N_RES]]
    pool = [JaxPre(frame=s, **toy_spec) for s in shards[N_RES:]]
    init = jinit(residents, seed=0, similarity="sketch", backend="jax")
    tr = JaxTrainer(init, config=jsteps.TrainConfig(**SMALL),
                    mesh=client_mesh(8), seed=3, capacity=CAPACITY,
                    min_clients=2)
    return tr, JaxEl(tr, JaxSes(init), list(residents), **kw), pool


def state(tr) -> list:
    """Every slot's parameters, BatchNorm statistics and Adam state, each
    with the slot axis first."""
    s = tr.stack
    return agg_leaves(s) + [s.opt_g.exp_avg, s.opt_g.exp_avg_sq,
                            s.opt_g.count, s.opt_d.exp_avg,
                            s.opt_d.exp_avg_sq, s.opt_d.count]


def assert_same_state(a, b):
    for x, y in zip(state(a), state(b)):
        assert torch.equal(x, y)


# -- fault grammar ------------------------------------------------------------


def test_churn_spec_parses():
    spec = ("join:round=9,count=2;leave:client=1,round=15;"
            "drift:client=0,round=13,shift=2.0;corrupt_cache:nth=3")
    plan, jplan = FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert plan.joins == jplan.joins == [(9, 2)]
    assert plan.leaves == jplan.leaves == [(15, 1)]
    assert plan.drifts == jplan.drifts == [(13, 0, 2.0)]
    assert plan.corrupt_cache_nth == jplan.corrupt_cache_nth == 3
    assert plan.has_churn()
    for e in range(20):
        assert plan.churn_events(e) == jplan.churn_events(e)
        assert plan.next_churn_round(e) == jplan.next_churn_round(e)
    assert plan.next_churn_round(0) == 8
    install_plan(plan)  # every kind of it is ported now


def test_churn_spec_fail_fast():
    for spec, match in (("join:count=2", "join needs a round"),
                        ("leave:round=5", "leave"),
                        ("drift:client=1", "drift")):
        with pytest.raises(ValueError, match=match):
            FaultPlan.parse(spec)
        with pytest.raises(ValueError, match=match):
            jfaults.FaultPlan.parse(spec)


def test_cache_store_fault_truncates_the_nth(tmp_path):
    plan = FaultPlan.parse("corrupt_cache:nth=2")
    paths = []
    for i in range(3):
        paths.append(tmp_path / f"f{i}")
        paths[-1].write_bytes(b"x" * 100)
    fired = [plan.on_cache_store(str(p)) for p in paths]
    assert fired == [False, True, False]
    assert [p.stat().st_size for p in paths] == [100, 50, 100]


# -- deterministic data -------------------------------------------------------


@pytest.mark.parametrize("kind", ["toy", "intrusion"])
@pytest.mark.parametrize("shift,seed", [(2.0, 6), (-0.7, 11)])
def test_drift_frame_equals_jax(toy_frame, tmp_path, kind, shift, seed):
    """(A string column with a missing cell is left out: JAX's
    ``drift_frame`` raises on it under pandas 3, whose ``astype(str)``
    keeps NaN; the port rotates ``"nan"`` as a value.)"""
    if kind == "toy":
        frame, table = toy_frame, as_table(toy_frame)
    else:
        path = write_intrusion_csv(str(tmp_path / "t.csv"), 300, 5)
        frame, table = pd.read_csv(path), read_csv(path)
    ours = drift_frame(table, shift=shift, seed=seed)
    theirs = jfaults.drift_frame(frame, shift=shift, seed=seed)
    assert list(ours) == list(theirs.columns)
    for c in ours:
        want = theirs[c].to_numpy()
        if want.dtype.kind == "f":
            np.testing.assert_array_equal(ours[c], want)
        else:
            assert [str(v) for v in ours[c].tolist()] == [
                str(v) for v in want.tolist()], c


@pytest.mark.parametrize("count,rnd", [(2, 2), (3, 7)])
def test_newcomer_draw_equals_pandas_sample(toy_frame, count, rnd):
    """The CLI's newcomers: ``pd.concat(frames).sample(n, random_state=
    seed * 100003 + rnd)`` dealt out ``i::count``, as the JAX CLI draws
    them (``fed_tgan_tpu/cli.py:990-1001``)."""
    from fed_tgan_tpu.data.sharding import shard_dataframe

    frames = shard_dataframe(toy_frame, 4, "iid", seed=1)
    tables = shard_table(as_table(toy_frame), 4, "iid", seed=1)
    pool_df = pd.concat(frames)
    shard_rows = len(pool_df) // 4
    state_seed = 7 * 100003 + rnd
    drawn = pool_df.sample(n=min(count * shard_rows, len(pool_df)),
                           random_state=state_seed)
    ours = draw_newcomer_rows(tables, count, shard_rows, state_seed)
    for i in range(count):
        want = drawn.iloc[i::count].reset_index(drop=True)
        for c in want.columns:
            assert ours[i][c].tolist() == want[c].tolist()


# -- joins and departures -----------------------------------------------------


def test_join_lands_in_padded_slots(toy_frame, toy_spec, tmp_path):
    residents, pool, init = make_world(toy_frame, toy_spec)
    tr, el = elastic(init, residents)
    tr.fit(2)
    el.join(pool)
    assert (tr.n_clients, tr.capacity, tr.stack.n) == (12, CAPACITY,
                                                       CAPACITY)
    assert [e["client"] for e in el.events
            if e["type"] == "client_joined"] == [10, 11]
    assert not any(e["repacked"] for e in tr.last_admission)
    # the newcomers' slots already held the global parameters
    g = tr.stack.generator.params
    assert torch.equal(g[10], g[0]) and torch.equal(g[15], g[0])
    assert tr.weights[N_RES + N_POOL:].sum() == 0.0
    assert tr.steps[:12].min() > 0 and tr.steps[12:].sum() == 0
    jtr, jel, jpool = jax_world(toy_frame, toy_spec)
    jel.join(jpool)
    np.testing.assert_allclose(tr.weights, np.asarray(jtr.weights),
                               atol=W_TOL)
    tr.fit(1)
    ck = str(tmp_path / "ck")
    save_federated(tr, ck, run_name="churn")
    cont = tr.fit(2)
    restored = load_federated(ck, device="cpu")
    assert (restored.capacity, restored.n_clients) == (CAPACITY, 12)
    assert restored.init.onboarding["mix_means"].shape[0] == 12
    restored.fit(2)
    assert_same_state(cont, restored)


def test_join_past_capacity_grows_to_a_power_of_two(toy_frame, toy_spec):
    residents, pool, init = make_world(toy_frame, toy_spec)
    tr = FederatedTrainer(init, CFG, seed=3, capacity=N_RES, device="cpu")
    el = ElasticFederation(tr, OnboardingSession(init, device="cpu"),
                           list(residents))
    tr.fit(1)
    el.join(pool)
    assert (tr.capacity, tr.stack.n, len(tr.weights)) == (16, 16, 16)
    assert all(e["repacked"] for e in tr.last_admission)
    # the grown slots are copies of slot 0, Adam state included
    assert torch.equal(tr.stack.opt_g.exp_avg[12], tr.stack.opt_g.exp_avg[0])
    tr.fit(1)
    assert np.isfinite(tr.last_metrics).all()
    assert (tr.last_metrics[:12, 0] != 0).all()


def test_departure_renormalizes_survivors(toy_frame, toy_spec, tmp_path):
    residents, _, init = make_world(toy_frame, toy_spec)
    tr, el = elastic(init, residents)
    w_before = tr.weights.astype(np.float64).copy()
    el.leave(4, "test departure")
    w_after = tr.weights.astype(np.float64)
    assert w_after[4] == 0.0 and 4 in tr.dropped_clients
    assert w_after[:N_RES].sum() == pytest.approx(1.0, abs=1e-5)
    survivors = [i for i in range(N_RES) if i != 4]
    np.testing.assert_allclose(
        w_after[survivors], w_before[survivors] / w_before[survivors].sum(),
        rtol=1e-5)
    assert w_after[N_RES:].sum() == 0.0
    tr._strikes[7] = 2
    ck = str(tmp_path / "ck")
    save_federated(tr, ck, run_name="churn")
    restored = load_federated(ck, device="cpu")
    assert restored.dropped_clients == {4}
    assert int(restored.steps[4]) == 0
    np.testing.assert_allclose(restored.weights, w_after, rtol=1e-6)
    assert int(restored._strikes[7]) == 2


@pytest.mark.parametrize("capacity,rounds", [(4, 2), (8, 1)])
def test_padded_slots_change_no_client(toy_frame, toy_spec, capacity,
                                       rounds):
    """The same 4 clients trained in 4 slots and in ``capacity``: an
    elastic trainer without headroom (its row stride a power of two) is
    bit-equal over 2 rounds; with 4 padded slots, computed and masked,
    every client agrees within float rounding after a round (the stacked
    GEMMs over 8 slots round otherwise than over 4, and the GAN grows a
    last-bit difference over rounds)."""
    table = as_table(toy_frame)
    clients = [TablePreprocessor(table=t, **toy_spec)
               for t in shard_table(table, 4, "iid", seed=2)]
    init = federated_initialize(clients, seed=0, device="cpu")
    plain = FederatedTrainer(init, CFG, seed=3, device="cpu").fit(rounds)
    padded = FederatedTrainer(init, CFG, seed=3, device="cpu",
                              capacity=capacity).fit(rounds)
    assert padded.stack.n == capacity and padded.steps[4:].sum() == 0
    for x, y in zip(state(plain), state(padded)):
        if capacity == 4:
            assert torch.equal(x, y)
        elif x.dtype == torch.long:
            assert torch.equal(x, y[:len(x)])
        else:
            torch.testing.assert_close(x, y[:len(x)], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(plain.last_metrics, padded.last_metrics[:4],
                               rtol=1e-5, atol=1e-6)
    assert (padded.last_metrics[4:] == 0).all()


# -- drift ------------------------------------------------------------------


def test_drift_detected_and_reweighted_within_one_window(toy_frame,
                                                         toy_spec):
    residents, _, init = make_world(toy_frame, toy_spec)
    wd = TrainingWatchdog(WatchdogConfig(drift_patience=2))
    tr, el = elastic(init, residents, watchdog=wd,
                     config=DriftConfig(detect_every=1))
    rec0 = el.detect(0)
    assert rec0["alarms"] == 0
    w_before = tr.weights.astype(np.float64).copy()
    el.apply_drift(2, shift=2.5, seed=11)
    rec1 = el.detect(1)
    assert 2 in rec1["drifted"]
    assert rec1["recompute_lag_rounds"] == 0
    w_after = tr.weights.astype(np.float64)
    assert w_after[:N_RES].sum() == pytest.approx(1.0, abs=1e-5)
    assert abs(w_after[2] - w_before[2]) > 1e-9
    rec2 = el.detect(2)
    assert rec2["alarms"] == 0
    assert wd._drift_streaks == {}
    types = [e["type"] for e in el.events]
    assert "drift_alarm" in types and types.count("drift_window") == 3
    # JAX's elastic federation on the same shards, the same windows
    from fed_tgan_tpu.train.watchdog import TrainingWatchdog as JaxWatchdog
    from fed_tgan_tpu.train.watchdog import WatchdogConfig as JaxWatchCfg
    from fed_tgan_tpu.federation.elastic import DriftConfig as JaxDrift

    jtr, jel, _ = jax_world(
        toy_frame, toy_spec,
        watchdog=JaxWatchdog(JaxWatchCfg(drift_patience=2)),
        config=JaxDrift(detect_every=1))
    jrec = [jel.detect(0)]
    jel.apply_drift(2, shift=2.5, seed=11)
    jrec += [jel.detect(1), jel.detect(2)]
    assert [r["drifted"] for r in jrec] == [rec0["drifted"],
                                            rec1["drifted"],
                                            rec2["drifted"]]
    np.testing.assert_allclose(w_after, np.asarray(jtr.weights), atol=W_TOL)
    np.testing.assert_allclose(el.session.init.wd_raw,
                               jel.session.init.wd_raw, rtol=1e-4, atol=1e-6)


def test_membership_change_suppresses_wd_criterion(toy_frame, toy_spec):
    residents, _, init = make_world(toy_frame, toy_spec)
    tr, el = elastic(init, residents, config=DriftConfig(detect_every=1))
    el.detect(0)
    el.leave(0, "pool shift")
    rec = el.detect(1)
    assert rec["wd_suppressed"] is True
    assert rec["alarms"] == 0
    rec2 = el.detect(2)
    assert rec2["wd_suppressed"] is None and rec2["alarms"] == 0


def test_observe_drift_matches_jax():
    from fed_tgan_tpu.train.watchdog import TrainingWatchdog as JaxWatchdog

    ours, theirs = TrainingWatchdog(), JaxWatchdog()
    for r, drifted in enumerate(([1], [1, 2], [2], [], [3, 3], [3])):
        assert ours.observe_drift(r, drifted) == theirs.observe_drift(
            r, drifted)
        assert ours._drift_streaks == theirs._drift_streaks


# -- the run loop -------------------------------------------------------------


def _churn_run(toy_frame, toy_spec, tmp_path, tag, alarm_round=None):
    residents, pool, init = make_world(toy_frame, toy_spec)
    wd = TrainingWatchdog()
    tr, el = elastic(init, residents, watchdog=wd,
                     config=DriftConfig(detect_every=2))
    ck = str(tmp_path / f"ck_{tag}")
    fired = []

    def hook(e, t):
        save_federated(t, ck, keep=2)

    def health(first, metrics):
        if first == alarm_round and not fired:
            fired.append(first)
            raise WatchdogAlarm("injected")

    plan = FaultPlan.parse("join:round=2,count=2;leave:client=1,round=3;"
                           "drift:client=0,round=4,shift=2.0")
    joins = []

    def factory(count, rnd):
        joins.append(rnd)
        return pool[:count]

    if alarm_round is not None:
        wd.health_cb = health
    tr = el.run(6, plan=plan, fit_kwargs=dict(sample_hook=hook),
                ckpt_dir=ck, newcomer_factory=factory)
    return tr, el, joins, fired


def test_run_applies_churn_once_and_is_bit_exact(toy_frame, toy_spec,
                                                 tmp_path):
    tr, el, joins, _ = _churn_run(toy_frame, toy_spec, tmp_path, "a")
    assert joins == [1] and tr.n_clients == 12
    assert tr.dropped_clients == {1}
    assert tr.completed_epochs == 6
    windows = {w["round"]: w for w in el.windows}
    assert sorted(windows) == [2, 4]
    assert 0 in windows[4]["drifted"]
    again, _, _, _ = _churn_run(toy_frame, toy_spec, tmp_path, "b")
    assert_same_state(tr, again)
    # a rollback re-traverses a round: the churn still applies once
    rolled, el3, joins3, fired = _churn_run(toy_frame, toy_spec, tmp_path,
                                            "c", alarm_round=4)
    assert fired == [4] and joins3 == [1]
    assert rolled.n_clients == 12 and rolled.dropped_clients == {1}
    assert rolled.completed_epochs == 6


# -- JAX checkpoints -----------------------------------------------------------


def test_jax_elastic_checkpoint_converts_with_its_capacity(toy_frame,
                                                           toy_spec,
                                                           tmp_path):
    from fed_tgan_torch.interop import convert_jax_checkpoint
    from fed_tgan_tpu.runtime.checkpoint import save_federated as jsave

    jtr, _, _ = jax_world(toy_frame, toy_spec)
    jtr.fit(1)
    jsave(jtr, str(tmp_path / "jax"), run_name="churn")
    convert_jax_checkpoint(str(tmp_path / "jax"), str(tmp_path / "port"))
    tr = load_federated(str(tmp_path / "port"), device="cpu")
    assert (tr.capacity, tr.stack.n, tr.n_clients) == (CAPACITY, CAPACITY,
                                                       N_RES)
    np.testing.assert_array_equal(tr.weights, np.asarray(jtr.weights))
    tr.fit(1)
    assert np.isfinite(tr.last_metrics).all()
    assert dataclasses.asdict(tr.cfg)["batch_size"] == SMALL["batch_size"]
