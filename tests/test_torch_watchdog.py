"""The port's training watchdog (``fed_tgan_torch.train.watchdog``).

- The same sequences of round metrics and monitor reads raise, or do not
  raise, the same alarms on the port's and the JAX package's
  ``TrainingWatchdog`` (the cases of ``tests/test_robust.py:277``).
- The rollback scenarios of ``tests/test_robust.py:300-375`` on the port
  trainer (3 clients, the update gate off, client 1's update scaled x1e6):
  rollback and re-anneal; the older generation when the restored one
  alarms again; the bounded abort; the abort without a checkpoint.
"""

import numpy as np
import pytest
import torch

from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.sharding import shard_table
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.runtime.checkpoint import save_federated
from fed_tgan_torch.testing.faults import FaultPlan, install_plan
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.federated import FederatedTrainer
from fed_tgan_torch.train.watchdog import (
    TrainingWatchdog,
    WatchdogAlarm,
    WatchdogConfig,
    fit_with_watchdog,
)
from fed_tgan_tpu.train import watchdog as jwatchdog

torch.set_num_threads(1)
NAN, INF = float("nan"), float("inf")

# (config kwargs, calls): ("health", first_round, metrics) or
# ("sim", round, avg_jsd)
SEQUENCES = {
    "healthy": ({"loss_threshold": 10.0}, [
        ("health", 0, {"loss_g": np.zeros((2, 3)), "loss_d": np.ones((2, 3))}),
    ]),
    "inf_loss_round_1": ({"loss_threshold": 10.0}, [
        ("health", 0, {"loss_d": np.array([[1.0, 1.0], [INF, 1.0]])}),
    ]),
    "explosion": ({"loss_threshold": 10.0}, [
        ("health", 3, {"loss_g": np.array([[1.0, -11.0, 2.0]])}),
    ]),
    "quarantined_nan_excused": ({}, [
        ("health", 0, {"loss_d": np.array([[1.0, NAN]]),
                       "quarantined": np.array([[0.0, 1.0]])}),
    ]),
    "unquarantined_nan": ({}, [
        ("health", 4, {"pen": np.array([[1.0, NAN]]),
                       "quarantined": np.array([[1.0, 0.0]])}),
    ]),
    "similarity_regression": ({"similarity_patience": 2}, [
        ("sim", 0, 0.10), ("sim", 1, 0.25), ("sim", 2, 0.25),
    ]),
    "similarity_recovers": ({"similarity_patience": 2}, [
        ("sim", 0, 0.10), ("sim", 1, 0.25), ("sim", 2, 0.15),
        ("sim", 3, 0.25), ("sim", 4, 0.05),
    ]),
    "similarity_nan": ({}, [("sim", 0, 0.1), ("sim", 1, NAN)]),
}


def outcomes(module, cfg, calls):
    wd = module.TrainingWatchdog(module.WatchdogConfig(**cfg))
    out = []
    for kind, r, arg in calls:
        try:
            (wd.health_cb if kind == "health" else wd.observe_similarity)(
                r, arg)
            out.append(None)
        except module.WatchdogAlarm as alarm:
            out.append(str(alarm))
    return out


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_alarms_match_jax(name):
    cfg, calls = SEQUENCES[name]
    got = outcomes(__import__("fed_tgan_torch.train.watchdog",
                              fromlist=["x"]), cfg, calls)
    assert got == outcomes(jwatchdog, cfg, calls)
    assert any(got) == (name not in ("healthy", "quarantined_nan_excused",
                                     "similarity_recovers"))


def test_reset_window_forgets_the_streak():
    wd = TrainingWatchdog(WatchdogConfig(similarity_patience=2))
    wd.observe_similarity(0, 0.1)
    wd.observe_similarity(1, 0.3)
    wd.reset_window()
    wd.observe_similarity(2, 0.3)
    with pytest.raises(WatchdogAlarm, match="regressed"):
        wd.observe_similarity(3, 0.3)


# ---------------------------------------------------------- rollbacks


@pytest.fixture(autouse=True)
def _no_plan():
    install_plan(None)
    yield
    install_plan(None)


@pytest.fixture(scope="module")
def init3(toy_frame, toy_spec):
    table = {c: toy_frame[c].to_numpy() for c in toy_frame}
    shards = shard_table(table, 3, "iid", seed=9)
    return federated_initialize(
        [TablePreprocessor(table=t, **toy_spec) for t in shards], seed=0,
        device="cpu")


def gateless(init):
    cfg = steps.TrainConfig(embedding_dim=8, gen_dims=(16, 16),
                            dis_dims=(16, 16), batch_size=40, pac=4,
                            update_gate=False)
    return FederatedTrainer(init, cfg, seed=0, device="cpu")


def saver(ckpt, keep=1):
    def hook(e, trainer):
        save_federated(trainer, ckpt, run_name="toy", keep=keep)
    return hook


def finite(tr) -> bool:
    return all(torch.isfinite(p).all() for m in tr.models
               for p in m.generator.parameters())


def test_watchdog_rolls_back_and_reanneals(init3, tmp_path):
    """One poisoned round (2); its explosion shows in round 3's losses,
    after the round-1 checkpoint exists."""
    ckpt = str(tmp_path / "ckpt")
    tr = gateless(init3)
    base_lr = tr.cfg.lr
    install_plan(FaultPlan.parse(
        "scale_update:factor=1e6,rank=1,round=2,until=2"))
    wd = TrainingWatchdog(WatchdogConfig(loss_threshold=50.0, max_rollbacks=2))
    tr = fit_with_watchdog(tr, 4, wd, ckpt,
                           fit_kwargs=dict(sample_hook=saver(ckpt),
                                           hook_epochs=[0]),
                           on_rollback=lambda t: install_plan(None))
    assert wd.rollbacks == 1
    assert tr.completed_epochs == 4
    assert tr.cfg.lr == pytest.approx(base_lr * wd.cfg.lr_reanneal)
    for m in tr.models:
        for opt in (m.opt_g, m.opt_d):
            assert opt.param_groups[0]["lr"] == pytest.approx(tr.cfg.lr)
    assert finite(tr)


@pytest.mark.parametrize("rounds", [4, 3])
def test_watchdog_falls_back_to_older_generation(init3, tmp_path, rounds):
    """The poison lands after the training of the round before the last,
    so that round's checkpoint (the newest) is poisoned and the one before
    (``.1``) clean: the last round alarms, the restored run alarms at once
    and the second rollback takes ``.1``."""
    ckpt = str(tmp_path / "ckpt")
    tr = gateless(init3)
    base_lr = tr.cfg.lr
    last = rounds - 1
    install_plan(FaultPlan.parse(
        f"scale_update:factor=1e6,rank=1,round={last},until={last}"))
    wd = TrainingWatchdog(WatchdogConfig(loss_threshold=50.0, max_rollbacks=2))
    alarms, restored = [], []
    health = wd.health_cb

    def watched(e, metrics):
        try:
            health(e, metrics)
        except WatchdogAlarm:
            alarms.append(e)
            raise

    wd.health_cb = watched
    tr = fit_with_watchdog(
        tr, rounds, wd, ckpt, fit_kwargs=dict(sample_hook=saver(ckpt, keep=2)),
        on_rollback=lambda t: (restored.append(t.completed_epochs),
                               install_plan(None)))
    assert wd.rollbacks == 2 and restored == [last, last - 1]
    assert alarms == [last, last]
    assert tr.completed_epochs == rounds
    assert tr.cfg.lr == pytest.approx(base_lr / 4)
    assert finite(tr)


def test_watchdog_bounded_abort(init3, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tr = gateless(init3)
    install_plan(FaultPlan.parse("scale_update:factor=1e6,rank=1,round=2"))
    wd = TrainingWatchdog(WatchdogConfig(loss_threshold=50.0, max_rollbacks=1))
    with pytest.raises(RuntimeError, match="max_rollbacks"):
        fit_with_watchdog(tr, 4, wd, ckpt,
                          fit_kwargs=dict(sample_hook=saver(ckpt),
                                          hook_epochs=[0]))
    assert wd.rollbacks == wd.cfg.max_rollbacks + 1


def test_watchdog_aborts_without_checkpoint(init3):
    tr = gateless(init3)
    install_plan(FaultPlan.parse("scale_update:factor=1e6,rank=1,round=1"))
    wd = TrainingWatchdog(WatchdogConfig(loss_threshold=50.0))
    with pytest.raises(RuntimeError, match="no resumable checkpoint"):
        fit_with_watchdog(tr, 3, wd, None)


def test_health_cb_sees_each_round_before_the_hook(init3, capsys):
    seen = []
    tr = gateless(init3)
    tr.fit(2, sample_hook=lambda e, t: seen.append(("hook", e)),
           health_cb=lambda e, m: seen.append(
               ("health", e, sorted(m), m["loss_d"].shape)))
    assert seen == [("health", 0, ["loss_d", "loss_g", "pen", "quarantined"],
                     (1, 3)), ("hook", 0),
                    ("health", 1, ["loss_d", "loss_g", "pen", "quarantined"],
                     (1, 3)), ("hook", 1)]
    # a non-finite loss of a client the gate did not contain is warned of
    bad = np.array([[0.1, 1.0, 0.2], [np.nan, 1.0, 0.2]])
    capsys.readouterr()
    FederatedTrainer._warn_nonfinite(bad, np.array([False, True]), 7)
    assert capsys.readouterr().out == ""  # quarantined: excused
    FederatedTrainer._warn_nonfinite(bad, np.array([False, False]), 7)
    assert "non-finite loss_d at round 7" in capsys.readouterr().out
