"""The port's fault plans (``fed_tgan_torch.testing.faults``) against
``fed_tgan_tpu.testing.faults``: the same spec strings parse to the same
fields, the injection points fire once (the transport's delay and sever
among them), the environment variable is read, unknown kinds and any kind
listed as unported are refused, and the kill scenario of
``tests/test_faults.py`` drops the same client with the same renormalised
weights on both trainers (atol 1e-6)."""

import dataclasses

import numpy as np
import pytest
import torch

import fed_tgan_torch.testing.faults as faults
from fed_tgan_torch.interop import federated_init_from_jax
from fed_tgan_torch.testing.faults import (
    FaultInjected,
    FaultPlan,
    active_plan,
    install_plan,
    update_fault_window,
)
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.federated import FederatedTrainer
from fed_tgan_tpu.testing import faults as jfaults

torch.set_num_threads(1)

# every spec string of tests/test_faults.py and
# tests/test_robust.py::test_parse_update_faults
SPECS = [
    "kill_client:rank=3,round=2;delay_msg:ms=50;sever_conn:rank=1,after=2;"
    "crash_checkpoint:save=4",
    "crash_checkpoint",
    "crash_checkpoint:save=1",
    "kill_client:rank=2,round=3",
    "kill_client:rank=3,round=2",
    "sever_conn:rank=1,after=2",
    "sever_conn:rank=1,after=1",
    "delay_msg:ms=7",
    "delay_msg:ms=30",
    "nan_update:rank=3,round=2,until=5",
    "scale_update:100",
    "scale_update:factor=1e6,rank=2",
    "stuck_update:rank=2;delay_msg:ms=1",
]


@pytest.fixture(autouse=True)
def _no_plan():
    install_plan(None)
    jfaults.install_plan(None)
    yield
    install_plan(None)
    jfaults.install_plan(None)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_jax(spec):
    got = dataclasses.asdict(FaultPlan.parse(spec))
    assert got == dataclasses.asdict(jfaults.FaultPlan.parse(spec))


def test_unknown_kind_fails_fast():
    with pytest.raises(ValueError) as e:
        # torchlint: disable=O05
        FaultPlan.parse("nan_updat:rank=1")  # jaxlint: disable=O05
    assert "nan_updat" in str(e.value)
    for kind in jfaults.FaultPlan.VALID_KINDS:
        assert kind in str(e.value)
    assert FaultPlan.VALID_KINDS == jfaults.FaultPlan.VALID_KINDS


@pytest.mark.parametrize("kind,item", [("straggle", "A.99")])
def test_unported_kinds_are_refused(monkeypatch, kind, item):
    """A kind listed in ``NOT_PORTED_KINDS`` (empty since ROADMAP A.18
    ported the transport kinds; one is listed here for the check) parses
    but is refused at install, so no plan quietly does nothing."""
    assert faults.NOT_PORTED_KINDS == {}
    monkeypatch.setitem(faults.NOT_PORTED_KINDS, kind, item)
    plan = FaultPlan.parse("straggle:rank=1,delay=2")
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        install_plan(plan)
    assert active_plan() is None


@pytest.mark.parametrize("kind", ["delay_msg", "sever_conn"])
def test_transport_kinds_install_and_fire(kind):
    """The transport kinds (refused until ROADMAP A.18) install, parse to
    JAX's fields, and fire as JAX's injection points do: the delay before
    every send, the sever once, at the N-th send of its rank."""
    import time

    spec = {"delay_msg": "delay_msg:ms=20",
            "sever_conn": "sever_conn:rank=2,after=3"}[kind]
    plan = FaultPlan.parse(spec)
    jplan = jfaults.FaultPlan.parse(spec)
    install_plan(plan)
    assert active_plan() is plan
    if kind == "delay_msg":
        t0 = time.perf_counter()
        plan.maybe_delay()
        assert time.perf_counter() - t0 >= 0.02
        assert plan.delay_ms == jplan.delay_ms == 20
        return
    calls = [(1, 5), (2, 2), (2, 3), (2, 4)]
    assert ([plan.should_sever(*c) for c in calls]
            == [jplan.should_sever(*c) for c in calls]
            == [False, False, True, False])


def test_injection_points_fire_once():
    plan = FaultPlan.parse("kill_client:rank=2,round=3;crash_checkpoint:save=2")
    assert not plan.should_kill(2, 2)  # not yet
    assert not plan.should_kill(1, 3)  # wrong rank
    assert plan.should_kill(2, 3)
    assert not plan.should_kill(2, 4)  # once only
    plan.on_checkpoint_write("a")
    with pytest.raises(FaultInjected):
        plan.on_checkpoint_write("b")
    plan.on_checkpoint_write("c")


def test_active_plan_env_parse(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "scale_update:factor=3,rank=2")
    monkeypatch.setattr(faults, "_active", None)
    monkeypatch.setattr(faults, "_env_checked", False)
    plan = active_plan()
    assert (plan.update_kind, plan.update_rank, plan.update_factor) == (
        "scale", 2, 3.0)
    assert faults.ENV_VAR == "FED_TGAN_TORCH_FAULTS"


@pytest.mark.parametrize("spec,e0,size", [
    (None, 0, 16),
    ("scale_update:factor=2,rank=1,round=3,until=4", 0, 16),
    ("scale_update:factor=2,rank=1,round=3,until=4", 2, 16),
    ("scale_update:factor=2,rank=1,round=3,until=4", 4, 16),
    ("nan_update:rank=2,round=2", 0, 8),
    ("nan_update:rank=2,round=2", 1, 8),
    ("nan_update:rank=2,round=2", 3, 1),
])
def test_update_fault_window_matches_jax(spec, e0, size):
    plan = FaultPlan.parse(spec) if spec else None
    jplan = jfaults.FaultPlan.parse(spec) if spec else None
    assert update_fault_window(plan, e0, size) == \
        jfaults.update_fault_window(jplan, e0, size)


@pytest.fixture(scope="module")
def jinit4(toy_frame, toy_spec):
    from fed_tgan_tpu.data.ingest import TablePreprocessor
    from fed_tgan_tpu.data.sharding import shard_dataframe
    from fed_tgan_tpu.federation.init import federated_initialize

    shards = shard_dataframe(toy_frame, 4, "iid", seed=9)
    clients = [TablePreprocessor(frame=s, **toy_spec) for s in shards]
    return federated_initialize(clients, seed=0, backend="jax")


CFG = dict(embedding_dim=8, gen_dims=(16, 16), dis_dims=(16, 16),
           batch_size=40, pac=4)


def test_injected_kill_drops_like_jax(jinit4):
    """``kill_client:rank=3,round=2``: client 2 dropped at the start of
    round 2, its weight 0 and the survivors renormalised, on both trainers
    (2 rounds, one JAX program; the JAX test runs 4)."""
    from fed_tgan_tpu.parallel.mesh import client_mesh
    from fed_tgan_tpu.train.federated import FederatedTrainer as JaxTrainer
    from fed_tgan_tpu.train.steps import TrainConfig as JaxConfig

    spec = "kill_client:rank=3,round=2"
    jfaults.install_plan(jfaults.FaultPlan.parse(spec))
    jtr = JaxTrainer(jinit4, config=JaxConfig(**CFG), mesh=client_mesh(4),
                     seed=0, min_clients=1)
    jtr.fit(epochs=2)
    install_plan(FaultPlan.parse(spec))
    tr = FederatedTrainer(federated_init_from_jax(jinit4),
                          steps.TrainConfig(**CFG), seed=0, device="cpu")
    tr.fit(2)
    assert tr.completed_epochs == 2
    assert tr.dropped_clients == jtr.dropped_clients == {2}
    assert tr.weights[2] == 0.0 and tr.steps[2] == 0
    np.testing.assert_allclose(tr.weights, np.asarray(jtr.weights), atol=1e-6)
    assert len(tr.sample(100, seed=1)) == 100


def test_update_fault_from_the_plan_is_quarantined(jinit4):
    """The active plan's update fault reaches the round without an
    ``update_fault=`` argument, in its window only."""
    install_plan(FaultPlan.parse("nan_update:rank=2,round=2,until=2"))
    tr = FederatedTrainer(federated_init_from_jax(jinit4),
                          steps.TrainConfig(**CFG), seed=0, device="cpu")
    seen = []
    tr.fit(3, health_cb=lambda e, m: seen.append(m["quarantined"].tolist()))
    assert seen == [[[0, 0, 0, 0]], [[0, 1, 0, 0]], [[0, 0, 0, 0]]]
    assert tr._strikes.tolist() == [0, 1, 0, 0]
