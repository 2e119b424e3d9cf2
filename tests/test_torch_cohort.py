"""The port's cohort sampling (``cfg.cohort``) and buffered straggler
aggregation (``cfg.aggregation = "buffered"``) against ``fed_tgan_tpu``'s,
case for case with ``tests/test_cohort.py`` (its federation-scale report
is ROADMAP A.20's and not here).

16 clients of the toy table, one local step each at batch 20.  The JAX
trainer runs on the 8-device CPU mesh (2 clients a device).  Where a port
round is held against a JAX round, both start from the same models
(``interop.client_models_from_jax``), the port samples JAX's cohort ids
(its ``metrics["cohort"]``, injected through ``cohort_fn``) and draws
JAX's numbers (regenerated from the JAX key chain, with the cohort's
``sel_key, rkey = split(rkey)`` before the clients' keys are folded, and
injected through ``draws``).  A cohort round trains in a C-stack where
JAX trains a kc-stack on each device, so the GEMMs round otherwise: the
round tolerance holds at least 99% of a client's model entries
(weights and BatchNorm state) within atol 1e-5 + rtol 1e-3, and of the
losses within rtol 1e-4, with the quarantine masks and strikes equal.
"""


import jax
import numpy as np
import pytest
import torch

from fed_tgan_torch.interop import (
    client_models_from_jax,
    federated_init_from_jax,
    params_to_jax_layout,
)
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.checkpoint import load_federated, save_federated
from fed_tgan_torch.testing import faults as port_faults
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.federated import FederatedTrainer
from fed_tgan_tpu.data.ingest import TablePreprocessor
from fed_tgan_tpu.data.sharding import shard_dataframe
from fed_tgan_tpu.federation.init import federated_initialize
from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
from fed_tgan_tpu.parallel.mesh import client_mesh
from fed_tgan_tpu.testing import faults as jax_faults
from fed_tgan_tpu.train import steps as jsteps
from fed_tgan_tpu.train.federated import FederatedTrainer as JaxTrainer
from test_torch_steps import jax_step_draws

torch.set_num_threads(1)
SMALL = dict(embedding_dim=8, gen_dims=(16,), dis_dims=(16,), batch_size=20,
             pac=4)
N_CLIENTS, COHORT = 16, 8
ATOL, RTOL, LOSS_RTOL, SHARE = 1e-5, 1e-3, 1e-4, 0.99


@pytest.fixture(scope="module")
def jinit(toy_frame, toy_spec):
    shards = shard_dataframe(toy_frame, N_CLIENTS, "iid", seed=9)
    return federated_initialize(
        [TablePreprocessor(frame=s, **toy_spec) for s in shards], seed=0,
        backend="jax")


@pytest.fixture(scope="module")
def init(jinit):
    return federated_init_from_jax(jinit)


@pytest.fixture(autouse=True)
def _no_fault_plan():
    jax_faults.install_plan(None)
    port_faults.install_plan(None)
    yield
    jax_faults.install_plan(None)
    port_faults.install_plan(None)


def _cfg(**kw):
    return steps.TrainConfig(**SMALL, **kw)


def _fit_collecting(trainer, epochs, **fit_kw):
    """fit() with a health_cb stacking the chunks' metric arrays."""
    chunks = []
    trainer.fit(epochs, health_cb=lambda e, m: chunks.append(
        {k: np.asarray(v) for k, v in m.items()}), **fit_kw)
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


def _state(tr):
    st = tr.stack
    return [st.generator.params, st.generator.bn_state,
            st.generator.num_batches, st.discriminator.params,
            st.opt_g.exp_avg, st.opt_g.exp_avg_sq, st.opt_g.count,
            st.opt_d.exp_avg, st.opt_d.exp_avg_sq, st.opt_d.count,
            *(g.get_state() for g in tr.gens)]


def _assert_bit_equal(a, b):
    for x, y in zip(_state(a), _state(b)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a._strikes, b._strikes)


def _pair(jinit, capacity=0, **cfg_kw):
    """A JAX trainer on the 8-device mesh and a port trainer from its
    models, drawing its numbers: returns ``(jtr, tr, ids)``, ``ids`` the
    dict the port's ``cohort_fn`` reads (filled from JAX's metrics)."""
    jcfg = jsteps.TrainConfig(**SMALL, **cfg_kw)
    cfg = _cfg(**cfg_kw)
    kw = {"capacity": capacity} if capacity else {}
    jtr = JaxTrainer(jinit, config=jcfg, mesh=client_mesh(8), seed=11, **kw)
    jspec = JaxSpec.from_output_info(jinit.output_info)
    spec = SegmentSpec.from_output_info(jinit.output_info)
    cohort = 0 < cfg.cohort < jtr.capacity
    chain, rkeys = [jtr._key], {}

    def draws(e, i, s):
        while e not in rkeys:
            chain[0], rkey = jax.random.split(chain[0])
            if cohort:  # sel_key splits off before the clients' keys
                _, rkey = jax.random.split(rkey)
            rkeys[len(rkeys)] = rkey
        key = jax.random.fold_in(jax.random.fold_in(rkeys[e], i), s)
        return jax_step_draws(key, jspec, jcfg, 0)

    ids = {}
    tr = FederatedTrainer(
        federated_init_from_jax(jinit), cfg, seed=11, device="cpu",
        models=client_models_from_jax(jtr.models, spec, cfg, "cpu"),
        draws=draws, capacity=capacity,
        cohort_fn=(lambda e: ids[e]) if cohort else None)
    return jtr, tr, ids


def _close_share(a, b, atol, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.isclose(a, b, atol=atol, rtol=rtol).mean())


def _compare(jtr, tr, m_jax, m_port):
    """Every client's parameters and BatchNorm state, and the losses,
    within the round tolerance; quarantine masks and strikes equal."""
    for i in range(tr.n_clients):
        got = params_to_jax_layout(tr.stack.to_models(i))
        a, b = [], []
        for part in ("params_g", "params_d", "state_g"):
            a += [np.ravel(x) for x in jax.tree.leaves(got[part])]
            b += [np.ravel(np.asarray(x)[i])
                  for x in jax.tree.leaves(getattr(jtr.models, part))]
        share = _close_share(np.concatenate(a), np.concatenate(b), ATOL, RTOL)
        assert share >= SHARE, (i, share)
    for name in ("loss_d", "pen", "loss_g"):
        share = _close_share(m_port[name], m_jax[name], 1e-6, LOSS_RTOL)
        assert share >= SHARE, (name, share)
    np.testing.assert_array_equal(m_port["quarantined"] > 0,
                                  m_jax["quarantined"] > 0)
    np.testing.assert_array_equal(tr._strikes, jtr._strikes)


def test_cohort_round_matches_jax(jinit):
    """C = 8 of 16 for 3 rounds: the port on JAX's cohorts and draws
    agrees with the JAX trainer within the round tolerance."""
    jtr, tr, ids = _pair(jinit, cohort=COHORT)
    m_jax = _fit_collecting(jtr, 3)
    ids.update(enumerate(m_jax["cohort"]))
    m_port = _fit_collecting(tr, 3)
    np.testing.assert_array_equal(m_port["cohort"], m_jax["cohort"])
    _compare(jtr, tr, m_jax, m_port)


def test_cohort_equal_population_bit_identical(init):
    """C = N (and C = 0) is full participation: weights, every Adam and
    BatchNorm state, the generators and the strikes equal the plain
    trainer's bit for bit, and no cohort appears in the metrics."""
    plain = FederatedTrainer(init, _cfg(), seed=11, device="cpu")
    full = FederatedTrainer(init, _cfg(cohort=N_CLIENTS), seed=11,
                            device="cpu")
    m_plain, m_full = _fit_collecting(plain, 3), _fit_collecting(full, 3)
    assert "cohort" not in m_plain and "cohort" not in m_full
    assert full.cohort_size == 0 and full.last_cohort is None
    _assert_bit_equal(plain, full)
    assert plain.completed_epochs == full.completed_epochs == 3


def test_cohort_sampling_shape(init):
    """C = 8 of 16: every round reports 8 distinct slot ids, its losses
    and masks in the cohort's order, and the draw varies across rounds."""
    tr = FederatedTrainer(init, _cfg(cohort=COHORT), seed=11, device="cpu")
    m = _fit_collecting(tr, 4)
    ids = m["cohort"]
    assert ids.shape == (4, COHORT) == m["loss_g"].shape
    assert m["quarantined"].shape == (4, COHORT)
    assert ids.min() >= 0 and ids.max() < N_CLIENTS
    assert all(len(set(row.tolist())) == COHORT for row in ids)
    assert any(not np.array_equal(ids[0], ids[r]) for r in range(1, 4))
    np.testing.assert_array_equal(ids[-1], tr.last_cohort)
    for e in range(4):  # a round's cohort is a function of (seed, round)
        np.testing.assert_array_equal(tr.cohort_ids(e), ids[e])


def test_cohort_deterministic_across_resume(init, tmp_path):
    """2 rounds + checkpoint + 2 rounds sample the cohorts of 4 straight
    rounds and end bit-equal to them."""
    cfg = _cfg(cohort=COHORT)
    straight = FederatedTrainer(init, cfg, seed=7, device="cpu")
    m_straight = _fit_collecting(straight, 4)
    first = FederatedTrainer(init, cfg, seed=7, device="cpu")
    m_a = _fit_collecting(first, 2)
    save_federated(first, str(tmp_path / "ckpt"), run_name="toy")
    resumed = load_federated(str(tmp_path / "ckpt"), device="cpu")
    assert resumed.cfg.cohort == COHORT
    m_b = _fit_collecting(resumed, 2)
    np.testing.assert_array_equal(
        m_straight["cohort"], np.concatenate([m_a["cohort"], m_b["cohort"]]))
    _assert_bit_equal(straight, resumed)


def test_buffered_without_straggler_is_sync(init):
    sync = FederatedTrainer(init, _cfg(), seed=3, device="cpu").fit(3)
    buf = FederatedTrainer(init, _cfg(aggregation="buffered"), seed=3,
                           device="cpu").fit(3)
    _assert_bit_equal(sync, buf)
    assert buf._buffered_applied == 0 and buf._buffered == []


def test_buffered_straggler_staleness_accounting(jinit):
    """A straggler over rounds 2-3 (1-based) with delay 2 under buffered
    aggregation, both packages from one state on the same draws: after
    every round the queue holds JAX's entries (client, origin, arrival,
    staleness, weight), the two deltas land at rounds 3 and 4 (0-based)
    discounted by weight * 0.5^2, and the models agree within the round
    tolerance after 6 rounds."""
    spec = "straggle:rank=3,delay=2,round=2,until=3"
    jax_faults.install_plan(jax_faults.FaultPlan.parse(spec))
    port_faults.install_plan(port_faults.FaultPlan.parse(spec))
    jtr, tr, _ = _pair(jinit, aggregation="buffered")
    m_jax, m_port = {}, {}
    for e in range(6):
        for trainer, store in ((jtr, m_jax), (tr, m_port)):
            for k, v in _fit_collecting(trainer, 1).items():
                store[k] = np.concatenate([store[k], v]) if k in store else v
        want = [(u["client"], u["origin"], u["arrival"], u["staleness"])
                for u in jtr._buffered]
        assert [(u["client"], u["origin"], u["arrival"], u["staleness"])
                for u in tr._buffered] == want, e
        for a, b in zip(tr._buffered, jtr._buffered):
            assert a["weight"] == pytest.approx(b["weight"], abs=1e-7)
    assert tr._buffered_applied == jtr._buffered_applied == 2
    events = [e for e in tr.events if e["aggregator"] == "buffered"]
    assert [(e["client"], e["origin"], e["round"], e["staleness"])
            for e in events] == [(2, 1, 3, 2), (2, 2, 4, 2)]
    w = float(tr.weights[2])
    for e in events:
        assert e["discount"] == pytest.approx(w * 0.25, rel=1e-6)
    _compare(jtr, tr, m_jax, m_port)


def test_gate_strikes_follow_cohort_sampling(jinit):
    """Cohort + ``scale_update:factor=1000,rank=2``, on JAX's cohorts and
    draws: client 1 is quarantined on exactly the rounds it was sampled,
    the strikes land on it alone, and masks and strikes equal JAX's."""
    spec = "scale_update:factor=1000,rank=2"
    jax_faults.install_plan(jax_faults.FaultPlan.parse(spec))
    port_faults.install_plan(port_faults.FaultPlan.parse(spec))
    jtr, tr, ids = _pair(jinit, cohort=COHORT)
    jtr.quarantine_strikes = tr.quarantine_strikes = 99
    m_jax = _fit_collecting(jtr, 6)
    ids.update(enumerate(m_jax["cohort"]))
    m_port = _fit_collecting(tr, 6)
    cohort, q = m_port["cohort"], m_port["quarantined"] > 0
    assert q.any(), "client 1 never sampled in 6 rounds"
    assert set(cohort[q].ravel().tolist()) == {1}
    expected = np.zeros(N_CLIENTS, dtype=int)
    expected[1] = int(q.sum())
    np.testing.assert_array_equal(tr._strikes, expected)
    np.testing.assert_array_equal(q.any(axis=1), (cohort == 1).any(axis=1))
    np.testing.assert_array_equal(q, m_jax["quarantined"] > 0)
    np.testing.assert_array_equal(tr._strikes, jtr._strikes[:N_CLIENTS])


def test_cohort_with_capacity_matches_jax(jinit):
    """An elastic trainer of 32 slots (16 padded) with C = 8: JAX draws
    over every slot, padded ones included at weight 0; the port on those
    ids and draws agrees within the round tolerance."""
    jtr, tr, ids = _pair(jinit, capacity=32, cohort=COHORT)
    assert jtr.capacity == tr.capacity == 32
    m_jax = _fit_collecting(jtr, 3)
    ids.update(enumerate(m_jax["cohort"]))
    assert m_jax["cohort"].max() < 32
    m_port = _fit_collecting(tr, 3)
    _compare(jtr, tr, m_jax, m_port)
    # the port's own draw covers the padded slots too
    own = FederatedTrainer(federated_init_from_jax(jinit), _cfg(
        cohort=COHORT), seed=11, device="cpu", capacity=32)
    drawn = np.concatenate([own.cohort_ids(e) for e in range(8)])
    assert drawn.max() >= N_CLIENTS and drawn.min() < N_CLIENTS
