"""The port's ``FederatedTrainer`` against ``fed_tgan_tpu``'s on three
ragged client shards (3, 2 and 1 local steps a round), and on Dirichlet
shards where one client trains no step (3, 2 and 0): the port's stacked
round with masked steps against the JAX program's masked scan.

Both start from the same init (``interop.federated_init_from_jax``) and
the same per-client weights (``interop.client_models_from_jax``); every
step's draws are regenerated from the JAX trainer's key layout (per round
``chain, rkey = split(chain)``, then ``fold_in(rkey, client)``,
``fold_in(., step)``, ``split(., 13)``) and injected through ``draws=``.

Tolerance (slice 2's): aggregated parameters and BatchNorm state within
atol 1e-5 + rtol 1e-3, entries whose first-step gradient on some client
is below 1e-6 set aside and counted (Adam's first update ``g / (|g| +
1e-8)`` may take the other sign there); quarantine strikes equal.
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from fed_tgan_torch.data.csvio import plain_csv_bytes
from fed_tgan_torch.data.decode import decode_columns
from fed_tgan_torch.interop import (
    client_models_from_jax,
    federated_init_from_jax,
    params_to_jax_layout,
)
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.train import federated as port_fed
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.snapshots import SnapshotWriter, result_path_fn
from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
from fed_tgan_tpu.data.sharding import shard_dataframe
from fed_tgan_tpu.federation.init import federated_initialize
from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
from fed_tgan_tpu.parallel.mesh import client_mesh
from fed_tgan_tpu.testing.faults import FaultPlan, install_plan
from fed_tgan_tpu.train import steps as jsteps
from fed_tgan_tpu.train.federated import FederatedTrainer as JaxTrainer
from test_torch_steps import jax_step_draws

torch.set_num_threads(1)
ATOL, RTOL, TINY = 1e-5, 1e-3, 1e-6
SMALL = dict(embedding_dim=16, gen_dims=(32, 32), dis_dims=(32, 32),
             batch_size=50)
ROWS = (150, 100, 60)
KW = dict(categorical_columns=["kind", "level"], non_negative_columns=["size"])


def client_frames(seed=0):
    rng = np.random.default_rng(seed)
    return [pd.DataFrame({
        "x": np.round(rng.choice([-4.0, 3.0], n) + rng.normal(0, 0.4, n), 3),
        "size": np.round(np.exp(rng.choice([2.0, 6.0], n)
                                + rng.normal(0, 0.1, n))),
        "kind": rng.choice(["p", "q", "r"], n),
        "level": rng.integers(0, 3, n),
    }) for n in ROWS]


@pytest.fixture(scope="module")
def jinit():
    return federated_initialize(
        [JaxPre(frame=f, name="toy", **KW) for f in client_frames()],
        seed=0, backend="jax")


@pytest.fixture(autouse=True)
def _no_fault_plan():
    install_plan(None)
    yield
    install_plan(None)


def make_pair(jinit, **cfg_kw):
    """A JAX trainer and a port trainer from the same state and draws."""
    jcfg = jsteps.TrainConfig(**SMALL, **cfg_kw)
    cfg = steps.TrainConfig(**SMALL, **cfg_kw)
    jtr = JaxTrainer(jinit, config=jcfg, mesh=client_mesh(3), seed=0)
    jspec = JaxSpec.from_output_info(jinit.output_info)
    spec = SegmentSpec.from_output_info(jinit.output_info)
    models = client_models_from_jax(jtr.models, spec, cfg, "cpu")
    chain = [jtr._key]
    rkeys: dict = {}
    first_grads: dict = {}

    def draws(e, i, s):
        while e not in rkeys:
            chain[0], rkeys[len(rkeys)] = jax.random.split(chain[0])
        if e == 0 and s == 1:
            first_grads[i] = params_to_jax_layout(tr.models[i],
                                                  of=lambda p: p.grad)
        key = jax.random.fold_in(jax.random.fold_in(rkeys[e], i), s)
        return jax_step_draws(key, jspec, jcfg, 0)

    tr = port_fed.FederatedTrainer(federated_init_from_jax(jinit), cfg,
                                   seed=0, device="cpu", models=models,
                                   draws=draws)
    return jtr, tr, first_grads


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def compare(jtr, tr, first_grads, after_round0=False):
    """Aggregated state of every port client against the JAX trainer's."""
    if after_round0:  # one-step clients: their only gradient is still there
        for i, n in enumerate(tr.steps):
            if n == 1 and i not in first_grads:
                first_grads[i] = params_to_jax_layout(tr.models[i],
                                                      of=lambda p: p.grad)
    tiny = {part: [np.zeros(np.shape(x), dtype=bool) for x in
                   leaves(first_grads[0][part])]
            for part in ("params_g", "params_d")}
    for g in first_grads.values():
        for part in tiny:
            tiny[part] = [t | (np.abs(x) < TINY) for t, x in
                          zip(tiny[part], leaves(g[part]))]
    set_aside = total = 0
    for i in range(3):
        got = params_to_jax_layout(tr.models[i])
        for part in ("params_g", "params_d", "state_g"):
            want = [x[i] for x in leaves(getattr(jtr.models, part))]
            masks = tiny.get(part) or [np.zeros(x.shape, bool) for x in want]
            for a, b, m in zip(leaves(got[part]), want, masks):
                np.testing.assert_allclose(a[~m], b[~m], atol=ATOL, rtol=RTOL,
                                           err_msg=f"client {i} {part}")
                set_aside += int(m.sum())
                total += m.size
    assert set_aside < 0.05 * total, (set_aside, total)
    np.testing.assert_array_equal(tr._strikes, jtr._strikes[:3])
    assert tr.dropped_clients == jtr.dropped_clients


@pytest.mark.parametrize("gate", [True, False], ids=["gated", "plain"])
def test_one_and_two_rounds_match_jax(jinit, gate):
    jtr, tr, grads = make_pair(jinit, update_gate=gate)
    for r in range(2):
        jtr.fit(1)
        tr.fit(1)
        compare(jtr, tr, grads, after_round0=r == 0)
        assert np.isfinite(tr.last_metrics).all()
    assert list(tr.steps) == [3, 2, 1]
    assert len(tr.epoch_times) == 2 == len(tr.round_split["aggregate"])


def test_ragged_dirichlet_rounds_match_jax():
    """The three clients' rows pooled and split by a Dirichlet draw over
    ``kind`` (alpha 0.5): 172, 118 and 20 rows, so 3, 2 and 0 local steps
    a round.  One and two rounds within the tolerance of
    :func:`test_one_and_two_rounds_match_jax`; the zero-step client
    reports zero metrics and holds the aggregate."""
    frame = pd.concat(client_frames(), ignore_index=True)
    shards = shard_dataframe(frame, 3, "dirichlet", label_column="kind",
                             alpha=0.5, seed=10)
    jinit = federated_initialize(
        [JaxPre(frame=f, name="toy", **KW) for f in shards], seed=0,
        backend="jax")
    jtr, tr, grads = make_pair(jinit, allow_zero_step_clients=True)
    assert list(tr.steps) == [3, 2, 0]
    for r in range(2):
        jtr.fit(1)
        tr.fit(1)
        compare(jtr, tr, grads, after_round0=r == 0)
        assert (tr.last_metrics[2] == 0).all()
        assert np.isfinite(tr.last_metrics).all()


def test_scaled_client_is_quarantined_like_jax(jinit):
    """Client 1's update scaled x1e3 after its local steps (JAX fault plan
    ``scale_update:factor=1000,rank=2``): quarantined in both, one strike
    per round, evicted at the strike limit, aggregates equal."""
    install_plan(FaultPlan.parse("scale_update:factor=1000,rank=2"))
    jtr, tr, grads = make_pair(jinit)
    jtr.quarantine_strikes = tr.quarantine_strikes = 2
    for r in range(2):
        jtr.fit(1)
        tr.fit(1, update_fault=("scale", 1, 1000.0))
        assert tr.last_quarantined.tolist() == [False, True, False]
        compare(jtr, tr, grads, after_round0=r == 0)
    assert tr.dropped_clients == {1} and tr.weights[1] == 0.0
    np.testing.assert_allclose(tr.weights, jtr.weights[:3], atol=1e-7)


def test_round_snapshot_and_artifact(jinit, tmp_path):
    """The trainer's own draws, a snapshot through the writer thread, the
    saved artifact, timing files and membership changes.  Two runs from
    one seed write byte-equal snapshot files, equal to the stdlib writer's
    bytes of the same rows sampled to the host, and ``drain`` returns
    those rows' decoded columns."""
    cfg = steps.TrainConfig(**SMALL)
    init = federated_init_from_jax(jinit)
    files = []
    for run in ("a", "b"):
        tr = port_fed.FederatedTrainer(init, cfg, seed=4, device="cpu")
        path_fn = result_path_fn(str(tmp_path / run), "toy")
        with SnapshotWriter(init.global_meta, init.encoders, path_fn,
                            rows=70, seed=1) as snap:
            tr.fit(2, sample_hook=snap, hook_epochs=[1])
            last = snap.drain()
        files.append(open(path_fn(1), "rb").read())
    assert files[0] == files[1]
    want = decode_columns(tr.decode.assemble(tr.sample_parts(70, seed=2)),
                          init.global_meta, init.encoders)
    assert list(last) == list(want)
    for name in want:
        np.testing.assert_array_equal(last[name], want[name])
    assert files[0] == plain_csv_bytes(want)
    lines = files[0].decode().splitlines()
    assert lines[0] == "x,size,kind,level" and len(lines) == 71
    assert not os.path.exists(path_fn(0))
    assert set(last["kind"]) <= {"p", "q", "r"}
    np.testing.assert_array_equal(tr.sample(70, seed=2),
                                  tr.sample(70, seed=2))
    assert tr.sample_encoded(70, seed=2).shape == (70, tr.spec.dim)
    assert tr.to_saved().key_offset == 29
    tr.write_timing(str(tmp_path))
    assert open(tmp_path / "timing_phases.csv").read().count("\n") == 3
    tr.update_weights(np.asarray([0.5, 0.25, 0.25]))
    tr.drop_client(2)
    np.testing.assert_allclose(tr.weights, [2 / 3, 1 / 3, 0], atol=1e-7)
    assert tr.steps[2] == 0
    tr.min_clients = 2
    with pytest.raises(RuntimeError, match="min_clients"):
        tr.drop_client(0)


def test_bf16_needs_weights_summing_to_one(jinit):
    """bf16 (refused until the precision slice) builds a trainer; with
    weights that do not sum to 1 it raises the JAX trainer's ValueError
    (``fed_tgan_tpu/train/federated.py:706-716``), f32 does not."""
    init = federated_init_from_jax(jinit)
    cfg = steps.TrainConfig(**SMALL, precision="bf16")
    port_fed.FederatedTrainer(init, cfg, device="cpu")
    init.weights = np.asarray(init.weights) * 1.5
    with pytest.raises(ValueError, match="bf16 delta-encoded aggregation"):
        port_fed.FederatedTrainer(init, cfg, device="cpu")
    port_fed.FederatedTrainer(init, steps.TrainConfig(**SMALL), device="cpu")


def test_zero_step_client_needs_opt_in(jinit):
    init = federated_init_from_jax(jinit)
    cfg = steps.TrainConfig(**dict(SMALL, batch_size=70))
    with pytest.raises(ValueError, match="fewer than batch_size"):
        port_fed.FederatedTrainer(init, cfg, device="cpu")
    cfg = steps.TrainConfig(**dict(SMALL, batch_size=70),
                            allow_zero_step_clients=True)
    tr = port_fed.FederatedTrainer(init, cfg, device="cpu").fit(1)
    assert tr.steps.tolist() == [2, 1, 0]
    assert (tr.last_metrics[2] == 0).all() and not tr.last_quarantined.any()
