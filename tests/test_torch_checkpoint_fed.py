"""The port's federated checkpoints (``fed_tgan_torch.runtime.checkpoint``
``save_federated`` / ``load_federated``) on the CPU.

- Resume is bit-exact: 2 rounds, save, load, 2 rounds equal 4
  uninterrupted rounds (``torch.equal``) on every parameter, buffer, Adam
  moment, schedule step and generator state.
- Crash safety and rotation, as ``tests/test_faults.py:147`` and ``:188``
  test the JAX package's; weights, strikes, dropped clients and round times
  survive (``tests/test_checkpoint.py:56``); a checkpoint loads on another
  device type than the one it was saved on.
- A JAX ``save_federated`` checkpoint converted by
  ``interop.convert_jax_checkpoint`` holds the JAX state exactly (atol 0),
  and one more round on both from the JAX draws stays within slice 3's
  tolerance (the check of ``tests/test_torch_federated.py``).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.sharding import shard_table
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.interop import convert_jax_checkpoint, params_to_jax_layout
from fed_tgan_torch.runtime.checkpoint import (
    find_resumable,
    list_resumable,
    load_federated,
    save_federated,
)
from fed_tgan_torch.serve.engine import step_seed
from fed_tgan_torch.testing.faults import FaultInjected, FaultPlan, install_plan
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.federated import FederatedTrainer

torch.set_num_threads(1)
CFG = dict(embedding_dim=8, gen_dims=(16, 16), dis_dims=(16, 16),
           batch_size=40, pac=4)


@pytest.fixture(autouse=True)
def _no_plan():
    install_plan(None)
    yield
    install_plan(None)


@pytest.fixture(scope="module")
def init4(toy_frame, toy_spec):
    table = {c: toy_frame[c].to_numpy() for c in toy_frame}
    shards = shard_table(table, 4, "iid", seed=9)
    return federated_initialize(
        [TablePreprocessor(table=t, **toy_spec) for t in shards], seed=0,
        device="cpu")


def trainer(init, seed=0, **cfg):
    return FederatedTrainer(init, steps.TrainConfig(**CFG, **cfg), seed=seed,
                            device="cpu")


def state(tr) -> list:
    """Every tensor a resumed run depends on, in a fixed order."""
    out = []
    for i, m in enumerate(tr.models):
        out += list(m.generator.state_dict().values())
        out += list(m.discriminator.state_dict().values())
        for opt, sched in ((m.opt_g, m.sched_g), (m.opt_d, m.sched_d)):
            for p in opt.param_groups[0]["params"]:
                out += [opt.state[p][k] for k in ("step", "exp_avg",
                                                  "exp_avg_sq")]
            out.append(torch.tensor([opt.param_groups[0]["lr"],
                                     float(sched.last_epoch)],
                                    dtype=torch.float64))
        out.append(tr.gens[i].get_state())
    return [t.detach().clone() for t in out]  # the trainer updates in place


def assert_same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_resume_is_bit_exact(init4, tmp_path, schedule):
    cfg = dict(lr_schedule=schedule, lr_decay_steps=16)
    straight = trainer(init4, **cfg).fit(4)
    part = trainer(init4, **cfg).fit(2)
    save_federated(part, str(tmp_path / "ckpt"), run_name="toy")
    back = load_federated(str(tmp_path / "ckpt"), device="cpu")
    assert (back.completed_epochs, back.run_name) == (2, "toy")
    assert_same(state(back), state(part))
    back.fit(2)
    assert back.completed_epochs == 4
    assert_same(state(back), state(straight))
    np.testing.assert_array_equal(back.sample(80, seed=5),
                                  straight.sample(80, seed=5))


def test_checkpoint_crash_leaves_previous_loadable(init4, tmp_path):
    path = str(tmp_path / "ckpt")
    tr = trainer(init4).fit(1)
    save_federated(tr, path, run_name="toy")
    want = state(tr)
    tr.fit(1)
    install_plan(FaultPlan.parse("crash_checkpoint:save=1"))
    with pytest.raises(FaultInjected):
        save_federated(tr, path, run_name="toy")
    # the torn stage stays, as after kill -9; the published one is intact
    assert [e for e in os.listdir(tmp_path) if ".tmp-" in e]
    assert find_resumable(path) == path
    back = load_federated(path, device="cpu")
    assert back.completed_epochs == 1
    assert_same(state(back), want)
    install_plan(None)  # a healthy save sweeps the stage, publishes round 2
    save_federated(tr, path, run_name="toy")
    assert not [e for e in os.listdir(tmp_path) if ".tmp-" in e]
    assert load_federated(path, device="cpu").completed_epochs == 2


def test_checkpoint_rotation_and_fallback(init4, tmp_path):
    path = str(tmp_path / "ckpt")
    tr = trainer(init4).fit(1)
    save_federated(tr, path, keep=2)
    tr.fit(1)
    save_federated(tr, path, keep=2)
    tr.fit(1)
    save_federated(tr, path, keep=2)  # round 1's generation falls off
    assert not os.path.exists(path + ".2")
    assert list_resumable(path) == [path, path + ".1"]
    assert load_federated(path, device="cpu").completed_epochs == 3
    assert load_federated(path + ".1", device="cpu").completed_epochs == 2
    assert os.path.exists(os.path.join(path, "COMPLETE"))
    os.remove(os.path.join(path, "host.json"))  # a torn primary
    assert find_resumable(path) == path + ".1"
    shutil.rmtree(path)
    shutil.rmtree(path + ".1")
    assert find_resumable(path) is None


def test_checkpoint_preserves_membership_and_times(init4, tmp_path):
    tr = trainer(init4, seed=3)
    tr.quarantine_strikes = 5
    tr.fit(1)
    tr._strikes[0] = 2
    tr.drop_client(3, "test")
    tr.fit(1)
    save_federated(tr, str(tmp_path / "c"))
    back = load_federated(str(tmp_path / "c"), device="cpu")
    np.testing.assert_array_equal(back.weights, tr.weights)
    assert back.weights.dtype == np.float32
    assert back._strikes.tolist() == [2, 0, 0, 0]
    assert back.dropped_clients == {3} and back.steps.tolist() == \
        tr.steps.tolist()
    assert back.epoch_times == tr.epoch_times
    assert back.phase_times == tr.phase_times
    assert (back.seed, back.quarantine_strikes) == (3, 5)
    meta = back.init.global_meta.to_json_dict()
    assert meta == tr.init.global_meta.to_json_dict()
    for a, b in zip(back.init.client_matrices, tr.init.client_matrices):
        np.testing.assert_array_equal(a, b)
    assert [e.to_dict() for e in back.init.encoders] == \
        [e.to_dict() for e in tr.init.encoders]


def test_checkpoint_loads_on_another_device(init4, tmp_path):
    """A checkpoint whose generators were saved on the card loads on the
    CPU: the weights and moments exactly, the generators reseeded from
    (seed, client, round).  (The card half is in test_torch_gpu.py.)"""
    path = str(tmp_path / "c")
    tr = trainer(init4).fit(1)
    save_federated(tr, path)
    with open(os.path.join(path, "host.json")) as f:
        host = json.load(f)
    for c in host["clients"]:
        c["rng_device"] = "cuda"
    with open(os.path.join(path, "host.json"), "w") as f:
        json.dump(host, f)
    back = load_federated(path, device="cpu")
    for m, n in zip(back.models, tr.models):
        assert_same(list(m.generator.state_dict().values()),
                    list(n.generator.state_dict().values()))
    want = torch.Generator().manual_seed(step_seed(step_seed(0, 1), 1))
    assert torch.equal(back.gens[1].get_state(), want.get_state())
    back.fit(1)
    assert np.isfinite(back.last_metrics).all()


def test_not_a_federated_checkpoint(tmp_path):
    os.makedirs(tmp_path / "x")
    with open(tmp_path / "x" / "host.json", "w") as f:
        json.dump({"kind": "synthesizer_torch", "version": 1}, f)
    with pytest.raises(ValueError, match="not a port federated checkpoint"):
        load_federated(str(tmp_path / "x"), device="cpu")


# ------------------------------------------------------- JAX conversion


def test_converted_jax_checkpoint_resumes(tmp_path):
    from test_torch_federated import KW, SMALL, client_frames, compare
    from test_torch_steps import jax_step_draws

    from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
    from fed_tgan_tpu.federation.init import federated_initialize as jinit_fn
    from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
    from fed_tgan_tpu.parallel.mesh import client_mesh
    from fed_tgan_tpu.runtime.checkpoint import save_federated as jsave
    from fed_tgan_tpu.train import steps as jsteps
    from fed_tgan_tpu.train.federated import FederatedTrainer as JaxTrainer

    jinit = jinit_fn([JaxPre(frame=f, name="toy", **KW)
                      for f in client_frames()], seed=0, backend="jax")
    jcfg = jsteps.TrainConfig(**SMALL)
    jtr = JaxTrainer(jinit, config=jcfg, mesh=client_mesh(3), seed=0)
    jtr.fit(1)
    jsave(jtr, str(tmp_path / "jax"), run_name="toy")
    convert_jax_checkpoint(str(tmp_path / "jax"), str(tmp_path / "port"))
    tr = load_federated(str(tmp_path / "port"), device="cpu")
    assert (tr.completed_epochs, tr.run_name) == (1, "toy")
    np.testing.assert_array_equal(tr.weights, np.asarray(jtr.weights))
    np.testing.assert_array_equal(tr._strikes, jtr._strikes[:3])
    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    adam_g, adam_d = jtr.models.opt_g[1], jtr.models.opt_d[0]
    for i, m in enumerate(tr.models):
        st = {**m.opt_g.state, **m.opt_d.state}
        for of, want in (
                (None, (jtr.models.params_g, jtr.models.params_d,
                        jtr.models.state_g)),
                (lambda p: st[p]["exp_avg"], (adam_g.mu, adam_d.mu, None)),
                (lambda p: st[p]["exp_avg_sq"], (adam_g.nu, adam_d.nu, None))):
            got = params_to_jax_layout(m, of=of)
            for part, w in zip(("params_g", "params_d", "state_g"), want):
                if w is None:
                    continue
                for a, b in zip(leaves(got[part]), leaves(w)):
                    np.testing.assert_array_equal(a, b[i])
        assert float(m.opt_g.state[m.generator.out.bias]["step"]) == \
            int(np.asarray(adam_g.count)[i])

    # one more round on both, the port on the JAX trainer's draws
    jspec = JaxSpec.from_output_info(jinit.output_info)
    chain, rkeys, first_grads = [jtr._key], {}, {}

    def draws(e, i, s):
        while e not in rkeys:
            chain[0], rkeys[1 + len(rkeys)] = jax.random.split(chain[0])
        if s == 1:
            first_grads[i] = params_to_jax_layout(tr.models[i],
                                                  of=lambda p: p.grad)
        key = jax.random.fold_in(jax.random.fold_in(rkeys[e], i), s)
        return jax_step_draws(key, jspec, jcfg, 0)

    tr.draws = draws
    jtr.fit(1)
    tr.fit(1)
    compare(jtr, tr, first_grads, after_round0=True)
