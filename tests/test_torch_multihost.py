"""The multi-process federation (``fed_tgan_torch.train.multihost``): real
worlds of rank 0 and 2 participants as processes, aggregating over gloo
on the CPU.

- Against JAX, the whole slice: the participants load JAX's initial
  models (``client_models_from_jax``) and every step's draws, regenerated
  from the JAX trainer's key layout as ``tests/test_torch_federated.py``
  does, into ``client_train(models=, draws=)``; after 2 rounds rank 1's
  aggregated state matches JAX's in-process ``FederatedTrainer`` within
  that file's tolerance (atol 1e-5 + rtol 1e-3, entries whose first-step
  gradient is below 1e-6 set aside, fewer than 5%), both participants'
  final parameters are equal, rank 0's check passes, and the world is
  held against the port's in-process trainer on the same draws.
- Through the CLI on Intrusion-shaped shards: rank 0's artifacts, the
  ranks' final generator and EMA equal, the world against the port's
  in-process ``FederatedTrainer`` on the same shards and seed within the
  round tolerance (whether bit-equal is printed), a per-rank resume equal
  to the straight run, a resume under another world size or config
  refused, an update fault gated on every rank, and a ``kill_client``
  world ending every process within its timeout.
"""

import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from fed_tgan_torch.data.csvio import read_csv, write_csv
from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.sharding import shard_table
from fed_tgan_torch.datasets import PRESETS, preprocessor_kwargs
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.interop import (
    client_models_from_jax,
    federated_init_from_jax,
    params_to_jax_layout,
)
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.serve.demo import write_intrusion_csv
from fed_tgan_torch.testing.faults import FaultPlan, install_plan
from fed_tgan_torch.train import federated as port_fed
from fed_tgan_torch.train import multihost, steps
from fed_tgan_torch.train.sampler import CondSampler
from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
from fed_tgan_tpu.federation.init import (
    federated_initialize as jax_federated_initialize,
)
from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
from fed_tgan_tpu.parallel.mesh import client_mesh
from fed_tgan_tpu.train import steps as jsteps
from fed_tgan_tpu.train.federated import FederatedTrainer as JaxTrainer
from test_torch_federated import KW, SMALL, client_frames
from test_torch_steps import jax_step_draws
from test_torch_world import PROC_TIMEOUT, launch_world, next_port, world_env

torch.set_num_threads(1)
ATOL, RTOL, TINY = 1e-5, 1e-3, 1e-6


def port_kwargs():
    kw = preprocessor_kwargs(PRESETS["intrusion"])
    return kw, kw.pop("selected_columns", None)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    table = read_csv(write_intrusion_csv(str(d / "intr.csv"), 300, 0))
    paths = []
    for i, part in enumerate(shard_table(table, 2, "iid", seed=1)):
        paths.append(str(d / f"shard{i + 1}.csv"))
        write_csv(part, paths[-1])
    return paths


def cli_common(out, *extra):
    return ["--dataset", "intrusion", "--sample-rows", "100", "--batch-size",
            "50", "--embedding-dim", "16", "--device", "cpu", "--seed", "1",
            "--out-dir", str(out), "--params-out", str(out / "params"),
            *extra]


STRAIGHT = ("-epochs", "2", "--ema-decay", "0.9", "--save-every", "1")


@pytest.fixture(scope="module")
def straight(shards, tmp_path_factory):
    """A 2-round world with the EMA and a save every round."""
    out = tmp_path_factory.mktemp("straight")
    res = launch_world(str(out), cli_common(out, *STRAIGHT), shards)
    return out, res


def load_params(out, rank):
    return torch.load(out / "params" / f"params_rank{rank}.pt")


def in_process(shards, plan=None, **cfg_kw):
    """The port's in-process trainer on the same shards, seed and config
    as :func:`cli_common`, 2 rounds."""
    kw, sel = port_kwargs()
    tables = [read_csv(p) for p in shards]
    cols = list(sel) if sel else list(tables[0])
    pres = [TablePreprocessor(table=t, name="Intrusion",
                              selected_columns=cols, **kw) for t in tables]
    init = federated_initialize(pres, seed=1, device="cpu")
    cfg = steps.TrainConfig(batch_size=50, embedding_dim=16, **cfg_kw)
    install_plan(plan)
    try:
        return port_fed.FederatedTrainer(init, cfg, seed=1,
                                         device="cpu").fit(2)
    finally:
        install_plan(None)


def held_to(got: dict, want: dict, what: str) -> bool:
    """``got`` within the round tolerance of ``want``; whether bit-equal."""
    equal = True
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what} {k}")
        equal &= torch.equal(got[k], v)
    print(f"{what}: bit-equal to the in-process trainer: {equal}")
    return equal


def test_cli_world_writes_the_artifacts_and_agrees_across_ranks(straight):
    out, res = straight
    assert [rc for rc, _, _ in res] == [0, 0, 0], res
    text = res[0][1]
    assert "multihost init complete: 2 clients" in text
    assert "collective backend gloo" in text
    assert "final aggregated params identical across 2 participants" in text
    for e in (0, 1):
        rows = open(out / "Intrusion_result"
                    / f"Intrusion_synthesis_epoch_{e}.csv").read().splitlines()
        assert len(rows) == 101 and len(rows[0].split(",")) == 42
    for f in ("models/Intrusion.json", "models/label_encoders_Intrusion.json",
              "timestamp_experiment.csv", "timing_phases.csv"):
        assert (out / f).is_file(), f
    assert len(open(out / "timestamp_experiment.csv").read().split()) == 2
    a, b = load_params(out, 1), load_params(out, 2)
    for part in ("generator", "ema"):
        assert a[part].keys() == b[part].keys()
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])
    for r in (1, 2):
        assert (out / "checkpoint" / f"multihost_rank{r}" / "COMPLETE").is_file()
        assert "training complete" in res[r][1]


def test_cli_world_matches_the_in_process_trainer(straight, shards):
    out, res = straight
    assert [rc for rc, _, _ in res] == [0, 0, 0]
    tr = in_process(shards, ema_decay=0.9)
    got = load_params(out, 1)
    held_to(got["generator"], tr._global_model(use_ema=False), "generator")
    held_to(got["ema"], tr._global_model(use_ema=True), "ema")


def test_per_rank_resume_equals_the_straight_run(straight, shards, tmp_path):
    """1 round and a save, then ``--resume`` to 2 rounds: the final
    generator and EMA equal the straight 2-round world's bit for bit."""
    first = launch_world(str(tmp_path), cli_common(
        tmp_path, "-epochs", "1", "--ema-decay", "0.9", "--save-every", "1"),
        shards, tag="a")
    assert [rc for rc, _, _ in first] == [0, 0, 0], first
    resumed = launch_world(str(tmp_path), cli_common(
        tmp_path, *STRAIGHT, "--resume"), shards, tag="b")
    assert [rc for rc, _, _ in resumed] == [0, 0, 0], resumed
    want = load_params(straight[0], 1)
    for r in (1, 2):
        got = load_params(tmp_path, r)
        for part in ("generator", "ema"):
            assert all(torch.equal(got[part][k], want[part][k])
                       for k in want[part]), (r, part)


@pytest.mark.parametrize("change", ["world_size", "config"])
def test_resume_under_another_world_or_config_fails_fast(straight, change):
    out = straight[0]
    run = multihost.MultihostRun(epochs=3, seed=1, resume=True,
                                 ckpt_dir=str(out / "checkpoint"))
    cfg = steps.TrainConfig(batch_size=50, embedding_dim=16, ema_decay=0.9)
    n = 2
    if change == "world_size":
        n = 3
    else:
        cfg = steps.TrainConfig(batch_size=50, embedding_dim=8,
                                ema_decay=0.9)
    with pytest.raises(RuntimeError, match="does not match this run"):
        multihost._load_participant(run, 1, n, cfg)
    host, arrays = multihost._load_participant(
        run, 1, 2, steps.TrainConfig(batch_size=50, embedding_dim=16,
                                     ema_decay=0.9))
    assert host["epochs_done"] == 2 and "ema.params" in arrays


def test_update_fault_is_gated_on_every_rank(shards, tmp_path):
    """``scale_update:factor=1000,rank=2``: every rank corrupts client 1's
    position of the gathered stack and gates the stack as the in-process
    trainer does under the same plan (with two clients the two-sided norm
    test masks the honest client, whose norm falls below the median /
    factor), the ranks stay equal, and the result is the in-process
    trainer's."""
    spec = "scale_update:factor=1000,rank=2"
    res = launch_world(str(tmp_path), cli_common(
        tmp_path, "-epochs", "2", "--faults", spec), shards)
    assert [rc for rc, _, _ in res] == [0, 0, 0], res
    tr = in_process(shards, plan=FaultPlan.parse(spec))
    masked = np.flatnonzero(tr.last_quarantined).tolist()
    assert masked and not tr.dropped_clients
    for r in (1, 2):
        for e in (0, 1):
            assert (f"quarantined clients {masked} in round {e}"
                    in res[r][2]), res[r][2]
    a, b = load_params(tmp_path, 1), load_params(tmp_path, 2)
    assert all(torch.equal(a["generator"][k], b["generator"][k])
               for k in a["generator"])
    held_to(a["generator"], tr._global_model(), "scaled update")


def test_kill_client_ends_every_process_cleanly(shards, tmp_path):
    """``kill_client:rank=2,round=2``: rank 2 hard-exits (17) at the start
    of round 2, rank 1's all-gather fails, rank 0 raises JAX's
    "unreachable ... relaunch with --resume" once rank 1's connection is
    gone; every process exits non-zero within its timeout."""
    res = launch_world(
        str(tmp_path), cli_common(tmp_path, "-epochs", "3", "--faults",
                                  "kill_client:rank=2,round=2"),
        shards, env={"FED_TGAN_TORCH_TRANSPORT_HEARTBEAT_TIMEOUT_MS": "8000"})
    rcs = [rc for rc, _, _ in res]
    assert rcs[2] == 17 and rcs[1] != 0 and rcs[0] != 0, res
    assert "hard-exiting at round 2" in res[2][2]
    err = res[0][2]
    assert "multihost training aborted: rank" in err
    assert "unreachable" in err and "relaunch with --resume" in err


# ------------------------------------------------------------ against JAX

RANK_SCRIPT = r'''
import pickle
import sys
from types import SimpleNamespace

import torch

torch.set_num_threads(1)
from fed_tgan_torch.interop import params_to_jax_layout
from fed_tgan_torch.parallel import multihost
from fed_tgan_torch.runtime.transport import ClientTransport, ServerTransport
from fed_tgan_torch.train.multihost import (MultihostRun, client_train,
                                            server_train)
from fed_tgan_torch.train.steps import init_models

rank, port, path, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
with open(path, "rb") as f:
    blob = pickle.load(f)
n, cfg = blob["n"], blob["cfg"]
run = MultihostRun(epochs=blob["rounds"], sample_rows=60, seed=0)
try:
    if rank == 0:
        with ServerTransport(port, n) as t:
            multihost.initialize_multihost("127.0.0.1", port, n + 1, 0,
                                           "cpu", 120_000)
            server_train(t, blob["server"], run, "toy", out_dir=out)
    else:
        with ClientTransport("127.0.0.1", port, rank) as t:
            multihost.initialize_multihost("127.0.0.1", port, n + 1, rank,
                                           "cpu", 120_000)
            models = []
            for g, d in blob["models"]:
                m = init_models(blob["spec"], cfg, 0, "cpu")
                m.generator.load_state_dict(g)
                m.discriminator.load_state_dict(d)
                models.append(m)
            draws = blob["draws"]
            res = client_train(
                t, blob["clients"][rank - 1], cfg, run, device="cpu",
                models=models,
                draws=lambda e, i, s: SimpleNamespace(
                    tensors=lambda: draws[(e, i, s)]))
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump({"layout": params_to_jax_layout(
                res["stack"].to_models(0)), "params_g": res["params_g"]}, f)
finally:
    multihost.shutdown()
'''


def jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_world_matches_the_jax_trainer_on_injected_draws(tmp_path):
    rounds, frames = 2, client_frames()[:2]  # 150 and 100 rows: 3, 2 steps
    jinit = jax_federated_initialize(
        [JaxPre(frame=f, name="toy", **KW) for f in frames], seed=0,
        backend="jax")
    jcfg, cfg = jsteps.TrainConfig(**SMALL), steps.TrainConfig(**SMALL)
    jtr = JaxTrainer(jinit, config=jcfg, mesh=client_mesh(2), seed=0)
    jspec = JaxSpec.from_output_info(jinit.output_info)
    spec = SegmentSpec.from_output_info(jinit.output_info)
    models = client_models_from_jax(jtr.models, spec, cfg, "cpu")
    init = federated_init_from_jax(jinit)
    n_steps = [len(m) // cfg.batch_size for m in init.client_matrices]
    draws, chain = {}, jtr._key
    for e in range(rounds):
        chain, rkey = jax.random.split(chain)
        for i, n in enumerate(n_steps):
            for s in range(n):
                key = jax.random.fold_in(jax.random.fold_in(rkey, i), s)
                draws[(e, i, s)] = [t.clone() for t in jax_step_draws(
                    key, jspec, jcfg, 0).tensors()]
    counts = sum(CondSampler.count_matrix(m, spec)
                 for m in init.client_matrices)
    clients = [{"transformer": init.transformers[c],
                "matrix": init.client_matrices[c], "weights": init.weights,
                "rows_per_client": init.rows_per_client,
                "cond_counts": counts, "global_meta": init.global_meta,
                "encoders": init.encoders} for c in range(2)]
    blob = {"n": 2, "rounds": rounds, "cfg": cfg, "spec": spec,
            "draws": draws, "clients": clients,
            "server": {"global_meta": init.global_meta,
                       "encoders": init.encoders},
            "models": [(m.generator.state_dict(),
                        m.discriminator.state_dict()) for m in models]}
    with open(tmp_path / "blob.pkl", "wb") as f:
        pickle.dump(blob, f)
    (tmp_path / "rank.py").write_text(RANK_SCRIPT)
    port = next_port()
    penv = world_env()
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py"), str(r), str(port),
         str(tmp_path / "blob.pkl"), str(tmp_path)], cwd=str(tmp_path),
        env=penv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(3)]
    try:
        logs = [p.communicate(timeout=PROC_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0], logs
    assert "final aggregated params identical across 2" in logs[0]
    world = [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
             for r in (1, 2)]
    # equal but for BatchNorm's batch counts: each client's local steps
    assert all(np.array_equal(world[0]["params_g"][k], world[1]["params_g"][k])
               for k in world[0]["params_g"]
               if not k.endswith("num_batches_tracked"))

    # the port's in-process trainer on the same models and draws, and the
    # first-step gradients whose tiny entries are set aside
    first_grads = {}

    def draw_fn(e, i, s):
        if e == 0 and s == 1:
            first_grads[i] = params_to_jax_layout(tr.models[i],
                                                  of=lambda p: p.grad)
        return SimpleNamespace(tensors=lambda: draws[(e, i, s)])

    tr = port_fed.FederatedTrainer(init, cfg, seed=0, device="cpu",
                                   models=models, draws=draw_fn)
    tr.fit(rounds)
    jtr.fit(rounds)
    tiny = {part: [np.zeros(x.shape, bool) for x in
                   jax_leaves(first_grads[0][part])]
            for part in ("params_g", "params_d")}
    for g in first_grads.values():
        for part in tiny:
            tiny[part] = [t | (np.abs(x) < TINY)
                          for t, x in zip(tiny[part], jax_leaves(g[part]))]
    set_aside = total = 0
    equal = True
    mine = params_to_jax_layout(tr.models[0])
    for part in ("params_g", "params_d", "state_g"):
        want = [x[0] for x in jax_leaves(getattr(jtr.models, part))]
        got = jax_leaves(world[0]["layout"][part])
        masks = tiny.get(part) or [np.zeros(x.shape, bool) for x in want]
        for a, b, m, p in zip(got, want, masks, jax_leaves(mine[part])):
            np.testing.assert_allclose(a[~m], b[~m], atol=ATOL, rtol=RTOL,
                                       err_msg=part)
            np.testing.assert_allclose(a, p, atol=ATOL, rtol=RTOL,
                                       err_msg=part)
            equal &= np.array_equal(a, p)
            set_aside += int(m.sum())
            total += m.size
    assert set_aside < 0.05 * total, (set_aside, total)
    print(f"world vs in-process port trainer on JAX's draws: bit-equal "
          f"{equal}")


def test_jax_participant_checkpoint_converts_to_the_port_rank_file(tmp_path):
    """A JAX participant's ``multihost_rank<r>.pkl`` (as ``fed_tgan_tpu/
    train/multihost.py:125-166`` writes it: the rank's post-aggregation
    ``ModelBundle`` with its optax states, the key chain, the raw EMA)
    becomes the port's per-rank checkpoint: weights, BatchNorm state,
    Adam counts and moments and the EMA carried over exactly, the
    generator reseeded from ``(seed, client, round)``, and the port's
    loader accepts it under the same world and config."""
    from fed_tgan_torch import interop
    from fed_tgan_torch.serve.engine import step_seed
    from fed_tgan_tpu.train.steps import config_signature

    jinit = jax_federated_initialize(
        [JaxPre(frame=f, name="toy", **KW) for f in client_frames()[:2]],
        seed=0, backend="jax")
    jcfg = jsteps.TrainConfig(**SMALL, lr_schedule="cosine",
                              lr_decay_steps=40)
    jtr = JaxTrainer(jinit, config=jcfg, mesh=client_mesh(2), seed=3)
    jtr.fit(1)
    one = jax.tree.map(lambda x: np.asarray(x)[1], jtr.models)
    ema = jax.tree.map(lambda x: np.asarray(x)[1] * 0.5,
                       (jtr.models.params_g, jtr.models.state_g))
    with open(tmp_path / "multihost_rank2.pkl", "wb") as f:
        pickle.dump({"format": 1, "rank": 2, "seed": 3, "n_clients": 2,
                     "config": config_signature(jcfg), "epochs_done": 1,
                     "models": one, "ema": ema,
                     "chain": np.asarray(jax.random.key_data(jtr._key))}, f)
    ckpt = tmp_path / "ckpt"
    path = interop.convert_jax_checkpoint(
        str(tmp_path / "multihost_rank2.pkl"), str(ckpt))
    assert path == str(ckpt / "multihost_rank2")
    cfg = steps.TrainConfig(**SMALL, lr_schedule="cosine", lr_decay_steps=40)
    run = multihost.MultihostRun(epochs=2, seed=3, ckpt_dir=str(ckpt))
    host, arrays = multihost._load_participant(run, 2, 2, cfg)
    assert host["epochs_done"] == 1 and host["ema_updates"] == 1
    gen = interop.generator_from_jax(one.params_g, one.state_g)
    np.testing.assert_array_equal(arrays["g.params"][0],
                                  interop._flat(gen).numpy())
    dis = interop.discriminator_from_jax(one.params_d, cfg.pac)
    np.testing.assert_array_equal(arrays["d.params"][0],
                                  interop._flat(dis).numpy())
    bn = np.concatenate([t.numpy() for b in gen.blocks for t in (
        b.bn.running_mean, b.bn.running_var)])
    np.testing.assert_array_equal(arrays["g.bn_state"], bn)
    count, mu, nu = (one.opt_g[1].count, one.opt_g[1].mu, one.opt_g[1].nu)
    assert arrays["opt_g.count"].tolist() == [int(count)]
    np.testing.assert_array_equal(arrays["opt_g.exp_avg"][0], interop._flat(
        interop.generator_from_jax(mu, one.state_g)).numpy())
    np.testing.assert_array_equal(arrays["opt_d.exp_avg_sq"][0],
                                  interop._flat(interop.discriminator_from_jax(
                                      one.opt_d[0].nu, cfg.pac)).numpy())
    egen = interop.generator_from_jax(*ema)
    np.testing.assert_array_equal(arrays["ema.params"],
                                  interop._flat(egen).numpy())
    want = torch.Generator().manual_seed(step_seed(step_seed(3, 1), 1))
    assert torch.equal(torch.as_tensor(arrays["rng"]), want.get_state())
