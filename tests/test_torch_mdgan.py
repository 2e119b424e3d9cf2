"""The port's MD-GAN split-model trainer against ``fed_tgan_tpu``'s
``MDGANTrainer``, mirroring ``tests/test_mdgan.py``: 4 clients of the toy
table (3 local steps each at batch 40), one shared generator, a
discriminator per client.

Both start from the same models and the port draws JAX's numbers: per
round ``key, ekey = split(key)``, then ``split(fold_in(fold_in(ekey,
client), step), 13)`` with the critic on keys 0-8 and the generator on
9-12, injected through ``draws``.  Tolerance: at least 99% of the
entries of the shared generator and of each discriminator within atol
1e-5 + rtol 1e-3 after a round; one step's generator update against
Adam on the mean of the clients' gradients replayed with the JAX
package's functions within atol 1e-4 (``tests/test_mdgan.py:49``).
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fed_tgan_torch.interop import (
    convert_jax_checkpoint,
    discriminator_from_jax,
    federated_init_from_jax,
    generator_from_jax,
)
from fed_tgan_torch.models.ctgan import Generator
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.checkpoint import load_federated, save_federated
from fed_tgan_torch.serve.demo import write_artifact
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import open_model
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.mdgan import MDGANTrainer
from fed_tgan_tpu.data.ingest import TablePreprocessor
from fed_tgan_tpu.data.sharding import shard_dataframe
from fed_tgan_tpu.federation.init import federated_initialize
from fed_tgan_tpu.models.ctgan import discriminator_apply, generator_apply
from fed_tgan_tpu.models.losses import gradient_penalty
from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
from fed_tgan_tpu.ops.segments import apply_activate, cond_loss
from fed_tgan_tpu.parallel.mesh import client_mesh
from fed_tgan_tpu.runtime.checkpoint import save_federated as jax_save
from fed_tgan_tpu.train import steps as jsteps
from fed_tgan_tpu.train.mdgan import MDGANTrainer as JaxMDGAN
from test_torch_steps import jax_step_draws

torch.set_num_threads(1)
SMALL = dict(embedding_dim=8, gen_dims=(16, 16), dis_dims=(16, 16),
             batch_size=40, pac=4)
N = 4


@pytest.fixture(scope="module")
def jinit(toy_frame, toy_spec):
    shards = shard_dataframe(toy_frame, N, "iid", seed=9)
    return federated_initialize(
        [TablePreprocessor(frame=s, **toy_spec) for s in shards], seed=0,
        backend="jax")


@pytest.fixture(scope="module")
def init(jinit):
    return federated_init_from_jax(jinit)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _client(tree, i):
    return jax.tree.map(lambda x: np.asarray(x)[i], tree)


def _pair(jinit):
    """A JAX MD-GAN trainer on a 4-device mesh and a port one from its
    models, drawing its numbers."""
    jcfg = jsteps.TrainConfig(**SMALL)
    cfg = steps.TrainConfig(**SMALL)
    jtr = JaxMDGAN(jinit, config=jcfg, mesh=client_mesh(N), seed=0)
    jspec = JaxSpec.from_output_info(jinit.output_info)
    spec = SegmentSpec.from_output_info(jinit.output_info)
    chain, ekeys = [jtr._key], {}

    def draws(e, i, s):
        while e not in ekeys:
            chain[0], ekeys[len(ekeys)] = jax.random.split(chain[0])
        key = jax.random.fold_in(jax.random.fold_in(ekeys[e], i), s)
        return jax_step_draws(key, jspec, jcfg, 0)

    models = steps.Models.build(
        generator_from_jax(_host(jtr.gen.params), _host(jtr.gen.state)),
        discriminator_from_jax(_client(jtr.disc.params, 0), cfg.pac),
        spec, cfg)
    tr = MDGANTrainer(federated_init_from_jax(jinit), cfg, seed=0,
                      device="cpu", models=models, draws=draws)
    return jtr, tr


def _flat(state: dict) -> np.ndarray:
    return np.concatenate([np.ravel(state[k].detach().cpu().numpy())
                           for k in sorted(state)
                           if not k.endswith("num_batches_tracked")])


def _jax_generator(jtr) -> np.ndarray:
    return _flat(generator_from_jax(_host(jtr.gen.params),
                                    _host(jtr.gen.state)).state_dict())


def _count(opt_state) -> np.ndarray:
    """The Adam count of an optax chain's state."""
    for st in opt_state:
        if isinstance(st, optax.ScaleByAdamState):
            return np.asarray(st.count)
    raise AssertionError("no scale_by_adam state")


def _share(a, b) -> float:
    return float(np.isclose(a, b, atol=1e-5, rtol=1e-3).mean())


def test_mdgan_round_and_invariants(init):
    """The shared generator has no clients axis, the discriminators train
    and differ across clients after a round (never averaged), sampling is
    finite, K1 runs twice and K2 once a step (the plain versions here)."""
    tr = MDGANTrainer(init, steps.TrainConfig(**SMALL), seed=0,
                      device="cpu")
    d0 = tr.disc.stack.params.detach().clone()
    assert torch.equal(d0[0], d0[1])
    tr.fit(2)
    assert tr.gen.params.shape[0] == 1
    single = Generator(*tr._stack.generator.dims).state_dict()
    assert {k: tuple(v.shape) for k, v in tr._global_model().items()} == {
        k: tuple(v.shape) for k, v in single.items()}
    d1 = tr.disc.stack.params.detach()
    assert d1.shape[0] == N
    assert not torch.allclose(d1[0], d0[0])
    assert not torch.allclose(d1[0], d1[1])
    assert tr.last_metrics.shape == (N, 3)
    out = tr.sample(90, seed=3)
    assert out.shape == (90, 4) and np.isfinite(out).all()


def test_mdgan_round_matches_jax(jinit):
    """One round (3 steps) on JAX's draws: the shared generator and every
    client's discriminator within the tolerance."""
    jtr, tr = _pair(jinit)
    jtr.fit(1)
    tr.fit(1)
    assert _share(_flat(tr._global_model()), _jax_generator(jtr)) >= 0.99
    for i in range(N):
        want = _flat(discriminator_from_jax(_client(jtr.disc.params, i),
                                            tr.cfg.pac).state_dict())
        got = _flat(tr.disc.stack.unstack(i).state_dict())
        assert _share(got, want) >= 0.99, i
    assert int(tr.gen.opt.count[0]) == int(_count(jtr.gen.opt))


def test_generator_update_is_adam_on_the_mean_of_client_grads(jinit):
    """One step (every client's budget set to 1): the port's shared
    generator after it equals Adam on the mean of the four clients'
    generator gradients, each against the client's updated critic, as
    the JAX package's functions compute them."""
    jtr, tr = _pair(jinit)
    tr.steps = np.ones(N, dtype=np.int64)
    g0, gstate0 = _host(jtr.gen.params), _host(jtr.gen.state)
    d0, dopt0 = _host(jtr.disc.params), _host(jtr.disc.opt)
    tr.fit(1)
    got = tr._global_model()

    opt_g, opt_d = jsteps.make_optimizers(jtr.cfg)
    ekey = jax.random.split(jtr._key)[1]
    cfg, spec, B = jtr.cfg, jtr.spec, jtr.cfg.batch_size
    grads_sum = None
    for c in range(N):
        keys = jax.random.split(
            jax.random.fold_in(jax.random.fold_in(ekey, c), 0), 13)
        cond_c = jax.tree.map(lambda x: jnp.asarray(x[c]), jtr.cond_stack)
        rows_c = jax.tree.map(lambda x: jnp.asarray(x[c]), jtr.rows_stack)
        data_c = jnp.asarray(jtr.data_stack[c])
        dp = jax.tree.map(lambda x: jnp.asarray(x[c]), d0)
        dop = jax.tree.map(lambda x: jnp.asarray(x[c]), dopt0)
        z = jax.random.normal(keys[0], (B, cfg.embedding_dim))
        c1, _, col, opt_idx = cond_c.sample_train(keys[1], B)
        perm = jax.random.permutation(keys[2], B)
        real = data_c[rows_c.sample_rows(keys[3], col[perm], opt_idx[perm])]
        fake_raw, gstate_d = generator_apply(
            g0, gstate0, jnp.concatenate([z, c1], axis=1), train=True)
        fake_cat = jnp.concatenate(
            [apply_activate(fake_raw, spec, keys[4]), c1], axis=1)
        real_cat = jnp.concatenate([real, c1[perm]], axis=1)

        def d_loss(p):
            pen = gradient_penalty(
                lambda x: discriminator_apply(p, x, keys[7], cfg.pac),
                real_cat, fake_cat, keys[8], pac=cfg.pac)
            return (jnp.mean(discriminator_apply(p, fake_cat, keys[5],
                                                 cfg.pac))
                    - jnp.mean(discriminator_apply(p, real_cat, keys[6],
                                                   cfg.pac)) + pen)

        upd, _ = opt_d.update(jax.grad(d_loss)(dp), dop, dp)
        dp_new = jax.tree.map(lambda p, u: p + u, dp, upd)
        z2 = jax.random.normal(keys[9], (B, cfg.embedding_dim))
        c1g, m1g, _, _ = cond_c.sample_train(keys[10], B)

        def g_loss(p):
            raw, _ = generator_apply(p, gstate_d,
                                     jnp.concatenate([z2, c1g], axis=1),
                                     train=True)
            act = apply_activate(raw, spec, keys[11])
            y = discriminator_apply(dp_new, jnp.concatenate([act, c1g], 1),
                                    keys[12], cfg.pac)
            return -jnp.mean(y) + cond_loss(raw, spec, c1g, m1g)

        gg = jax.grad(g_loss)(g0)
        grads_sum = gg if grads_sum is None else jax.tree.map(
            lambda a, b: a + b, grads_sum, gg)
    g_grads = jax.tree.map(lambda g: g / float(N), grads_sum)
    upd_g, _ = opt_g.update(g_grads, opt_g.init(g0), g0)
    want_params = jax.tree.map(lambda p, u: np.asarray(p + u), g0, upd_g)
    want = generator_from_jax(want_params, gstate0).state_dict()
    for k in want:
        if "running" in k or "num_batches" in k:
            continue  # the replay does not track BatchNorm state
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-4, err_msg=k)


def test_mdgan_resume_artifact_and_time_stamps(init, tmp_path):
    """A save after 2 rounds resumes bit for bit; the artifact's generator
    is the shared one and serves the trainer's rows; ``save_time_stamp``
    writes one row a round to each of its two files."""
    cfg = steps.TrainConfig(**SMALL)
    tr = MDGANTrainer(init, cfg, seed=3, device="cpu").fit(2)
    save_federated(tr, str(tmp_path / "ck"), run_name="toy")
    tr.fit(2)
    back = load_federated(str(tmp_path / "ck"), device="cpu")
    assert back.completed_epochs == 2 and back.run_name == "toy"
    back.fit(2)
    for x, y in ((tr.gen.params, back.gen.params),
                 (tr.gen.state, back.gen.state),
                 (tr.gen.opt.exp_avg_sq, back.gen.opt.exp_avg_sq),
                 (tr.disc.stack.params, back.disc.stack.params),
                 (tr.disc.opt.exp_avg, back.disc.opt.exp_avg)):
        assert torch.equal(x, y)
    write_artifact(str(tmp_path / "art"), tr.to_saved(), init.global_meta,
                   init.encoders)
    engine = SamplingEngine(open_model(str(tmp_path / "art"), device="cpu",
                                       log=lambda *a: None))
    np.testing.assert_array_equal(engine.sample_encoded(60, seed=1),
                                  tr.sample_encoded(60, seed=1))
    tr.save_time_stamp(str(tmp_path))
    for name in ("time_train_d.csv", "time_loss_g.csv"):
        rows = list(csv.reader(open(tmp_path / name)))
        assert [float(r[0]) for r in rows] == tr.epoch_times


def test_jax_mdgan_checkpoint_converts(jinit, tmp_path):
    """A JAX ``mdgan`` checkpoint after one round, converted and loaded:
    the shared generator, each discriminator and the Adam counts equal
    JAX's, and the run goes on."""
    jtr = JaxMDGAN(jinit, config=jsteps.TrainConfig(**SMALL),
                   mesh=client_mesh(N), seed=0)
    jtr.fit(1)
    jax_save(jtr, str(tmp_path / "jax"), run_name="toy")
    convert_jax_checkpoint(str(tmp_path / "jax"), str(tmp_path / "port"))
    tr = load_federated(str(tmp_path / "port"), device="cpu")
    assert isinstance(tr, MDGANTrainer) and tr.completed_epochs == 1
    np.testing.assert_array_equal(_flat(tr._global_model()),
                                  _jax_generator(jtr))
    for i in range(N):
        want = _flat(discriminator_from_jax(_client(jtr.disc.params, i),
                                            tr.cfg.pac).state_dict())
        np.testing.assert_array_equal(
            _flat(tr.disc.stack.unstack(i).state_dict()), want)
    assert int(tr.gen.opt.count[0]) == int(_count(jtr.gen.opt))
    assert tr.disc.opt.count.tolist() == _count(jtr.disc.opt).tolist()
    tr.fit(1)
    assert np.isfinite(tr.last_metrics).all()
