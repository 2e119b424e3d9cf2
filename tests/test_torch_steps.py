"""The port's train step against ``fed_tgan_tpu.train.steps.make_train_step``.

Both start from the same weights (a JAX ``ModelBundle`` converted by
``interop.bundle_from_jax``).  Every random tensor of a JAX step is
regenerated from its key layout and injected into the port as a
``StepDraws``: ``split(key, 13)``, critic keys 0-8 (``fold_in(keys[0],
it)`` split 9 ways per critic iteration when ``d_steps > 1``), generator
keys 9-12, and per discriminator forward one ``split`` per hidden layer for
its dropout mask (``steps.py:285-369``, ``ctgan.py:149-152``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
from fed_tgan_tpu.train import steps as jsteps
from fed_tgan_tpu.train.sampler import CondSampler as JaxCond
from fed_tgan_tpu.train.sampler import RowSampler as JaxRows
from fed_tgan_torch.interop import bundle_from_jax, params_to_jax_layout
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.sampler import CondSampler, RowSampler

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
PARAM_ATOL = 1e-6
# Adam's first update is g / (|g| + 1e-8): for |g| below ~1e-6 float32
# rounding in either package can flip its sign, so such entries are set
# aside (and counted) in the parameter comparison
TINY_GRAD = 1e-6

SMALL = dict(embedding_dim=16, gen_dims=(32, 32), dis_dims=(32, 32), pac=10,
             batch_size=40)
COND_INFO = [(1, "tanh"), (3, "softmax"), (4, "softmax"), (1, "tanh"),
             (2, "softmax")]
UNCOND_INFO = [(1, "tanh"), (1, "tanh"), (1, "tanh")]


def encoded_table(info, n, seed):
    """A random encoded matrix: tanh dims in (-0.99, 0.99), one-hots."""
    rng = np.random.default_rng(seed)
    parts = []
    for size, kind in info:
        if kind == "tanh":
            parts.append(rng.uniform(-0.99, 0.99, (n, 1)))
        else:
            oh = np.zeros((n, size))
            oh[np.arange(n), rng.integers(0, size, n)] = 1.0
            parts.append(oh)
    return np.concatenate(parts, axis=1).astype(np.float32)


def jax_masks(key, cfg):
    out = []
    for h in cfg.dis_dims:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.bernoulli(
            sub, 0.5, (cfg.batch_size // cfg.pac, h)))))
    return out


def jax_step_draws(key, jspec, cfg, n_rows):
    """The draws ``make_train_step``'s step makes from ``key``."""
    B, has_cond = cfg.batch_size, jspec.n_discrete > 0
    t = lambda a: torch.from_numpy(np.array(a))
    keys = jax.random.split(key, 13)

    def cond(k):
        if not has_cond:
            return None, None
        kcol, kopt = jax.random.split(k)
        return (t(jax.random.randint(kcol, (B,), 0, jspec.n_discrete)).long(),
                t(jax.random.uniform(kopt, (B, 1))))

    if cfg.d_steps == 1:
        d_key_sets = [keys[:9]]
    else:
        d_key_sets = [jax.random.split(jax.random.fold_in(keys[0], it), 9)
                      for it in range(cfg.d_steps)]
    blocks = []
    for dk in d_key_sets:
        col, r = cond(dk[1])
        if has_cond:
            perm = t(jax.random.permutation(dk[2], B)).long()
            row_u = t(jax.random.uniform(dk[3], (B,)))
        else:
            perm = None
            idx = np.asarray(jax.random.randint(dk[3], (B,), 0, n_rows))
            row_u = torch.from_numpy(((idx + 0.5) / n_rows).astype(np.float32))
        blocks.append(steps.DDraws(
            z=t(jax.random.normal(dk[0], (B, cfg.embedding_dim))), col=col,
            r=r, perm=perm, row_u=row_u,
            u=t(jax.random.uniform(dk[4], (B, jspec.dim))),
            keep_fake=jax_masks(dk[5], cfg), keep_real=jax_masks(dk[6], cfg),
            keep_gp=jax_masks(dk[7], cfg),
            alpha=t(jax.random.uniform(dk[8], (B, 1)))))
    col, r = cond(keys[10])
    return steps.StepDraws(d=blocks, g=steps.GDraws(
        z=t(jax.random.normal(keys[9], (B, cfg.embedding_dim))), col=col, r=r,
        u=t(jax.random.uniform(keys[11], (B, jspec.dim))),
        keep=jax_masks(keys[12], cfg)))


def adam_moments(opt_state):
    """(mu, nu) of the ``scale_by_adam`` state in an optax chain state."""
    for s in opt_state:
        if isinstance(s, optax.ScaleByAdamState):
            return s.mu, s.nu
    raise AssertionError("no scale_by_adam state")


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def run_both(info, cfg_kw, n_steps=2, seed=0):
    jcfg = jsteps.TrainConfig(**cfg_kw)
    cfg = steps.TrainConfig(**cfg_kw)
    jspec, spec = JaxSpec.from_output_info(info), SegmentSpec.from_output_info(info)
    data = encoded_table(info, 80, seed)
    jcond, jrows = JaxCond.from_data(data, jspec), JaxRows.from_data(data, jspec)
    cond = CondSampler.from_data(data, spec, "cpu")
    rows = RowSampler.from_data(data, spec, "cpu")
    jmodels = jsteps.init_models(jax.random.key(seed), jspec, jcfg)
    models = bundle_from_jax(jmodels, spec, cfg, "cpu")
    step = jax.jit(jsteps.make_train_step(jspec, jcfg))
    tdata = torch.from_numpy(data)
    history = []
    for i in range(n_steps):
        key = jax.random.fold_in(jax.random.key(seed + 100), i)
        prev = params_to_jax_layout(models)
        jmodels, jmet = step(jmodels, jnp.asarray(data), jcond, jrows, key)
        met = steps.train_step(models, tdata, cond, rows,
                               jax_step_draws(key, jspec, jcfg, len(data)))
        history.append((prev, jmodels, jax.device_get(jmet), met,
                        snapshot(models)))
    return models, history


def snapshot(models):
    """The port's parameters, gradients and Adam moments in JAX layout."""
    state = {**models.opt_g.state, **models.opt_d.state}
    moment = lambda name: lambda p: state[p][name]
    return {"params": params_to_jax_layout(models),
            "grad": params_to_jax_layout(models, of=lambda p: p.grad),
            "mu": params_to_jax_layout(models, of=moment("exp_avg")),
            "nu": params_to_jax_layout(models, of=moment("exp_avg_sq"))}


def check_step(snap, jmodels, jmet, met, tiny_mask):
    for name in ("loss_d", "pen", "loss_g"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    got = snap["params"]
    for part, opt in (("params_d", jmodels.opt_d),
                      ("params_g", jmodels.opt_g)):
        mu, nu = adam_moments(opt)
        # the Adam moments are running sums of the gradients (G's include
        # the L2 term in both packages)
        t_mu, t_nu = snap["mu"][part], snap["nu"][part]
        for a, b in zip(leaves(t_mu), leaves(mu)):
            np.testing.assert_allclose(a, b, atol=GRAD_ATOL * 0.5,
                                       rtol=GRAD_RTOL)
        for a, b in zip(leaves(t_nu), leaves(nu)):
            np.testing.assert_allclose(a, b, atol=GRAD_ATOL ** 2,
                                       rtol=GRAD_RTOL * 2)
        want = leaves(getattr(jmodels, part))
        for a, b, tiny in zip(leaves(got[part]), want, tiny_mask[part]):
            np.testing.assert_allclose(a[~tiny], b[~tiny], atol=PARAM_ATOL)
    for a, b in zip(leaves(got["state_g"]), leaves(jmodels.state_g)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d_steps", [1, 2])
@pytest.mark.parametrize("info", [COND_INFO, UNCOND_INFO],
                         ids=["cond", "uncond"])
def test_two_train_steps_match_jax(info, d_steps):
    models, history = run_both(info, dict(SMALL, d_steps=d_steps))
    tiny = None
    set_aside = 0
    for prev, jmodels, jmet, met, snap in history:
        if tiny is None:  # entries whose first Adam update is a coin flip
            tiny = {}
            for part, opt in (("params_d", jmodels.opt_d),
                              ("params_g", jmodels.opt_g)):
                mu, _ = adam_moments(opt)
                tiny[part] = [np.abs(m) < TINY_GRAD * 0.5 for m in leaves(mu)]
                set_aside += sum(int(t.sum()) for t in tiny[part])
        check_step(snap, jmodels, jmet, met, tiny)
    # the tiny-gradient entries are few
    total = sum(p.numel() for p in models.generator.parameters()) + sum(
        p.numel() for p in models.discriminator.parameters())
    assert set_aside < 0.05 * total, (set_aside, total)


def test_first_step_gradients_match_jax():
    """The gradient itself, from the first update's first moment
    (mu = (1 - beta1) * (g + l2 * p) in both packages)."""
    models, history = run_both(COND_INFO, dict(SMALL), n_steps=1)
    prev, jmodels, _, _, snap = history[0]
    cfg = models.cfg
    for part, opt, l2 in (("params_d", jmodels.opt_d, 0.0),
                          ("params_g", jmodels.opt_g, cfg.l2scale)):
        mu, _ = adam_moments(opt)
        want = [m / (1 - cfg.beta1) - l2 * p
                for m, p in zip(leaves(mu), leaves(prev[part]))]
        for a, b in zip(leaves(snap["grad"][part]), want):
            np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)


CONFIGS = [
    {},
    {"lr_schedule": "cosine", "lr_decay_steps": 20, "lr_end_frac": 0.1},
    {"d_steps": 2},
    {"lr_schedule": "linear", "lr_decay_steps": 7, "lr_end_frac": 0.25},
]


def test_trainconfig_fields_mirror_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(steps.TrainConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(jsteps.TrainConfig)]
    assert ours == theirs


@pytest.mark.parametrize("kw", CONFIGS[1:2] + CONFIGS[3:],
                         ids=["cosine", "linear"])
def test_schedules_match_optax(kw):
    cfg = steps.TrainConfig(**kw)
    if cfg.lr_schedule == "cosine":
        sched = optax.cosine_decay_schedule(cfg.lr, cfg.lr_decay_steps,
                                            alpha=cfg.lr_end_frac)
    else:
        sched = optax.linear_schedule(cfg.lr, cfg.lr * cfg.lr_end_frac,
                                      cfg.lr_decay_steps)
    ours = steps.lr_schedule(cfg)
    for count in range(21):
        np.testing.assert_allclose(ours(count), float(sched(count)),
                                   rtol=1e-6)


def test_scheduler_sets_each_update_lr():
    """The first update uses lr * f(0), the k-th lr * f(k - 1)."""
    cfg = steps.TrainConfig(**SMALL, lr_schedule="cosine", lr_decay_steps=4)
    models = steps.init_models(SegmentSpec.from_output_info(COND_INFO), cfg,
                               device="cpu")
    f = steps.lr_schedule(cfg)
    for k in range(6):
        assert models.opt_g.param_groups[0]["lr"] == pytest.approx(f(k),
                                                                   rel=1e-12)
        models.opt_g.step()
        models.sched_g.step()


def test_bad_configs_raise():
    spec = SegmentSpec.from_output_info(COND_INFO)
    with pytest.raises(ValueError):
        steps.lr_schedule(steps.TrainConfig(lr_schedule="cosine"))
    with pytest.raises(ValueError):
        steps.lr_schedule(steps.TrainConfig(lr_schedule="step",
                                            lr_decay_steps=3))
    with pytest.raises(ValueError):
        steps.init_models(spec, steps.TrainConfig(**SMALL, d_steps=0), device="cpu")
    with pytest.raises(NotImplementedError):
        steps.init_models(spec, steps.TrainConfig(**SMALL, ema_decay=0.9), device="cpu")
    with pytest.raises(NotImplementedError):
        steps.init_models(spec, steps.TrainConfig(**SMALL, precision="bf16"), device="cpu")


def test_epoch_with_own_draws_is_finite_and_seeded():
    """The normal path: draws from a torch generator, an epoch returns the
    last step's finite metrics, and the same seed gives the same weights."""
    spec = SegmentSpec.from_output_info(COND_INFO)
    cfg = steps.TrainConfig(**SMALL)
    data = encoded_table(COND_INFO, 80, 3)
    cond = CondSampler.from_data(data, spec, "cpu")
    rows = RowSampler.from_data(data, spec, "cpu")

    def run():
        models = steps.init_models(spec, cfg, seed=4, device="cpu")
        gen = torch.Generator().manual_seed(9)
        met = steps.epoch(models, torch.from_numpy(data), cond, rows, gen, 3)
        return models, met

    (m1, met1), (m2, _) = run(), run()
    assert all(np.isfinite(float(v)) for v in met1.values())
    for a, b in zip(m1.generator.state_dict().values(),
                    m2.generator.state_dict().values()):
        assert torch.equal(a, b)
