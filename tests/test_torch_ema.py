"""The generator EMA of the port's federated trainer (``cfg.ema_decay``),
mirroring ``tests/test_federated.py:226-300`` and
``tests/test_checkpoint.py:169``: the EMA equals the host recurrence over
the trainer's own aggregates, training is untouched by it, every sampling
surface reads the debiased EMA, a resume and a watchdog rollback restore
it bit for bit, the saved artifact bakes it, and a JAX EMA checkpoint
converts.  Against JAX on the same draws (the three ragged clients of
``test_torch_federated.py``) the debiased EMA agrees within the round
tolerance (at least 99% of the entries within atol 1e-5 + rtol 1e-3).
"""

import jax
import numpy as np
import pytest
import torch

from fed_tgan_torch.interop import (
    convert_jax_checkpoint,
    federated_init_from_jax,
    generator_from_jax,
)
from fed_tgan_torch.runtime.checkpoint import (
    load_federated,
    save_federated,
    save_synthesizer,
)
from fed_tgan_torch.serve.demo import write_artifact
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import open_model
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.federated import FederatedTrainer
from fed_tgan_torch.train.watchdog import (
    TrainingWatchdog,
    WatchdogAlarm,
    fit_with_watchdog,
)
from fed_tgan_tpu.parallel.mesh import client_mesh
from fed_tgan_tpu.runtime.checkpoint import save_federated as jax_save
from fed_tgan_tpu.train import steps as jsteps
from fed_tgan_tpu.train.federated import FederatedTrainer as JaxTrainer
from test_torch_federated import SMALL, jinit, make_pair  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def init(jinit):  # noqa: F811
    return federated_init_from_jax(jinit)


def _cfg(**kw):
    return steps.TrainConfig(**SMALL, **kw)


def _flat_global(state: dict) -> np.ndarray:
    """A generator ``state_dict``'s floats in key order."""
    return np.concatenate([np.ravel(state[k].detach().cpu().numpy())
                           for k in sorted(state)
                           if not k.endswith("num_batches_tracked")])


def test_ema_matches_host_recurrence(init):
    """d = 0.5, 3 rounds: the debiased EMA equals ``d * e + (1 - d) * n``
    over a plain trainer's aggregates (same seed), divided by ``1 -
    d^3``; the EMA trainer's training equals the plain one's bit for
    bit."""
    d = 0.5
    tr = FederatedTrainer(init, _cfg(ema_decay=d), seed=0, device="cpu")
    ref = FederatedTrainer(init, _cfg(), seed=0, device="cpu")
    expect = None
    for _ in range(3):
        ref.fit(1)
        step = _flat_global(ref._global_model())
        expect = (np.zeros_like(step) if expect is None else expect)
        expect = d * expect + (1 - d) * step
    expect = expect / (1 - d ** 3)
    tr.fit(3)
    assert tr._ema_updates == 3
    np.testing.assert_allclose(_flat_global(tr._global_model()), expect,
                               rtol=2e-5, atol=2e-6)
    assert torch.equal(tr.stack.generator.params, ref.stack.generator.params)
    assert torch.equal(tr.stack.discriminator.params,
                       ref.stack.discriminator.params)


def test_ema_round_matches_jax(jinit):  # noqa: F811
    """Two rounds of the ragged clients with d = 0.5 on JAX's draws: the
    port's debiased EMA against ``FederatedTrainer._global_model()`` of
    the JAX package, within the round tolerance."""
    jtr, tr, _ = make_pair(jinit, ema_decay=0.5)
    jtr.fit(2)
    tr.fit(2)
    params_g, state_g = jtr._global_model()
    want = _flat_global(generator_from_jax(
        jax.tree.map(np.asarray, params_g),
        jax.tree.map(np.asarray, state_g)).state_dict())
    got = _flat_global(tr._global_model())
    assert np.isclose(got, want, atol=1e-5, rtol=1e-3).mean() >= 0.99
    assert tr._ema_updates == jtr._ema_updates == 2


def test_sampling_uses_ema_when_enabled(init):
    tr = FederatedTrainer(init, _cfg(ema_decay=0.9), seed=0, device="cpu")
    before = _flat_global(tr._global_model())  # no round folded in yet
    np.testing.assert_array_equal(before, _flat_global(
        tr._global_model(use_ema=False)))
    tr.fit(2)
    ema = _flat_global(tr._global_model())
    raw = _flat_global(tr._global_model(use_ema=False))
    assert not np.allclose(ema, raw)
    assert tr.sample(80, seed=1).shape == (80, 4)
    enc = tr.sample_encoded(80, seed=2)
    assert not np.allclose(enc, tr.sample_encoded(80, seed=2,
                                                  use_ema=False))
    plain = FederatedTrainer(init, _cfg(), seed=0, device="cpu").fit(1)
    with pytest.raises(ValueError, match="ema_decay=0"):
        plain._global_model(use_ema=True)


def test_ema_checkpoint_resume_bit_exact(init, tmp_path):
    tr = FederatedTrainer(init, _cfg(ema_decay=0.7), seed=0, device="cpu")
    tr.fit(2)
    save_federated(tr, str(tmp_path / "ck"))
    tr.fit(2)
    resumed = load_federated(str(tmp_path / "ck"), device="cpu")
    assert resumed._ema_updates == 2
    resumed.fit(2)
    assert resumed._ema_updates == tr._ema_updates == 4
    for a, b in zip(tr.ema, resumed.ema):
        assert torch.equal(a, b)
    assert torch.equal(tr.stack.generator.params,
                       resumed.stack.generator.params)


class _AlarmOnce(TrainingWatchdog):
    def __init__(self, at: int):
        super().__init__()
        self.at, self.fired = at, False

    def health_cb(self, first, metrics):
        if not self.fired and first == self.at:
            self.fired = True
            raise WatchdogAlarm("scripted")


def test_rollback_restores_the_ema(init, tmp_path):
    """A checkpoint every round; the watchdog alarms on round 2 (0-based)
    and rolls back to the checkpoint after round 1, which brings back its
    EMA and count with the models: the run ends equal to one that never
    alarmed and re-annealed its learning rate after round 1."""
    ckpt = str(tmp_path / "ck")
    cfg = _cfg(ema_decay=0.8)

    def save(e, trainer):
        save_federated(trainer, ckpt)

    tr = FederatedTrainer(init, cfg, seed=1, device="cpu")
    tr.fit(1, sample_hook=save)
    wd = _AlarmOnce(at=2)
    out = fit_with_watchdog(tr, 3, wd, ckpt, fit_kwargs={
        "sample_hook": save})
    assert wd.rollbacks == 1 and out._ema_updates == 4
    straight = FederatedTrainer(init, cfg, seed=1, device="cpu")
    straight.fit(2)
    straight.set_lr(cfg.lr * 0.5)  # the rollback's re-anneal
    straight.fit(2)
    for a, b in zip(out.ema, straight.ema):
        assert torch.equal(a, b)


def test_synthesizer_artifact_bakes_debiased_ema(init, tmp_path):
    """The saved artifact's generator is ``_global_model()``: loaded and
    served, it gives the trainer's (EMA) rows, not the raw aggregate's."""
    tr = FederatedTrainer(init, _cfg(ema_decay=0.9), seed=0, device="cpu")
    tr.fit(2)
    saved = tr.to_saved()
    for k, v in tr._global_model().items():
        assert torch.equal(saved.generator.state_dict()[k], v), k
    write_artifact(str(tmp_path / "art"), saved, init.global_meta,
                   init.encoders)
    engine = SamplingEngine(open_model(str(tmp_path / "art"), device="cpu",
                                       log=lambda *a: None))
    got = engine.sample_encoded(80, seed=2)
    np.testing.assert_array_equal(got, tr.sample_encoded(80, seed=2))
    assert not np.allclose(got, tr.sample_encoded(80, seed=2,
                                                  use_ema=False), atol=1e-5)
    save_synthesizer(saved, str(tmp_path / "again"))


def test_jax_ema_checkpoint_converts(jinit, tmp_path):  # noqa: F811
    """A JAX checkpoint of an EMA run (d = 0.7, 2 rounds) converted and
    loaded: the debiased EMA equals JAX's ``_global_model()``, the update
    count carries over, and the run goes on."""
    jcfg = jsteps.TrainConfig(**SMALL, ema_decay=0.7)
    jtr = JaxTrainer(jinit, config=jcfg, mesh=client_mesh(3), seed=0)
    jtr.fit(2)
    jax_save(jtr, str(tmp_path / "jax"), run_name="toy")
    convert_jax_checkpoint(str(tmp_path / "jax"), str(tmp_path / "port"))
    tr = load_federated(str(tmp_path / "port"), device="cpu")
    assert tr._ema_updates == 2 and tr.cfg.ema_decay == 0.7
    params_g, state_g = jtr._global_model()
    want = _flat_global(generator_from_jax(
        jax.tree.map(np.asarray, params_g),
        jax.tree.map(np.asarray, state_g)).state_dict())
    np.testing.assert_allclose(_flat_global(tr._global_model()), want,
                               rtol=1e-6, atol=1e-7)
    tr.fit(1)
    assert tr._ema_updates == 3
