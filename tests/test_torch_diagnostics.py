"""The port's gradient-flow summary (``fed_tgan_torch/ops/diagnostics.py``)
against ``fed_tgan_tpu.ops.diagnostics.gradient_flow``.

Both start from the same weights (a JAX ``ModelBundle`` carried across by
``interop.bundle_from_jax``) and the same draws: JAX's ``split(key, 13)``
regenerated as the port's ``StepDraws`` (``test_torch_steps.
jax_step_draws``).  Each layer's ``avg_abs`` and ``max_abs`` agree within
atol 1e-6 + rtol 1e-3, the train step's gradient tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from fed_tgan_tpu.ops import diagnostics as jdiag
from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
from fed_tgan_tpu.train import steps as jsteps
from fed_tgan_tpu.train.sampler import CondSampler as JaxCond
from fed_tgan_tpu.train.sampler import RowSampler as JaxRows
from fed_tgan_torch.interop import bundle_from_jax
from fed_tgan_torch.ops import diagnostics
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.sampler import CondSampler, RowSampler
from test_torch_steps import encoded_table, jax_step_draws

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-3
CFG = dict(embedding_dim=8, gen_dims=(16, 16), dis_dims=(16, 16),
           batch_size=16, pac=4)
INFO = [(1, "tanh"), (3, "softmax"), (4, "softmax")]


def jax_names(kind: str, cfg) -> dict:
    """The port's parameter name -> JAX's tree-path name of the same
    leaf (``summarize_grads`` joins dict keys as ``"['key']"``)."""
    k = lambda *parts: "/".join(
        f"['{p}']" if isinstance(p, str) else str(p) for p in parts)
    out = {}
    if kind == "generator":
        for i in range(len(cfg.gen_dims)):
            out[f"blocks.{i}.fc.weight"] = k("blocks", i, "fc", "w")
            out[f"blocks.{i}.fc.bias"] = k("blocks", i, "fc", "b")
            out[f"blocks.{i}.bn.weight"] = k("blocks", i, "bn_scale")
            out[f"blocks.{i}.bn.bias"] = k("blocks", i, "bn_bias")
    else:
        for i in range(len(cfg.dis_dims)):
            out[f"layers.{i}.weight"] = k("layers", i, "w")
            out[f"layers.{i}.bias"] = k("layers", i, "b")
    out["out.weight"], out["out.bias"] = k("out", "w"), k("out", "b")
    return out


@pytest.fixture(scope="module")
def both():
    jcfg, cfg = jsteps.TrainConfig(**CFG), steps.TrainConfig(**CFG)
    jspec, spec = JaxSpec.from_output_info(INFO), SegmentSpec.from_output_info(
        INFO)
    data = encoded_table(INFO, 64, 0)
    jmodels = jsteps.init_models(jax.random.key(0), jspec, jcfg)
    key = jax.random.key(1)
    want = jdiag.gradient_flow(jmodels, data, JaxCond.from_data(data, jspec),
                               JaxRows.from_data(data, jspec), jspec, jcfg,
                               key)
    models = bundle_from_jax(jmodels, spec, cfg, "cpu")
    draws = jax_step_draws(key, jspec, jcfg, len(data))
    return (models, torch.from_numpy(data),
            CondSampler.from_data(data, spec, "cpu"),
            RowSampler.from_data(data, spec, "cpu"), draws, cfg, want)


def test_gradient_flow_matches_jax(both):
    models, data, cond, rows, draws, cfg, want = both
    got = diagnostics.gradient_flow(models, data, cond, rows, draws)
    assert set(got) == set(want) == {"discriminator", "generator"}
    for net in got:
        names = jax_names(net, cfg)
        assert sorted(names.values()) == sorted(want[net])
        assert set(got[net]) == set(names)
        for name, stats in got[net].items():
            ref = want[net][names[name]]
            for stat in ("avg_abs", "max_abs"):
                np.testing.assert_allclose(stats[stat], ref[stat],
                                           atol=ATOL, rtol=RTOL,
                                           err_msg=f"{net} {name} {stat}")


def test_gradient_flow_changes_no_state(both):
    """No ``.grad`` written, BatchNorm statistics and weights as before,
    and the same statistics twice."""
    models, data, cond, rows, draws, _, _ = both
    before = {k: v.clone() for k, v in models.generator.state_dict().items()}
    first = diagnostics.gradient_flow(models, data, cond, rows, draws)
    second = diagnostics.gradient_flow(models, data, cond, rows, draws)
    assert first == second
    for k, v in models.generator.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in models.generator.parameters())
    assert all(p.grad is None for p in models.discriminator.parameters())


def test_gradient_flow_structure_finiteness_and_plot(both, tmp_path):
    """JAX's structural test on the port: finite, max >= avg >= 0, a
    nonzero critic gradient; draws from a generator when none are
    given; the plot renders when matplotlib is present."""
    models, data, cond, rows, _, _, _ = both
    stats = diagnostics.gradient_flow(
        models, data, cond, rows, gen=torch.Generator().manual_seed(3))
    for net in stats.values():
        assert net
        for layer in net.values():
            assert np.isfinite(layer["avg_abs"])
            assert layer["max_abs"] >= layer["avg_abs"] >= 0.0
    assert any(l["max_abs"] > 0 for l in stats["discriminator"].values())
    pytest.importorskip("matplotlib")
    out = tmp_path / "gradflow.png"
    diagnostics.plot_gradient_flow(stats, str(out))
    assert out.exists() and out.stat().st_size > 0


def test_summarize_grads_per_layer():
    g = [("a", torch.tensor([[1.0, -3.0], [0.0, 2.0]])),
         ("b", torch.tensor([-0.5]))]
    assert diagnostics.summarize_grads(g) == {
        "a": {"avg_abs": 1.5, "max_abs": 3.0},
        "b": {"avg_abs": 0.5, "max_abs": 0.5}}
