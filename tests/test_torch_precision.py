"""The port's mixed-precision (bf16) path against ``fed_tgan_tpu``'s.

Each test makes its inputs from a seed with numpy and hands the same
values to both packages; JAX's Pallas kernel runs in interpret mode, as
the JAX package's own tests run it on the CPU.  The tolerances are bf16's:
it keeps 8 significant bits (one unit in the last place, "ulp", is 2^-8
of a value's binade, ~0.4%), and the two sides round at different places
(JAX rounds a linear layer's product and then its bias sum to bf16,
PyTorch's CPU GEMM adds the bias in float32 and rounds once; the float32
sums underneath run in other orders), so a bf16 result may differ by an
ulp or two where both are right.  Where the comparison is exact, it says
so.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fed_tgan_tpu.models import ctgan as jctgan
from fed_tgan_tpu.models.losses import gradient_penalty as jax_penalty
from fed_tgan_tpu.ops.activate_pallas import fused_apply_activate as pallas_activate
from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
from fed_tgan_tpu.parallel import fedavg as jfedavg
from fed_tgan_tpu.parallel.mesh import client_mesh, shard_map
from fed_tgan_tpu.runtime.precision import resolve_precision as jax_policy
from fed_tgan_tpu.train import steps as jsteps
from fed_tgan_torch import interop
from fed_tgan_torch.models.losses import gradient_penalty
from fed_tgan_torch.ops import activate_cuda
from fed_tgan_torch.ops.activate_cuda import (
    fused_activate_bwd,
    fused_apply_activate,
)
from fed_tgan_torch.ops.segments import (
    SegmentSpec,
    apply_activate,
    apply_activate_bwd,
    apply_activate_residual,
)
from fed_tgan_torch.parallel import fedavg
from fed_tgan_torch.runtime.precision import (
    PRECISIONS,
    f32_island,
    resolve_precision,
)
from fed_tgan_torch.train import steps
from test_torch_steps import (
    COND_INFO,
    SMALL,
    encoded_table,
    jax_step_draws,
    leaves,
)

torch.set_num_threads(1)
BF16 = torch.bfloat16
INFO = [(1, "tanh"), (3, "softmax"), (1, "tanh"), (5, "softmax"),
        (2, "softmax")]
F32_ATOL = 1e-5  # the float32 islands: exp/log in two frameworks


def bf16_ulp(v) -> np.ndarray:
    """One bf16 ulp at each value of ``v`` (a normal number's binade /
    2^7; 2^-133 at 0)."""
    a = np.abs(np.asarray(v, dtype=np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 2.0 ** -133)


def as_f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def assert_ulps(got, want, ulps, what=""):
    """``|got - want| <= ulps`` bf16 ulps of ``want``, elementwise."""
    got, want = as_f32(got), as_f32(want)
    excess = np.abs(got - want) / bf16_ulp(want)
    assert excess.max() <= ulps, (what, excess.max())


def bf16_round(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (both packages take these exact values)."""
    return torch.from_numpy(a).to(BF16).float().numpy()


# ----------------------------------------------------------------- policy


def test_policy():
    assert PRECISIONS == ("f32", "bf16")
    f32, bf16 = resolve_precision("f32"), resolve_precision("bf16")
    x = torch.randn(3, 4)
    n = torch.arange(5)
    assert f32.cast(x) is x  # the tensor itself, not a copy
    assert f32.compute_dtype == torch.float32 and f32.payload_dtype is None
    assert bf16.cast(x).dtype == BF16 and bf16.cast(n) is n
    assert bf16.cast(x.to(BF16)).dtype == BF16
    assert f32.param_dtype == bf16.param_dtype == torch.float32
    assert bf16.payload_dtype == BF16
    assert f32_island(x) is x and f32_island(x.to(BF16)).dtype == torch.float32
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        is False
    with pytest.raises(ValueError, match="precision"):
        resolve_precision("f16")
    # the JAX package's policy agrees on every name
    for name in PRECISIONS:
        j = jax_policy(name)
        assert str(j.compute_dtype.dtype if hasattr(j.compute_dtype, "dtype")
                   else j.compute_dtype).endswith(
            {"f32": "float32", "bf16": "bfloat16"}[name])


# -------------------------------------------------------- plain K1 and K2


@pytest.fixture(scope="module")
def specs():
    return JaxSpec.from_output_info(INFO), SegmentSpec.from_output_info(INFO)


@pytest.mark.parametrize("rows", [5, 300])
def test_plain_activation_in_bf16_matches_jax(specs, rows, monkeypatch):
    """Plain K1 and K2 on a bf16 ``x`` against JAX's bf16
    ``fused_apply_activate`` (Pallas, interpret mode) and its VJP, on the
    same uniforms.  Both compute in float32 and round once: within one
    bf16 ulp (the float32 values may straddle a rounding boundary).  The
    float32 residual agrees with the float32 kernel's output to 1e-5."""
    jspec, spec = specs
    rng = np.random.default_rng(rows)
    x = bf16_round((rng.standard_normal((rows, spec.dim)) * 2.0)
                   .astype(np.float32))
    dy = bf16_round(rng.standard_normal((rows, spec.dim)).astype(np.float32))
    key = jax.random.key(rows)
    u = np.array(jax.random.uniform(key, x.shape))
    out_j, vjp_j = jax.vjp(
        lambda a: pallas_activate(a, jspec, key, interpret=True),
        jnp.asarray(x, dtype=jnp.bfloat16))
    assert out_j.dtype == jnp.bfloat16
    xt, ut = torch.from_numpy(x).to(BF16), torch.from_numpy(u)
    out, res = apply_activate_residual(xt, spec, ut)
    assert out.dtype == BF16 and res.dtype == torch.float32
    assert_ulps(out, out_j, 1, "K1")
    assert torch.equal(apply_activate(xt, spec, ut), out)
    want32 = pallas_activate(jnp.asarray(x), jspec, key, interpret=True)
    np.testing.assert_allclose(res.numpy(), np.asarray(want32),
                               atol=F32_ATOL)
    dx_j = vjp_j(jnp.asarray(dy, dtype=jnp.bfloat16))[0]
    assert dx_j.dtype == jnp.bfloat16
    dx = apply_activate_bwd(torch.from_numpy(dy).to(BF16), res, spec)
    assert dx.dtype == BF16
    # K2's segment sums run in float32 in other orders: an ulp of the
    # result plus the float32 kernels' 1e-5 where dy - sum cancels
    excess = np.abs(as_f32(dx) - as_f32(dx_j)) - F32_ATOL
    assert (excess <= bf16_ulp(as_f32(dx_j))).all()
    # the wrappers route CPU tensors to these plain versions
    assert torch.equal(fused_apply_activate(xt, spec, ut), out)
    assert torch.equal(fused_activate_bwd(torch.from_numpy(dy).to(BF16), res,
                                          spec), dx)


def test_activate_function_in_bf16_keeps_a_float32_residual(specs):
    """Through autograd a bf16 ``x`` gets a bf16 output and a bf16
    gradient, computed by K2 from the float32 result (as JAX's custom VJP
    reads its float32 output), not from the rounded one."""
    _, spec = specs
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((40, spec.dim)) * 2.0)
                         .astype(np.float32)).to(BF16).requires_grad_(True)
    u = torch.from_numpy(rng.random((40, spec.dim), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((40, spec.dim))
                         .astype(np.float32)).to(BF16)
    y = fused_apply_activate(x, spec, u)
    assert y.dtype == BF16 and "ActivateFunction" in type(y.grad_fn).__name__
    (w * y).sum().backward()
    _, res = apply_activate_residual(x.detach(), spec, u)
    assert x.grad.dtype == BF16
    assert torch.equal(x.grad, apply_activate_bwd(w, res, spec))


def test_cuda_wrappers_refuse_other_dtype_pairs(specs, monkeypatch):
    """For a CUDA tensor the wrappers launch the variant of its dtypes or
    raise: (float32, float32) and (bf16, float32) only; nothing is cast
    to reach the float32 kernel.  (The check runs before any launch, so a
    tensor that claims to be on the card is enough to reach it here.)"""
    _, spec = specs

    class OnCard:
        is_cuda = True
        device = torch.device("cuda", 0)

        def __init__(self, dtype):
            self.dtype = dtype

        def get_device(self):
            return 0

    for a, b in ((torch.float16, torch.float32), (BF16, BF16),
                 (torch.float32, BF16), (torch.float64, torch.float64)):
        with pytest.raises(TypeError, match="no variant"):
            activate_cuda._check_rows("k", spec, OnCard(a), OnCard(b))
    assert activate_cuda.DTYPE_PAIRS == ((torch.float32, torch.float32),
                                         (BF16, torch.float32))


def test_launch_plan_per_dtype():
    """The bf16 variants stage one bf16 and one float32 operand: a tile's
    shared memory shrinks, so the plan takes more rows a tile at the
    serving chunk; the float32 plan is what it was."""
    f32 = activate_cuda.launch_plan(8000, 282, 64)
    assert (f32.rows_per_tile, f32.tiles, f32.smem_bytes) == (7, 1143, 20_272)
    b16 = activate_cuda.launch_plan(8000, 282, 64, itemsize=2)
    assert b16.staged and b16.rows_per_tile >= f32.rows_per_tile
    assert b16.smem_bytes == activate_cuda.smem_bytes(
        b16.rows_per_tile, 282, 64, itemsize=2)
    # one row's first operand: 282 + 3 floats rounded to 4 (1,152 bytes),
    # or 282 + 7 bf16 rounded to 8 (592 bytes)
    assert (activate_cuda.smem_bytes(1, 282, 64, itemsize=2)
            == activate_cuda.smem_bytes(1, 282, 64) - 1152 + 592)
    widest = activate_cuda.SMEM_BLOCK // 8
    assert not activate_cuda.launch_plan(3, widest, 3, itemsize=2).staged


# --------------------------------------------------------------- forwards


def _models(seed=0, in_dim=24, data_dim=20):
    key = jax.random.key(seed)
    params_g, state_g = jctgan.init_generator(key, in_dim, (32, 32), data_dim)
    # running statistics away from their initial values
    state_g = jax.tree.map(lambda a: a + 0.3, state_g)
    params_d = jctgan.init_discriminator(key, data_dim, (32, 32), 10)
    return params_g, state_g, params_d


def _max_ulps_tol(want) -> float:
    """Two bf16 ulps at the largest magnitude: each layer's result is
    rounded at other places on the two sides (see the module docstring),
    and a residual block passes its rounded output on."""
    return 2 * float(bf16_ulp(np.abs(as_f32(want)).max()))


@pytest.mark.parametrize("train", [True, False], ids=["train_bn", "eval_bn"])
def test_generator_forward_in_bf16_matches_jax(train):
    params_g, state_g, _ = _models()
    z = np.random.default_rng(1).standard_normal((50, 24)).astype(np.float32)
    jp, pol = jax_policy("bf16"), resolve_precision("bf16")
    want, new_state = jctgan.generator_apply(
        jp.cast(params_g), state_g, jp.cast(jnp.asarray(z)), train=train)
    G = interop.generator_from_jax(params_g, state_g).train(train)
    got = G(pol.cast(torch.from_numpy(z)))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=0,
                               atol=_max_ulps_tol(want))
    # running statistics: a float32 island, float32 on both sides
    for block, st in zip(G.blocks, new_state["blocks"]):
        assert block.bn.running_mean.dtype == torch.float32
        np.testing.assert_allclose(block.bn.running_mean.numpy(),
                                   np.asarray(st["mean"]), atol=2e-3)
        np.testing.assert_allclose(block.bn.running_var.numpy(),
                                   np.asarray(st["var"]), rtol=1e-2)
    assert int(G.blocks[0].bn.num_batches_tracked) == int(train)
    # f32: the float32 forward is unchanged by the policy
    f32 = interop.generator_from_jax(params_g, state_g).train(train)
    ref = interop.generator_from_jax(params_g, state_g).train(train)
    x = torch.from_numpy(z)
    out = f32(resolve_precision("f32").cast(x))
    assert out.dtype == torch.float32
    with torch.no_grad():
        h = x
        for block in ref.blocks:
            h = torch.cat([torch.relu(block.bn(block.fc(h))), h], dim=1)
        assert torch.equal(out, ref.out(h))


def test_discriminator_forward_in_bf16_matches_jax():
    _, _, params_d = _models()
    x = np.random.default_rng(2).standard_normal((50, 20)).astype(np.float32)
    jp, pol = jax_policy("bf16"), resolve_precision("bf16")
    want = jctgan.discriminator_apply(jp.cast(params_d),
                                      jp.cast(jnp.asarray(x)), None, 10,
                                      train=False)
    D = interop.discriminator_from_jax(params_d, 10)
    got = D(pol.cast(torch.from_numpy(x)))
    assert got.dtype == BF16
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=0,
                               atol=_max_ulps_tol(want))


def test_gradient_penalty_in_bf16_matches_jax():
    """The penalty under bf16: slerp and the norm in float32, the critic
    and its double backward in bf16.  Its value agrees to 2% (the
    gradient's bf16 entries differ by an ulp or two between the sides;
    the norm is of ~500 of them), and its parameter gradient's sign on
    the largest entries."""
    _, _, params_d = _models(3)
    rng = np.random.default_rng(4)
    real = bf16_round(rng.standard_normal((50, 20)).astype(np.float32))
    fake = bf16_round(rng.standard_normal((50, 20)).astype(np.float32))
    key = jax.random.key(7)
    alpha = np.array(jax.random.uniform(key, (50, 1)))
    jp = jax_policy("bf16")

    def jfn(pd):
        return jax_penalty(
            lambda v: jctgan.discriminator_apply(jp.cast(pd), v, None, 10,
                                                 train=False),
            jnp.asarray(real, jnp.bfloat16), jnp.asarray(fake, jnp.bfloat16),
            key, pac=10)

    want, jgrad = jax.value_and_grad(jfn)(params_d)
    D = interop.discriminator_from_jax(params_d, 10)
    pen = gradient_penalty(D, torch.from_numpy(real).to(BF16),
                           torch.from_numpy(fake).to(BF16),
                           torch.from_numpy(alpha), pac=10)
    assert pen.dtype == torch.float32
    np.testing.assert_allclose(pen.item(), float(want), rtol=2e-2)
    pen.backward()
    got = D.layers[0].weight.grad.numpy()
    assert D.layers[0].weight.grad.dtype == torch.float32
    ref = np.asarray(jgrad["layers"][0]["w"]).T
    big = np.abs(ref) > 0.1 * np.abs(ref).max()
    assert (np.sign(got[big]) == np.sign(ref[big])).all()


# ------------------------------------------------------------ train steps

# One Adam step moves a weight by about lr * sign(g): where the two sides'
# bf16 gradients take opposite signs (small gradients, whose bf16 rounding
# decides the sign) the updated weights differ by up to 2 * lr.  Elsewhere
# they agree to float32 rounding.
LR = 2e-4
SAME = 1e-6


def _jax_pair(seed, cfg_kw, data):
    jspec = JaxSpec.from_output_info(COND_INFO)
    spec = SegmentSpec.from_output_info(COND_INFO)
    jcfg = jsteps.TrainConfig(**cfg_kw)
    cfg = steps.TrainConfig(**cfg_kw)
    jmodels = jsteps.init_models(jax.random.key(seed), jspec, jcfg)
    models = interop.bundle_from_jax(jmodels, spec, cfg, "cpu")
    return jspec, spec, jcfg, cfg, jmodels, models


def _jax_step(jspec, jcfg, jmodels, data, key):
    from fed_tgan_tpu.train.sampler import CondSampler as JaxCond
    from fed_tgan_tpu.train.sampler import RowSampler as JaxRows

    step = jax.jit(jsteps.make_train_step(jspec, jcfg))
    return step(jmodels, jnp.asarray(data), JaxCond.from_data(data, jspec),
                JaxRows.from_data(data, jspec), key)


def _check_update(got: dict, jmodels, jmet, met, what):
    """Losses within 2%, every master weight within 2 * lr and at least
    98% of them equal to float32 rounding (99.4-99.6% at these seeds);
    master weights float32."""
    for name in ("loss_d", "pen", "loss_g"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   rtol=2e-2, atol=2e-3,
                                   err_msg=f"{what} {name}")
    same = total = 0
    for part in ("params_g", "params_d"):
        for a, b in zip(leaves(got[part]), leaves(getattr(jmodels, part))):
            assert a.dtype == np.float32
            d = np.abs(a - b)
            assert d.max() <= 2 * LR + SAME, (what, part, d.max())
            same += int((d <= SAME).sum())
            total += d.size
    assert same >= 0.98 * total, (what, same / total)
    for a, b in zip(leaves(got["state_g"]), leaves(jmodels.state_g)):
        np.testing.assert_allclose(a, b, atol=5e-3, rtol=2e-2)


def test_single_train_step_in_bf16_matches_jax():
    """One ``train_step`` in bf16 against ``make_train_step`` on the same
    weights and injected draws; the master weights and every Adam moment
    stay float32."""
    cfg_kw = dict(SMALL, precision="bf16")
    data = encoded_table(COND_INFO, 80, 0)
    jspec, spec, jcfg, cfg, jmodels, models = _jax_pair(0, cfg_kw, data)
    key = jax.random.fold_in(jax.random.key(100), 0)
    jmodels, jmet = _jax_step(jspec, jcfg, jmodels, data, key)
    from fed_tgan_torch.train.sampler import CondSampler, RowSampler
    met = steps.train_step(models, torch.from_numpy(data),
                           CondSampler.from_data(data, spec, "cpu"),
                           RowSampler.from_data(data, spec, "cpu"),
                           jax_step_draws(key, jspec, jcfg, len(data)))
    _check_update(interop.params_to_jax_layout(models), jmodels, jmet, met,
                  "single")
    for opt in (models.opt_g, models.opt_d):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype \
                == torch.float32
    for p in [*models.generator.parameters(),
              *models.discriminator.parameters()]:
        assert p.dtype == p.grad.dtype == torch.float32


def test_stacked_train_step_in_bf16_matches_jax():
    """``stacked_train_step`` over 2 clients in bf16 (one cast of each
    model's flat parameters, views of it) against one ``make_train_step``
    per client; the flat master parameters and the ``StackedAdam``
    moments stay float32."""
    from fed_tgan_torch.train.sampler import (
        CondSampler,
        RowSampler,
        StackedCondSampler,
        StackedRowSampler,
    )

    cfg_kw = dict(SMALL, precision="bf16")
    data = encoded_table(COND_INFO, 80, 1)
    pairs = [_jax_pair(seed, cfg_kw, data) for seed in (1, 2)]
    jspec, spec, jcfg, cfg = pairs[0][:4]
    stack = steps.stack_models([p[5] for p in pairs])
    keep = [s[1:] for s in stack.discriminator.keep_shapes(cfg.batch_size)]
    draws = steps.stacked_draws(spec, cfg, 2, keep, "cpu")
    keys = [jax.random.fold_in(jax.random.key(200), i) for i in range(2)]
    for i, key in enumerate(keys):
        src = jax_step_draws(key, jspec, jcfg, len(data)).tensors()
        for a, b in zip(steps.client_draws(draws, i).tensors(), src):
            a.copy_(b)
    conds = StackedCondSampler.stack([CondSampler.from_data(data, spec, "cpu")
                                      for _ in range(2)])
    rows = StackedRowSampler.stack([RowSampler.from_data(data, spec, "cpu")
                                    for _ in range(2)], len(data))
    met = steps.stacked_train_step(stack, torch.from_numpy(
        np.concatenate([data, data])), conds, rows, draws,
        torch.ones(2, dtype=torch.bool))
    assert stack.generator.params.dtype == torch.float32
    for opt in (stack.opt_g, stack.opt_d):
        assert opt.exp_avg.dtype == opt.exp_avg_sq.dtype == torch.float32
    for i, (pair, key) in enumerate(zip(pairs, keys)):
        jmodels, jmet = _jax_step(jspec, jcfg, pair[4], data, key)
        got = interop.params_to_jax_layout(stack.to_models(i))
        _check_update(got, jmodels, jmet,
                      dict(zip(("loss_d", "pen", "loss_g"), met[i])), f"c{i}")


def _toy_run(precision, n_steps=6):
    """``n_steps`` port steps from one seed (the JAX test's toy size)."""
    from fed_tgan_torch.train.sampler import CondSampler, RowSampler

    info = [(1, "tanh"), (3, "softmax"), (1, "tanh"), (4, "softmax")]
    spec = SegmentSpec.from_output_info(info)
    cfg = steps.TrainConfig(embedding_dim=8, gen_dims=(16, 16),
                            dis_dims=(16, 16), batch_size=8, pac=2,
                            precision=precision)
    data = encoded_table(info, 64, 0)
    models = steps.init_models(spec, cfg, seed=5, device="cpu")
    cond = CondSampler.from_data(data, spec, "cpu")
    rows = RowSampler.from_data(data, spec, "cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(n_steps):
        met = steps.train_step(models, torch.from_numpy(data), cond, rows,
                               steps.draw_step(gen, models))
        losses.append(float(met["loss_g"]))
    return models, losses


def test_bf16_vs_f32_seeded_trajectory_parity():
    """The port's own bf16 loss trajectory tracks its f32 one from the
    same seed and draws within 0.05 (``tests/test_precision.py:227-240``),
    and the bf16 run ends with float32 masters and moments; two bf16 runs
    end equal."""
    m32, l32 = _toy_run("f32")
    m16, l16 = _toy_run("bf16")
    assert np.isfinite(l32).all() and np.isfinite(l16).all()
    np.testing.assert_allclose(l16, l32, rtol=0, atol=0.05)
    for p in [*m16.generator.parameters(), *m16.discriminator.parameters()]:
        assert p.dtype == torch.float32
    for opt in (m16.opt_g, m16.opt_d):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == torch.float32
    again, l16b = _toy_run("bf16")
    assert l16b == l16
    assert all(torch.equal(a, b) for a, b in zip(
        again.generator.state_dict().values(),
        m16.generator.state_dict().values()))


class _Census(TorchDispatchMode):
    """Every aten op a region runs, with the dtypes of its tensor
    inputs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flat, _ = torch.utils._pytree.tree_flatten((args, kwargs or {}))
        dts = {a.dtype for a in flat if isinstance(a, torch.Tensor)
               and a.is_floating_point()}
        self.ops.append((func.overloadpacket.__name__, dts))
        return func(*args, **(kwargs or {}))


def _census(precision) -> list:
    from fed_tgan_torch.train.sampler import CondSampler, RowSampler

    spec = SegmentSpec.from_output_info(COND_INFO)
    cfg = steps.TrainConfig(**SMALL, precision=precision)
    data = encoded_table(COND_INFO, 80, 0)
    models = steps.init_models(spec, cfg, seed=0, device="cpu")
    cond = CondSampler.from_data(data, spec, "cpu")
    rows = RowSampler.from_data(data, spec, "cpu")
    draws = steps.draw_step(torch.Generator().manual_seed(1), models)
    with _Census() as census:
        steps.train_step(models, torch.from_numpy(data), cond, rows, draws)
    return census.ops


def test_bf16_step_computes_in_bf16_with_float32_islands():
    """The port's counterpart of ``test_bf16_step_ir_has_bf16_compute_and_
    f32_islands``: the f32 step runs no bf16 op; the bf16 step runs both
    dtypes, its linear layers in bf16, and batch norm, the penalty's norm,
    the loss means, ``cond_loss``'s and the activation's exp/log, and
    Adam in float32 only."""
    f32 = _census("f32")
    assert not any(BF16 in dts for _, dts in f32)
    ops = _census("bf16")
    seen = set().union(*(dts for _, dts in ops))
    assert {BF16, torch.float32} <= seen
    by = {}
    for name, dts in ops:
        by.setdefault(name, set()).update(dts)
    assert BF16 in by["addmm"] or BF16 in by["mm"]
    for name in ("native_batch_norm", "linalg_vector_norm", "mean", "log",
                 "exp", "logsumexp", "_foreach_add", "addcmul_", "lerp_"):
        if name in by:
            assert BF16 not in by[name], (name, by[name])
    assert {"native_batch_norm", "linalg_vector_norm", "mean", "log",
            "exp"} <= set(by)


def test_bf16_training_runs_with_jax_sklearn_and_pandas_blocked():
    """A fresh interpreter where jax, the JAX package, pandas, pyarrow and
    sklearn cannot be imported trains two bf16 steps and samples."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'fed_tgan_tpu', 'pandas', 'pyarrow',"
        " 'sklearn'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from fed_tgan_torch.serve.demo import intrusion_like_table\n"
        "from fed_tgan_torch.train.standalone import StandaloneSynthesizer\n"
        "from fed_tgan_torch.train.steps import TrainConfig\n"
        "m, cat, _, _ = intrusion_like_table(200, 0)\n"
        "cfg = TrainConfig(embedding_dim=16, gen_dims=(16, 16),\n"
        "                  dis_dims=(16, 16), batch_size=100,\n"
        "                  precision='bf16')\n"
        "s = StandaloneSynthesizer(cfg, device='cpu').fit(m, cat, epochs=1)\n"
        "x = s.sample_encoded(50)\n"
        "assert x.dtype == np.float32 and np.isfinite(x).all()\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ------------------------------------------------------------ aggregation


def _stacks(n=8, seed=0, scale=0.01):
    """A global previous state (two leaves) and n clients' new states at
    ``scale`` from it; weights summing to 1."""
    rng = np.random.default_rng(seed)
    prev = [rng.normal(size=(5, 3)).astype(np.float32),
            rng.normal(size=(7,)).astype(np.float32)]
    new = [(p[None] + scale * rng.normal(size=(n, *p.shape))).astype(
        np.float32) for p in prev]
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return prev, new, (w / w.sum()).astype(np.float32)


def _jax_on_one_device(fn, prev, new, w, n_out=1):
    """``fn`` under the JAX package's ``shard_map`` on a one-device mesh:
    every client is local, so its psum is the identity and the rounding
    happens exactly where the port's one-card aggregation rounds."""
    from jax.sharding import PartitionSpec as P

    n = len(w)
    jprev = tuple(jnp.asarray(np.broadcast_to(p, (n, *p.shape)))
                  for p in prev)
    out_specs = P() if n_out == 1 else (P(), P("clients"))
    return jax.jit(shard_map(
        fn, mesh=client_mesh(1), in_specs=(P("clients"),) * 3,
        out_specs=out_specs, check_vma=False))(
            jprev, tuple(jnp.asarray(x) for x in new), jnp.asarray(w))


def test_weighted_delta_average_matches_jax():
    """``weighted_delta_average`` against JAX's on the same stacks: with a
    float32 payload it is ``weighted_average`` to 1e-6; with a bf16 one
    within 1e-3 of it (the delta's scale, 0.01, times bf16's 2^-8, as
    ``tests/test_precision.py:152-190``) and within an ulp of the step of
    JAX's (the float32 sums run in other orders)."""
    prev, new, w = _stacks()
    tp = [torch.from_numpy(p) for p in prev]
    tn = [torch.from_numpy(x) for x in new]
    tw = torch.from_numpy(w)
    want = [t.numpy() for t in fedavg.weighted_average(tn, tw)]
    exact = fedavg.weighted_delta_average(tp, tn, tw, torch.float32)
    for a, b in zip(exact, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    quant = fedavg.weighted_delta_average(tp, tn, tw)
    jq = _jax_on_one_device(
        lambda p, n, wt: jfedavg.weighted_delta_average(
            p, n, wt, payload_dtype=jnp.bfloat16), prev, new, w)
    for a, b, jb, p in zip(quant, want, jq, prev):
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - b).max() < 1e-3
        step_ulp = bf16_ulp(np.asarray(jb) - p)
        assert (np.abs(a.numpy() - np.asarray(jb)) <= step_ulp + 1e-7).all()
    again = fedavg.weighted_delta_average(tp, tn, tw * 2, renormalize=True)
    for a, b in zip(again, quant):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)


@pytest.mark.parametrize("aggregator",
                         ["weighted", "clipped", "trimmed", "median"])
def test_robust_aggregate_with_a_bf16_payload_matches_jax(aggregator):
    """Every aggregator with the bf16 payload against JAX's on the same
    stacks, a client scaled x1e3 so that the gate (float32 norms) acts:
    the same quarantine mask, and the aggregate within an ulp of JAX's.
    Against the float32-payload aggregate: the weighted and clipped steps
    within 1e-3 (the delta's 0.01 times 2^-8); the trimmed mean and the
    median, which gather whole leaves (``fed_tgan_tpu/parallel/fedavg.py:
    274-296``), within one bf16 ulp of the clients' values."""
    prev, new, w = _stacks(seed=1)
    new = [x.copy() for x in new]
    for p, x in zip(prev, new):
        x[2] = p + 1e3 * (x[2] - p)
    steps_ = np.full(len(w), 3, dtype=np.int32)
    kw = dict(aggregator=aggregator, trim_ratio=0.25)
    tp = [torch.from_numpy(p) for p in prev]
    tn = [torch.from_numpy(x) for x in new]
    agg, quar = fedavg.robust_aggregate(
        tp, tn, torch.from_numpy(w), torch.from_numpy(steps_),
        payload_dtype=BF16, **kw)
    agg32, quar32 = fedavg.robust_aggregate(
        tp, tn, torch.from_numpy(w), torch.from_numpy(steps_), **kw)
    (jagg, jquar) = _jax_on_one_device(
        lambda p, n, wt: jfedavg.robust_aggregate(
            p, n, wt, jnp.asarray(steps_), len(w),
            payload_dtype=jnp.bfloat16, **kw), prev, new, w, n_out=2)
    assert quar.tolist() == quar32.tolist() == (np.asarray(jquar) > 0
                                                ).tolist()
    assert quar.tolist()[2] is True
    for a, b, jb, x in zip(agg, agg32, jagg, new):
        a, b, jb = a.numpy(), b.numpy(), np.asarray(jb)
        if aggregator in ("weighted", "clipped"):
            assert np.abs(a - b).max() < 1e-3
        else:
            assert (np.abs(a - b) <= bf16_ulp(np.abs(x).max(axis=0))).all()
        assert (np.abs(a - jb) <= bf16_ulp(jb) + 1e-7).all(), aggregator


# --------------------------------------------------------- federated round


@pytest.fixture(scope="module")
def fed_jinit():
    from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
    from fed_tgan_tpu.federation.init import federated_initialize
    from test_torch_federated import KW, client_frames

    return federated_initialize(
        [JaxPre(frame=f, name="toy", **KW) for f in client_frames()],
        seed=0, backend="jax")


def test_bf16_federated_round_matches_jax(fed_jinit):
    """One bf16 round of the port's stacked trainer (3, 2 and 1 local
    steps, the gated weighted aggregator with the bf16 payload) against
    the JAX trainer on a one-device mesh (every client local, so JAX
    rounds the weighted step once, where the port does), from the same
    weights and injected draws.  Every aggregated weight within the most
    that sign flips of bf16 gradients can move it (2 * lr per local step),
    at least 93% of them within 1e-5 and 99% within one lr step (the
    clients' later steps start from weights a flipped first step moved);
    the BatchNorm state within bf16's 2%; the same quarantine strikes.  Then weights that do not sum
    to 1 are refused."""
    from fed_tgan_tpu.train.federated import FederatedTrainer as JaxTrainer
    from fed_tgan_torch.train import federated as port_fed
    from test_torch_federated import SMALL as FED_SMALL

    jcfg = jsteps.TrainConfig(**FED_SMALL, precision="bf16")
    cfg = steps.TrainConfig(**FED_SMALL, precision="bf16")
    jtr = JaxTrainer(fed_jinit, config=jcfg, mesh=client_mesh(1), seed=0)
    jspec = JaxSpec.from_output_info(fed_jinit.output_info)
    spec = SegmentSpec.from_output_info(fed_jinit.output_info)
    models = interop.client_models_from_jax(jtr.models, spec, cfg, "cpu")
    chain = [jtr._key]
    rkeys: dict = {}

    def draws(e, i, s):
        while e not in rkeys:
            chain[0], rkeys[len(rkeys)] = jax.random.split(chain[0])
        key = jax.random.fold_in(jax.random.fold_in(rkeys[e], i), s)
        return jax_step_draws(key, jspec, jcfg, 0)

    init = interop.federated_init_from_jax(fed_jinit)
    tr = port_fed.FederatedTrainer(init, cfg, seed=0, device="cpu",
                                   models=models, draws=draws)
    jtr.fit(1)
    tr.fit(1)
    assert list(tr.steps) == [3, 2, 1]
    diffs = []
    for i in range(3):
        got = interop.params_to_jax_layout(tr.models[i])
        for part in ("params_g", "params_d"):
            for a, b in zip(leaves(got[part]),
                            [x[i] for x in leaves(getattr(jtr.models,
                                                          part))]):
                assert a.dtype == np.float32
                d = np.abs(a - b)
                assert d.max() <= 3 * 2 * LR + 1e-5, (i, part, d.max())
                diffs.append(d.ravel())
        for a, b in zip(leaves(got["state_g"]),
                        [x[i] for x in leaves(jtr.models.state_g)]):
            np.testing.assert_allclose(a, b, atol=2e-2, rtol=2e-2)
    diffs = np.concatenate(diffs)
    # at this seed 95.1% within 1e-5 and 99.8% within one lr step
    assert (diffs <= 1e-5).mean() >= 0.93 and (diffs <= LR).mean() >= 0.99
    np.testing.assert_array_equal(tr._strikes, jtr._strikes[:3])
    init.weights = np.asarray(init.weights) * 0.5
    with pytest.raises(ValueError, match="not 1"):
        port_fed.FederatedTrainer(init, cfg, seed=0, device="cpu")


# ---------------------------------------------------------------- serving


def test_decode_takes_the_first_maximum_of_the_rounded_values():
    """A bf16 sample's rows reach the decode as float32 casts of the bf16
    values, so two options that differ in float32 but round to one bf16
    value tie, and the decode takes the first of them, as JAX's
    ``jnp.argmax`` over its bf16-rounded rows (``ops/decode.py:141``)."""
    from fed_tgan_tpu.features.transformer import DiscreteColumn as JaxCol
    from fed_tgan_tpu.ops.decode import make_device_decode
    from fed_tgan_torch.features.transformer import DiscreteColumn
    from fed_tgan_torch.ops.decode import decode_tables, layout_decode

    cols = [DiscreteColumn("c", np.array([7, 8, 9]))]
    f32 = torch.tensor([[0.2, 0.5, 0.501], [0.501, 0.5, 0.2]])
    rows = f32_island(f32.to(BF16))
    assert rows[0, 1] == rows[0, 2] and rows[1, 0] == rows[1, 1]
    tables = tuple(tuple(torch.as_tensor(a) for a in t)
                   for t in decode_tables(cols))
    got = layout_decode(rows, tables)[:, 0].tolist()
    assert got == [8.0, 7.0]  # float32 would give 9 and 7
    assert layout_decode(f32, tables)[:, 0].tolist() == [9.0, 7.0]
    jdec = make_device_decode([JaxCol("c", np.array([7, 8, 9]))])
    want = np.asarray(jdec(jnp.asarray(rows.numpy(), jnp.bfloat16)))[:, 0]
    assert want.tolist() == got


def test_bf16_artifact_from_jax_converts_and_serves(tmp_path):
    """A JAX ``--precision bf16`` demo artifact converts (precision
    ``"bf16"``) and the port serves it in bf16: its encoded rows on JAX's
    injected draws within two bf16 ulps at the top of the encoded range
    (2^-6: the generator's layers round at other places on the two sides;
    the activation's float32 island and the float32 decode add nothing),
    every segment's argmax the same except near ties, and chunked rows
    byte-equal to one-shot rows.  The f32 conversion of the same artifact
    samples other rows."""
    from fed_tgan_tpu.serve.demo import build_demo_artifact as jax_demo
    from fed_tgan_tpu.serve.registry import load_model as jax_load_model
    from fed_tgan_tpu.serve.registry import resolve_artifact as jax_resolve
    from fed_tgan_torch.serve.engine import SamplingEngine
    from fed_tgan_torch.serve.registry import open_model
    from test_torch_serve import jax_draws, near_ties

    jdir = jax_demo(str(tmp_path / "jax"), precision="bf16")
    pdir = interop.convert_jax_artifact(jdir, str(tmp_path / "port"))
    cfg = json.load(open(os.path.join(pdir, "models", "synthesizer_torch",
                                      "config.json")))["cfg"]
    assert cfg["precision"] == "bf16"
    jmodel = jax_load_model(jax_resolve(jdir, log=lambda *a: None))
    pmodel = open_model(pdir, device="cpu")
    assert pmodel.synth.compute_dtype == BF16
    engine = SamplingEngine(pmodel)
    n, seed = 330, 5
    want = jmodel.synth.sample_encoded(n, seed=seed)
    got = engine.sample_encoded(n, seed=seed, draws=jax_draws(jmodel, seed))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6)
    start, far = 0, ~near_ties(want, pmodel.synth.spec)
    for size, kind in pmodel.synth.spec.output_info:
        if kind == "softmax":
            np.testing.assert_array_equal(
                got[far, start:start + size].argmax(1),
                want[far, start:start + size].argmax(1))
        start += size
    one = engine.sample_csv_bytes(170, seed=9)
    parts = [engine.sample_csv_bytes(60, seed=9),
             engine.sample_csv_bytes(110, seed=9, offset=60, header=False)]
    assert b"".join(parts) == one
    f32 = dataclasses.replace(pmodel.synth.cfg, precision="f32")
    pmodel.synth.cfg = f32
    pmodel.synth.compute_dtype = torch.float32
    assert SamplingEngine(pmodel).sample_encoded(n, seed=seed, draws=jax_draws(
        jmodel, seed)).tobytes() != got.tobytes()


def test_bf16_and_f32_tenants_never_share_a_lane_dispatch(tmp_path):
    """An f32 and a bf16 tenant of one layout (the same weights) have
    different layout keys; a backlog of both tenants' requests rides lane
    dispatches that each hold one precision, every tenant's bytes equal
    its single engine's, and a two-lane bf16 dispatch equals the single
    bf16 engine bit for bit."""
    from fed_tgan_torch.serve.demo import build_random_artifact
    from fed_tgan_torch.serve.engine import SamplingEngine
    from fed_tgan_torch.serve.fleet import (
        FleetRegistry,
        FleetService,
        ProgramCache,
        _FleetRequest,
        _Member,
    )

    small = dict(embedding_dim=16, gen_dims=(32, 32), dis_dims=(32, 32),
                 batch_size=50)
    reg = FleetRegistry(program_cache=ProgramCache(max_entries=16),
                        device="cpu", log=lambda *a, **k: None)
    for name, prec in (("a32", "f32"), ("b16", "bf16"), ("c16", "bf16")):
        reg.load(name, build_random_artifact(
            str(tmp_path / name), seed=0,
            cfg=steps.TrainConfig(**small, precision=prec)))
    keys = {n: SamplingEngine.layout_key(reg.get(n).engine.model)
            for n in ("a32", "b16", "c16")}
    assert keys["b16"] == keys["c16"] != keys["a32"]
    svc = FleetService(reg, port=0, max_batch=8, queue_size=64, max_lanes=4,
                       reload_interval_s=0, log=lambda *a, **k: None)
    groups = []
    real = svc.lane_encoded

    def recording(members, steps_, draws=None, tick=None):
        groups.append({m.snap.cfg.precision for m in members})
        return real(members, steps_, draws, tick)

    svc.lane_encoded = recording
    reqs = {(n, s): _FleetRequest(n, 40, s, 0, None, True)
            for n in ("a32", "b16", "c16") for s in (31, 32)}
    for (name, _), r in reqs.items():
        assert svc.submit(reg.get(name), r) is None
    svc.start_workers()
    for r in reqs.values():
        assert r.done.wait(timeout=60) and r.status == 200, r.error
    svc.shutdown(drain=True)
    assert groups and all(len(g) == 1 for g in groups)
    for (name, s), r in reqs.items():
        assert r.result == reg.get(name).engine.sample_csv_bytes(40, seed=s)
    assert reqs[("a32", 31)].result != reqs[("b16", 31)].result
    assert reqs[("b16", 31)].result == reqs[("c16", 31)].result
    members = []
    for name, seed in (("b16", 5), ("c16", 6)):
        rt = reg.get(name)
        members.append(_Member(_FleetRequest(name, 100, seed, 0, None, True),
                               rt, rt.engine.snapshot(), 0, 0))
    host = svc.lane_pass(members, 2)
    for i, m in enumerate(members):
        np.testing.assert_array_equal(
            host[i, :100], m.rt.engine.sample_decoded(100, seed=m.req.seed))


def test_bf16_checkpoint_carries_the_precision_and_resumes_bit_exact(
        fed_jinit, tmp_path):
    """A bf16 federation saved after one round carries ``precision`` in its
    checkpoint; loaded, its second round ends bit-equal to the
    uninterrupted run's (the same device type, one thread), and the loaded
    trainer keeps the checkpoint's precision."""
    from fed_tgan_torch.runtime.checkpoint import load_federated, save_federated
    from fed_tgan_torch.train import federated as port_fed
    from test_torch_federated import SMALL as FED_SMALL

    cfg = steps.TrainConfig(**FED_SMALL, precision="bf16")

    def fresh():
        return port_fed.FederatedTrainer(
            interop.federated_init_from_jax(fed_jinit), cfg, seed=3,
            device="cpu")

    straight = fresh().fit(2)
    first = fresh().fit(1)
    save_federated(first, str(tmp_path / "ck"))
    host = json.load(open(tmp_path / "ck" / "host.json"))
    assert host["cfg"]["precision"] == "bf16"
    resumed = load_federated(str(tmp_path / "ck"), device="cpu")
    assert resumed.cfg.precision == "bf16"
    resumed.fit(1)
    for a, b in ((straight.stack.generator.params,
                  resumed.stack.generator.params),
                 (straight.stack.discriminator.params,
                  resumed.stack.discriminator.params),
                 (straight.stack.generator.bn_state,
                  resumed.stack.generator.bn_state),
                 (straight.stack.opt_g.exp_avg, resumed.stack.opt_g.exp_avg)):
        assert torch.equal(a, b)


def test_jax_bf16_checkpoint_converts_with_its_precision(fed_jinit, tmp_path):
    """A JAX bf16 federated checkpoint (one round) converts to a port
    checkpoint with precision ``"bf16"``; the loaded trainer holds the
    JAX master weights exactly (they are float32 in both packages) and
    trains one more bf16 round to finite metrics."""
    from fed_tgan_tpu.runtime.checkpoint import save_federated as jsave
    from fed_tgan_tpu.train.federated import FederatedTrainer as JaxTrainer
    from fed_tgan_torch.runtime.checkpoint import load_federated
    from test_torch_federated import SMALL as FED_SMALL

    jtr = JaxTrainer(fed_jinit,
                     config=jsteps.TrainConfig(**FED_SMALL, precision="bf16"),
                     mesh=client_mesh(1), seed=0)
    jtr.fit(1)
    jsave(jtr, str(tmp_path / "jax"), run_name="toy")
    interop.convert_jax_checkpoint(str(tmp_path / "jax"),
                                   str(tmp_path / "port"))
    host = json.load(open(tmp_path / "port" / "host.json"))
    assert host["cfg"]["precision"] == "bf16"
    tr = load_federated(str(tmp_path / "port"), device="cpu")
    assert tr.cfg.precision == "bf16" and tr.completed_epochs == 1
    for i, m in enumerate(tr.models):
        got = interop.params_to_jax_layout(m)
        for part in ("params_g", "params_d"):
            for a, b in zip(leaves(got[part]),
                            [x[i] for x in leaves(getattr(jtr.models,
                                                          part))]):
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
    tr.fit(1)
    assert np.isfinite(tr.last_metrics).all()
