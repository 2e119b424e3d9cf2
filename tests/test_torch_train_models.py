"""The port's training-side model pieces against the JAX package's: the
generator in train mode (batch statistics and the running-statistics
update), the discriminator with the JAX package's dropout masks, and the
segment op ``cond_loss``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fed_tgan_tpu.models.ctgan import (
    discriminator_apply,
    generator_apply,
    init_discriminator,
    init_generator,
)
from fed_tgan_tpu.ops import segments as jseg
from fed_tgan_torch.interop import discriminator_from_jax, generator_from_jax
from fed_tgan_torch.models.ctgan import Discriminator
from fed_tgan_torch.ops import segments

torch.set_num_threads(1)

ATOL = 1e-5  # float32 GEMMs and batch statistics in two frameworks
PAC = 10
INFO = [(1, "tanh"), (3, "softmax"), (4, "softmax"), (1, "tanh"),
        (2, "softmax")]


@pytest.mark.parametrize("hidden,rows", [((32, 32), 40), ((16,), 7)])
def test_generator_train_forward_and_running_stats_match_jax(hidden, rows):
    input_dim, data_dim = 20, 13
    params, state = init_generator(jax.random.key(3), input_dim, hidden,
                                   data_dim)
    z = np.random.default_rng(rows).standard_normal(
        (rows, input_dim)).astype(np.float32)
    want, new_state = generator_apply(params, state, jnp.asarray(z),
                                      train=True)
    gen = generator_from_jax(params, state).train()
    got = gen(torch.from_numpy(z))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    for block, st in zip(gen.blocks, new_state["blocks"]):
        np.testing.assert_allclose(block.bn.running_mean.numpy(),
                                   np.asarray(st["mean"]), atol=1e-6)
        np.testing.assert_allclose(block.bn.running_var.numpy(),
                                   np.asarray(st["var"]), atol=1e-6,
                                   rtol=1e-5)


def _masks(key, dis_dims, rows):
    out = []
    for h in dis_dims:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.bernoulli(sub, 0.5, (rows // PAC, h)))))
    return out


@pytest.mark.parametrize("dropout", [True, False])
def test_discriminator_matches_jax(dropout):
    dim, dis_dims, rows = 11, (32, 32), 50
    params = init_discriminator(jax.random.key(4), dim, dis_dims, PAC)
    x = np.random.default_rng(5).standard_normal((rows, dim)).astype(np.float32)
    key = jax.random.key(9)
    want = discriminator_apply(params, jnp.asarray(x), key, PAC,
                               train=dropout)
    dis = discriminator_from_jax(params, PAC)
    keep = _masks(key, dis_dims, rows) if dropout else None
    got = dis(torch.from_numpy(x), keep=keep)
    assert got.shape == (rows // PAC, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def test_discriminator_layout_and_drawn_masks():
    dis = Discriminator(7, (16, 8), pac=5)
    assert [l.in_features for l in dis.layers] == [35, 16]
    assert dis.keep_shapes(20) == [(4, 16), (4, 8)]
    g = torch.Generator().manual_seed(0)
    keep = dis.draw_keep(2000, g)
    assert [k.dtype for k in keep] == [torch.bool, torch.bool]
    assert abs(keep[0].float().mean().item() - 0.5) < 0.05
    x = torch.randn((20, 7))
    a = dis(x, keep=dis.draw_keep(20, torch.Generator().manual_seed(1)))
    b = dis(x, keep=dis.draw_keep(20, torch.Generator().manual_seed(1)))
    assert torch.equal(a, b)  # the masks are a function of the generator
    assert not torch.equal(a, dis(x))  # and dropout is on with them
    with pytest.raises(ValueError):
        dis(torch.randn((21, 7)))


def _cond_inputs(spec, rows, seed):
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((rows, spec.dim)) * 3).astype(np.float32)
    col = rng.integers(0, spec.n_discrete, rows)
    cond = np.zeros((rows, spec.n_opt), np.float32)
    mask = np.zeros((rows, spec.n_discrete), np.float32)
    for i, c in enumerate(col):
        cond[i, spec.cond_offsets[c] + rng.integers(0, spec.cond_sizes[c])] = 1
        mask[i, c] = 1
    return data, cond, mask


@pytest.mark.parametrize("rows", [8, 40])
def test_cond_loss_value_and_grad_match_jax(rows):
    jspec = jseg.SegmentSpec.from_output_info(INFO)
    spec = segments.SegmentSpec.from_output_info(INFO)
    data, cond, mask = _cond_inputs(spec, rows, rows)
    want, want_grad = jax.value_and_grad(
        lambda d: jseg.cond_loss(d, jspec, jnp.asarray(cond),
                                 jnp.asarray(mask)))(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_(True)
    got = segments.cond_loss(x, spec, torch.from_numpy(cond),
                             torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               atol=1e-6)
