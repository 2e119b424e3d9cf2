"""The port's slerp and gradient penalty against
``fed_tgan_tpu/models/losses.py``, with the discriminator's weights
converted by ``interop.discriminator_from_jax`` and the JAX package's
alpha and dropout masks regenerated from its keys and injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fed_tgan_tpu.models import losses as jlosses
from fed_tgan_tpu.models.ctgan import discriminator_apply, init_discriminator
from fed_tgan_torch.interop import discriminator_from_jax
from fed_tgan_torch.models import losses

torch.set_num_threads(1)

PAC = 10
ATOL = 1e-5  # float32 GEMMs and norms in two frameworks


def jax_masks(key, dis_dims, rows):
    """The keep masks ``discriminator_apply`` draws from ``key``."""
    out = []
    for h in dis_dims:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.bernoulli(sub, 0.5, (rows // PAC, h)))))
    return out


def d_params(dis):
    """The discriminator's parameters in JAX's sorted-leaf order (b, w per
    layer)."""
    out = []
    for lin in [*dis.layers, dis.out]:
        out += [lin.bias, lin.weight]
    return out


def test_slerp_matches_jax():
    rng = np.random.default_rng(0)
    low = rng.standard_normal((50, 7)).astype(np.float32)
    high = rng.standard_normal((50, 7)).astype(np.float32)
    val = rng.random((50, 1)).astype(np.float32)
    want = jlosses.slerp(jnp.asarray(val), jnp.asarray(low), jnp.asarray(high))
    got = losses.slerp(torch.from_numpy(val), torch.from_numpy(low),
                       torch.from_numpy(high))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_slerp_parallel_rows_fall_back_to_linear():
    low = np.tile(np.asarray([[1.0, 2.0, -1.0]], np.float32), (4, 1))
    high = low * np.asarray([[1.0], [2.0], [0.5], [3.0]], np.float32)
    val = np.asarray([[0.0], [0.3], [0.7], [1.0]], np.float32)
    got = losses.slerp(torch.from_numpy(val), torch.from_numpy(low),
                       torch.from_numpy(high)).numpy()
    want = np.asarray(jlosses.slerp(jnp.asarray(val), jnp.asarray(low),
                                    jnp.asarray(high)))
    np.testing.assert_allclose(got, (1 - val) * low + val * high, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("dis_dims,rows", [((32, 32), 40), ((16,), 20)])
def test_gradient_penalty_value_and_grads_match_jax(dis_dims, rows):
    dim = 9
    params = init_discriminator(jax.random.key(1), dim, dis_dims, PAC)
    rng = np.random.default_rng(rows)
    real = rng.standard_normal((rows, dim)).astype(np.float32)
    fake = rng.random((rows, dim)).astype(np.float32)
    mkey, akey = jax.random.split(jax.random.key(7))

    def jax_pen(p):
        return jlosses.gradient_penalty(
            lambda x: discriminator_apply(p, x, mkey, PAC), jnp.asarray(real),
            jnp.asarray(fake), akey, pac=PAC)

    want, want_grads = jax.value_and_grad(jax_pen)(params)
    dis = discriminator_from_jax(params, PAC)
    keep = jax_masks(mkey, dis_dims, rows)
    alpha = torch.from_numpy(np.array(jax.random.uniform(akey, (rows, 1))))
    pen = losses.gradient_penalty(lambda x: dis(x, keep=keep),
                                  torch.from_numpy(real),
                                  torch.from_numpy(fake), alpha, pac=PAC)
    np.testing.assert_allclose(pen.item(), float(want), rtol=1e-5)
    # the output bias does not enter dD/dx: no gradient (JAX's is zeros)
    params = d_params(dis)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params, torch.autograd.grad(pen, params, allow_unused=True))]
    for g, w in zip(grads, jax.tree.leaves(want_grads)):
        # torch keeps a Linear weight as (fan_out, fan_in): JAX's transpose
        g = g.T if g.dim() == 2 else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=1e-4)


def test_gradient_penalty_does_not_touch_its_inputs():
    """``real`` and ``fake`` are detached: only what ``d_fn`` closes over
    receives a gradient."""
    dis = discriminator_from_jax(
        init_discriminator(jax.random.key(2), 3, (8,), PAC), PAC)
    real = torch.randn((20, 3), requires_grad=True)
    fake = torch.randn((20, 3), requires_grad=True)
    pen = losses.gradient_penalty(dis, real, fake, torch.rand((20, 1)), PAC)
    pen.backward()
    assert real.grad is None and fake.grad is None
    assert dis.layers[0].weight.grad is not None
