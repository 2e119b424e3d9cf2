"""The port's eval-mode generator against ``generator_apply(train=False)``
with the same weights (converted by ``interop.generator_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fed_tgan_tpu.models.ctgan import generator_apply, init_generator
from fed_tgan_torch.interop import generator_from_jax

torch.set_num_threads(1)

ATOL = 1e-5  # float32 GEMMs in two libraries, unit-scale activations


def _jax_generator(input_dim, hidden, data_dim, seed):
    params, state = init_generator(jax.random.key(seed), input_dim, hidden,
                                   data_dim)
    rng = np.random.default_rng(seed)
    # non-trivial BN running statistics and affine parameters, so the
    # eval-mode normalisation is really exercised
    for block, bstate in zip(params["blocks"], state["blocks"]):
        h = block["bn_scale"].shape[0]
        block["bn_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, h), jnp.float32)
        block["bn_bias"] = jnp.asarray(rng.normal(0, 0.1, h), jnp.float32)
        bstate["mean"] = jnp.asarray(rng.normal(0, 0.5, h), jnp.float32)
        bstate["var"] = jnp.asarray(rng.uniform(0.5, 2.0, h), jnp.float32)
    return params, state


@pytest.mark.parametrize("hidden", [(32, 32), (16,), ()])
def test_generator_eval_forward_matches_jax(hidden):
    input_dim, data_dim = 24, 17
    params, state = _jax_generator(input_dim, hidden, data_dim, seed=len(hidden))
    z = np.random.default_rng(1).standard_normal((64, input_dim)).astype(np.float32)
    want, _ = generator_apply(params, state, jnp.asarray(z), train=False)
    gen = generator_from_jax(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state))
    assert not gen.training
    with torch.no_grad():
        got = gen(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_generator_layout_mirrors_jax():
    """Widths grow by each block's output (residual concat), weights are
    the transposes of JAX's (fan_in, fan_out) matrices."""
    params, state = _jax_generator(10, (8, 6), 5, seed=3)
    gen = generator_from_jax(params, state)
    assert [b.fc.in_features for b in gen.blocks] == [10, 18]
    assert gen.out.in_features == 24 and gen.out.out_features == 5
    np.testing.assert_array_equal(gen.blocks[1].fc.weight.detach().numpy(),
                                  np.asarray(params["blocks"][1]["fc"]["w"]).T)
    np.testing.assert_array_equal(gen.blocks[0].bn.running_var.numpy(),
                                  np.asarray(state["blocks"][0]["var"]))
    assert gen.blocks[0].bn.eps == 1e-5 and gen.blocks[0].bn.momentum == 0.1
