"""The activation's gradient: the port's plain K2 (``apply_activate_bwd``)
and its ``ActivateFunction`` against the JAX package's.

The same logits, uniforms and upstream gradients go through ``jax.vjp``
of the Pallas kernel in interpret mode (whose backward is the TPU kernel
K2), through ``jax.vjp`` of the XLA path, and through the port, at the
``atol=1e-5`` of the forward tests.  The CUDA kernel itself is held
against the plain version in ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fed_tgan_tpu.ops.activate_pallas import fused_apply_activate as pallas_activate
from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
from fed_tgan_tpu.ops.segments import apply_activate_xla
from fed_tgan_torch.ops.activate_cuda import (
    ActivateFunction,
    fused_activate_bwd,
    fused_apply_activate,
)
from fed_tgan_torch.ops.segments import (
    SegmentSpec,
    apply_activate,
    apply_activate_bwd,
)

torch.set_num_threads(1)

INFO = [(1, "tanh"), (3, "softmax"), (1, "tanh"), (5, "softmax"), (2, "softmax")]
ATOL = 1e-5  # float32 exp/log in two frameworks, gradients scaled by 1/tau=5


@pytest.fixture(scope="module")
def specs():
    return JaxSpec.from_output_info(INFO), SegmentSpec.from_output_info(INFO)


def _inputs(dim, rows, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, dim)) * 2.0).astype(np.float32)
    dy = rng.standard_normal((rows, dim)).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("rows", [5, 8, 300])
def test_plain_bwd_matches_jax_vjp(specs, rows):
    jspec, spec = specs
    x, dy = _inputs(spec.dim, rows, rows)
    key = jax.random.key(rows)
    u = np.array(jax.random.uniform(key, x.shape))  # the uniforms of key
    out_p, vjp_p = jax.vjp(
        lambda a: pallas_activate(a, jspec, key, interpret=True), jnp.asarray(x))
    out_x, vjp_x = jax.vjp(lambda a: apply_activate_xla(a, jspec, key),
                           jnp.asarray(x))
    out = apply_activate(torch.from_numpy(x), spec, torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_p), atol=ATOL)
    got = apply_activate_bwd(torch.from_numpy(dy), out, spec).numpy()
    np.testing.assert_allclose(got, np.asarray(vjp_p(jnp.asarray(dy))[0]),
                               atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(vjp_x(jnp.asarray(dy))[0]),
                               atol=ATOL)
    # the wrapper routes a CPU tensor to the plain version
    np.testing.assert_array_equal(
        fused_activate_bwd(torch.from_numpy(dy), out, spec).numpy(), got)


@pytest.mark.parametrize("rows", [5, 64])
def test_activate_function_matches_autograd_of_plain_forward(specs, rows):
    _, spec = specs
    x, w = _inputs(spec.dim, rows, 10 + rows)
    u = torch.from_numpy(np.random.default_rng(rows).random(x.shape,
                                                            dtype=np.float32))
    xa = torch.from_numpy(x).requires_grad_(True)
    ya = fused_apply_activate(xa, spec, u)  # requires_grad: ActivateFunction
    assert ya.grad_fn is not None and "ActivateFunction" in type(
        ya.grad_fn).__name__
    (torch.from_numpy(w) * ya).sum().backward()
    xb = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(w) * apply_activate(xb, spec, u)).sum().backward()
    np.testing.assert_array_equal(ya.detach().numpy(),
                                  apply_activate(torch.from_numpy(x), spec,
                                                 u).numpy())
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), atol=ATOL)


def test_no_grad_input_skips_the_function(specs):
    _, spec = specs
    x, _ = _inputs(spec.dim, 4, 1)
    u = torch.full(x.shape, 0.5)
    y = fused_apply_activate(torch.from_numpy(x), spec, u)
    assert y.grad_fn is None
    with torch.no_grad():
        xg = torch.from_numpy(x).requires_grad_(True)
        assert fused_apply_activate(xg, spec, u).grad_fn is None


def test_plain_bwd_passes_gradcheck_in_float64(specs):
    """The analytic backward against finite differences of the plain
    forward, both in float64."""
    _, spec = specs
    x, _ = _inputs(spec.dim, 6, 3)
    x = torch.from_numpy(x.astype(np.float64) * 0.5).requires_grad_(True)
    u = torch.from_numpy(np.random.default_rng(3).uniform(0.05, 0.95, x.shape))
    assert torch.autograd.gradcheck(
        lambda a: ActivateFunction.apply(a, spec, u), (x,), eps=1e-6,
        atol=1e-6)


def test_bwd_underflow_segment_is_finite(specs):
    """A segment whose softmax saturates (one output 1, the rest 0) has a
    finite, near-zero gradient."""
    _, spec = specs
    x = torch.zeros((4, spec.dim))
    x[:, 0] = 50.0
    x[:, 5] = 30.0
    out = apply_activate(x, spec, torch.full(x.shape, 0.5))
    dx = apply_activate_bwd(torch.ones_like(out), out, spec)
    assert torch.isfinite(dx).all()
    # a constant upstream gradient has no effect through a softmax
    assert dx[:, 1:4].abs().max() < 1e-5 and dx[:, 5:10].abs().max() < 1e-5
