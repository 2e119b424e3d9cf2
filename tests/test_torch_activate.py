"""The port's activation against the JAX package's.

The same logits and the same uniforms go through the JAX XLA path
(``apply_activate_xla``, whose uniforms are ``jax.random.uniform(key)``),
the Pallas kernel in interpret mode and the port's plain version, at the
``atol=1e-5`` of ``tests/test_pallas_activate.py``.  The CUDA kernel
itself is held against the plain version in a test that needs the card.
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
    fused_apply_activate,
    segment_tables,
)
from fed_tgan_torch.ops.segments import SegmentSpec, apply_activate
from fed_tgan_torch.serve.demo import intrusion_layout
from fed_tgan_torch.features.transformer import output_info

torch.set_num_threads(1)

INFO = [(1, "tanh"), (3, "softmax"), (1, "tanh"), (5, "softmax"), (2, "softmax")]
ATOL = 1e-5  # float32 exp/log in two frameworks, logits scaled by 1/tau=5


@pytest.fixture(scope="module")
def specs():
    return JaxSpec.from_output_info(INFO), SegmentSpec.from_output_info(INFO)


def _inputs(dim, rows, seed=0, key=42):
    x = np.asarray(jax.random.normal(jax.random.key(seed), (rows, dim))) * 2.0
    u = np.asarray(jax.random.uniform(jax.random.key(key), (rows, dim)))
    return x.astype(np.float32), u


def _port(x, spec, u):
    return apply_activate(torch.from_numpy(x), spec,
                          torch.from_numpy(np.array(u))).numpy()


@pytest.mark.parametrize("rows", [5, 8, 500, 300])
def test_forward_matches_jax(specs, rows):
    jspec, spec = specs
    x, u = _inputs(spec.dim, rows)
    key = jax.random.key(42)  # the key behind u
    want = np.asarray(apply_activate_xla(jnp.asarray(x), jspec, key))
    pallas = np.asarray(pallas_activate(jnp.asarray(x), jspec, key,
                                        interpret=True))
    got = _port(x, spec, u)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    # the wrapper routes a CPU tensor to the plain version
    wrapped = fused_apply_activate(torch.from_numpy(x), spec,
                                   torch.from_numpy(np.array(u))).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_forward_structure(specs):
    _, spec = specs
    x, u = _inputs(spec.dim, 64, seed=1, key=1)
    y = _port(x, spec, u)
    np.testing.assert_allclose(y[:, 0], np.tanh(x[:, 0]), atol=1e-6)
    np.testing.assert_allclose(y[:, 1:4].sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(y[:, 5:10].sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(y[:, 10:12].sum(1), 1.0, atol=1e-5)


def test_no_underflow_from_distant_dims(specs):
    """Per-segment stabilisation: a huge tanh pre-activation or a hot
    far-away segment must not zero out another segment."""
    jspec, spec = specs
    x = np.zeros((8, spec.dim), dtype=np.float32)
    x[:, 0] = 50.0
    x[:, 5] = 30.0
    key = jax.random.key(3)
    u = np.asarray(jax.random.uniform(key, x.shape))
    want = np.asarray(apply_activate_xla(jnp.asarray(x), jspec, key))
    got = _port(x, spec, u)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for st, size in [(1, 3), (5, 5), (10, 2)]:
        np.testing.assert_allclose(got[:, st:st + size].sum(1), 1.0, atol=1e-5)


def test_intrusion_layout_matches_jax_spec():
    """The serving layout's SegmentSpec is field for field the JAX one."""
    _, _, columns = intrusion_layout(np.random.default_rng(0))
    info = output_info(columns)
    spec, jspec = SegmentSpec.from_output_info(info), JaxSpec.from_output_info(info)
    assert (spec.dim, spec.n_segments, spec.n_discrete, spec.n_opt) == (
        282, 64, 42, 260)
    for name in ("dim", "n_segments", "n_discrete", "n_opt", "output_info"):
        assert getattr(spec, name) == getattr(jspec, name)
    for name in ("segment_ids", "is_tanh_dim", "discrete_dims",
                 "cond_column_ids", "cond_offsets", "cond_sizes"):
        np.testing.assert_array_equal(getattr(spec, name), getattr(jspec, name))


def test_kernel_segment_tables(specs):
    _, spec = specs
    start, is_tanh = segment_tables(spec)
    np.testing.assert_array_equal(start, [0, 1, 4, 5, 10, 12])
    np.testing.assert_array_equal(is_tanh, [1, 0, 1, 0, 0])
    assert start.dtype == np.int32 and is_tanh.dtype == np.uint8
