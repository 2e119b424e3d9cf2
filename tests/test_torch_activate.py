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
    SMEM_BLOCK,
    TANH_BIT,
    dim_codes,
    dim_tables,
    fused_apply_activate,
    launch_plan,
    segment_tables,
    smem_bytes,
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


def _intrusion_spec():
    _, _, columns = intrusion_layout(np.random.default_rng(0))
    info = output_info(columns)
    return SegmentSpec.from_output_info(info), JaxSpec.from_output_info(info)


def test_kernel_dim_tables_match_jax_spec():
    """The per-dim tables the kernels stage are the JAX SegmentSpec's
    ``segment_ids`` and ``is_tanh_dim`` on the Intrusion layout, and the
    packed code carries both."""
    spec, jspec = _intrusion_spec()
    seg, tanh = dim_tables(spec)
    assert seg.dtype == np.uint16 and tanh.dtype == np.uint8
    np.testing.assert_array_equal(seg, jspec.segment_ids)
    np.testing.assert_array_equal(tanh.astype(bool), jspec.is_tanh_dim)
    codes = dim_codes(spec)
    np.testing.assert_array_equal(codes & (TANH_BIT - 1), jspec.segment_ids)
    np.testing.assert_array_equal((codes & TANH_BIT) != 0, jspec.is_tanh_dim)


@pytest.mark.parametrize("dim,n_segments", [(282, 64), (285, 65), (75, 4)])
def test_launch_plan_covers_every_sm_at_training_rows(dim, n_segments):
    """At the training batch (500 rows) every one of the H100's 132 SMs
    gets a tile of a few rows, and the block stays within 227 KB."""
    plan = launch_plan(500, dim, n_segments, sms=132)
    assert plan.tiles >= 132 and plan.staged
    assert plan.rows_per_tile > 1  # a few rows per block, not one
    assert plan.rows_per_tile * plan.tiles >= 500
    assert plan.rows_per_tile * (plan.tiles - 1) < 500
    assert plan.smem_bytes <= SMEM_BLOCK


@pytest.mark.parametrize("rows", [1, 5, 500, 8000, 64000])
def test_launch_plan_one_block_per_tile_within_shared_memory(rows):
    spec, _ = _intrusion_spec()
    plan = launch_plan(rows, spec.dim, spec.n_segments, sms=132)
    assert plan.smem_bytes <= SMEM_BLOCK
    assert plan.smem_bytes == smem_bytes(plan.rows_per_tile, spec.dim,
                                         spec.n_segments)
    assert plan.staged and plan.tiles == -(-rows // plan.rows_per_tile)
    assert 1 <= plan.blocks_per_sm <= 8
    if rows >= 8000:  # at least one full wave of resident blocks
        assert plan.rows_per_tile > 1
        assert plan.tiles >= 132 * plan.blocks_per_sm


def _largest_dim(fits):
    lo, hi = 1, 1 << 16
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def _plan_or_none(rows, dim, n_segments):
    try:
        return launch_plan(rows, dim, n_segments)
    except ValueError:
        return None


def test_launch_plan_raises_beyond_the_supported_dim():
    """Rows up to 29,056 floats, one row of both operands in a block's
    227 KB, are taken; one more raises."""
    lo = _largest_dim(lambda d: _plan_or_none(2, d, 3) is not None)
    assert lo == SMEM_BLOCK // 8 == 29056
    assert launch_plan(2, lo, 3).smem_bytes <= SMEM_BLOCK
    with pytest.raises(ValueError):
        launch_plan(2, lo + 1, 3)
    with pytest.raises(ValueError):
        launch_plan(0, 282, 64)


@pytest.mark.parametrize("n_segments", [3, 300])
def test_launch_plan_runs_rows_too_wide_to_stage_unstaged(n_segments):
    """Past the widest row that fits staged beside its tables, each block
    takes one row unstaged, with the (row, segment) results alone in shared
    memory; that fits even for 29,056 segments of one dim."""
    widest = _largest_dim(lambda d: (p := _plan_or_none(
        2, d, n_segments)) is not None and p.staged)
    assert 8000 < widest < 29056  # the wide card test's 8,000 stages
    for dim in (widest + 1, 29056):
        plan = launch_plan(5, dim, n_segments)
        assert not plan.staged and plan.rows_per_tile == 1 and plan.tiles == 5
        assert plan.smem_bytes == smem_bytes(1, dim, n_segments, staged=False)
        assert plan.blocks_per_sm >= 1
    assert launch_plan(1, 29056, 29056).smem_bytes == SMEM_BLOCK
