"""The port's training-side samplers against ``fed_tgan_tpu/train/sampler.py``:
the same count tables, the same CSR row pool, and the same draws when the
JAX package's random numbers are injected."""

import jax
import numpy as np
import pytest
import torch

from fed_tgan_tpu.ops.segments import SegmentSpec as JaxSpec
from fed_tgan_tpu.train.sampler import CondSampler as JaxCond
from fed_tgan_tpu.train.sampler import RowSampler as JaxRows
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.train.sampler import CondSampler, RowSampler

torch.set_num_threads(1)

INFO = [(1, "tanh"), (3, "softmax"), (5, "softmax"), (1, "tanh"),
        (2, "softmax")]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(0)
    n = 300
    parts = []
    for size, kind in INFO:
        if kind == "tanh":
            parts.append(rng.uniform(-0.9, 0.9, (n, 1)))
        else:  # skewed options, one never observed in the 5-wide column
            p = np.arange(size, 0, -1.0)
            if size == 5:
                p[3] = 0
            oh = np.zeros((n, size))
            oh[np.arange(n), rng.choice(size, n, p=p / p.sum())] = 1
            parts.append(oh)
    data = np.concatenate(parts, axis=1).astype(np.float32)
    return data, JaxSpec.from_output_info(INFO), SegmentSpec.from_output_info(INFO)


def test_count_matrix_and_tables_match_jax(table):
    data, jspec, spec = table
    np.testing.assert_array_equal(CondSampler.count_matrix(data, spec),
                                  JaxCond.count_matrix(data, jspec))
    ours, theirs = CondSampler.from_data(data, spec, "cpu"), JaxCond.from_data(data, jspec)
    np.testing.assert_array_equal(ours.p_train.numpy(), np.asarray(theirs.p_train))
    np.testing.assert_array_equal(ours.p_empirical.numpy(),
                                  np.asarray(theirs.p_empirical))


def test_row_pool_matches_jax(table):
    data, jspec, spec = table
    ours, theirs = RowSampler.from_data(data, spec, "cpu"), JaxRows.from_data(data, jspec)
    np.testing.assert_array_equal(ours.row_pool.numpy(), np.asarray(theirs.row_pool))
    np.testing.assert_array_equal(ours.offsets.numpy(), np.asarray(theirs.offsets))
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(theirs.counts))
    assert ours.n_rows == int(theirs.n_rows) == len(data)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_train_and_rows_from_jax_draws(table, seed):
    data, jspec, spec = table
    jcond, jrows = JaxCond.from_data(data, jspec), JaxRows.from_data(data, jspec)
    cond = CondSampler.from_data(data, spec, "cpu")
    rows = RowSampler.from_data(data, spec, "cpu")
    B = 200
    key, rkey = jax.random.split(jax.random.key(seed))
    want = [np.asarray(a) for a in jcond.sample_train(key, B)]
    kcol, kopt = jax.random.split(key)  # the draws sample_train makes
    col = torch.from_numpy(np.array(jax.random.randint(
        kcol, (B,), 0, jspec.n_discrete))).long()
    r = torch.from_numpy(np.array(jax.random.uniform(kopt, (B, 1))))
    got = [t.numpy() for t in cond.train_from_draws(col, r)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the never-observed option is never drawn
    assert not ((got[2] == 1) & (got[3] == 3)).any()

    want_rows = np.asarray(jrows.sample_rows(rkey, jax.numpy.asarray(want[2]),
                                             jax.numpy.asarray(want[3])))
    u = torch.from_numpy(np.array(jax.random.uniform(rkey, (B,))))
    got_rows = rows.sample_rows(torch.from_numpy(got[2]),
                                torch.from_numpy(got[3]), u).numpy()
    np.testing.assert_array_equal(got_rows, want_rows)
    # every drawn row really holds its option
    for i in range(B):
        c, o = got[2][i], got[3][i]
        assert data[got_rows[i], spec.discrete_dims[spec.cond_offsets[c] + o]] == 1


def test_sample_uniform_and_own_draws(table):
    data, _, spec = table
    rows = RowSampler.from_data(data, spec, "cpu")
    idx = rows.sample_uniform(torch.tensor([0.0, 0.4999, 0.99999]))
    assert idx.tolist() == [0, 149, 299]
    cond = CondSampler.from_data(data, spec, "cpu")
    g = torch.Generator().manual_seed(0)
    c, m, col, opt = cond.train_from_draws(*cond.draw(4000, g))
    assert (c.sum(1) == 1).all() and (m.sum(1) == 1).all()
    # columns drawn uniformly, options by the log-frequency table
    assert abs(col.float().mean().item() - 1.0) < 0.05
    first = opt[col == 0].bincount(minlength=3).float()
    np.testing.assert_allclose((first / first.sum()).numpy(),
                               cond.p_train[0, :3].numpy(), atol=0.04)
