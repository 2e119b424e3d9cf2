"""The port's variational DP-GMM fit and ``ModeNormalizer`` against the JAX
package's (``features/bgm_jax.fit_columns_jax``, ``features/bgm.ColumnGMM``,
``features/transformer.ModeNormalizer``)."""

import numpy as np
import pytest
import torch

from fed_tgan_tpu.features.bgm import ColumnGMM as JaxGMM
from fed_tgan_tpu.features.bgm_jax import fit_columns_jax
from fed_tgan_tpu.features.transformer import ModeNormalizer as JaxNormalizer
from fed_tgan_torch.features.bgm import ColumnGMM, fit_columns
from fed_tgan_torch.features.transformer import (
    ContinuousColumn,
    DiscreteColumn,
    ModeNormalizer,
)

torch.set_num_threads(1)

RTOL = 1e-3  # float32 fits in two frameworks, 120 sweeps


def _columns():
    rng = np.random.default_rng(0)
    cols = [np.concatenate([rng.normal(-5, 0.5, 300), rng.normal(2, 1.0, 500),
                            rng.normal(10, 0.3, 200)]),
            np.concatenate([rng.normal(0, 1, 700), rng.normal(20, 2, 300)]),
            rng.normal(3, 2, 257)]
    for c in cols:
        rng.shuffle(c)
    return cols


@pytest.fixture(scope="module")
def fits():
    cols = _columns()
    return cols, fit_columns_jax(cols), fit_columns(cols, device="cpu")


def test_fit_matches_jax_on_separated_modes(fits):
    _, jax_fits, ours = fits
    for j, t in zip(jax_fits, ours):
        assert t.n_active == j.n_active
        np.testing.assert_array_equal(t.active, j.active)
        np.testing.assert_allclose(t.means[t.active], j.means[j.active],
                                   rtol=RTOL, atol=1e-4)
        np.testing.assert_allclose(t.stds[t.active], j.stds[j.active],
                                   rtol=RTOL)
        np.testing.assert_allclose(t.weights, j.weights, atol=1e-4)
    # the two-mode column's modes are found
    assert ours[1].n_active == 2


def test_predict_proba_matches_jax_posterior(fits):
    _, _, ours = fits
    x = np.linspace(-8, 25, 101)
    for t in ours:
        j = JaxGMM(means=t.means, stds=t.stds, weights=t.weights,
                   active=t.active, mean_precision=t.mean_precision,
                   dof=t.dof, stick_a=t.stick_a, stick_b=t.stick_b)
        np.testing.assert_allclose(t.predict_proba(x), j.predict_proba(x),
                                   atol=1e-12)


def test_short_column_uses_its_length_as_components():
    """A column shorter than n_components is fitted with one component per
    sample (the JAX package hands it to sklearn with the same clamp)."""
    short, long = np.asarray([1.0, 1.1, 5.0, 5.2]), _columns()[2]
    fits = fit_columns([short, long], device="cpu")
    assert fits[0].n_components == 4 and fits[1].n_components == 10
    assert np.isfinite(fits[0].means).all() and fits[0].n_active >= 1
    np.testing.assert_allclose(fits[0].weights.sum(), 1.0)


def _table(n=600, seed=1):
    rng = np.random.default_rng(seed)
    cont = np.concatenate([rng.normal(-2, 0.5, n // 2),
                           rng.normal(3, 1.0, n - n // 2)])
    rng.shuffle(cont)
    cat = rng.choice([4, 1, 7], n, p=[0.6, 0.3, 0.1]).astype(float)
    ordinal = rng.integers(0, 3, n).astype(float)
    other = rng.exponential(2.0, n)
    return np.stack([cont, cat, ordinal, other], axis=1)


def test_mode_normalizer_matches_jax_with_injected_gmms():
    data = _table()
    ours = ModeNormalizer(device="cpu").fit(data, categorical_idx=[1],
                                            ordinal_idx=[2])
    gmms = {j: JaxGMM(means=g.means, stds=g.stds, weights=g.weights,
                      active=g.active, mean_precision=g.mean_precision,
                      dof=g.dof, stick_a=g.stick_a, stick_b=g.stick_b)
            for j, g in enumerate(ours.gmms) if g is not None}
    theirs = JaxNormalizer().fit(data, categorical_idx=[1], ordinal_idx=[2],
                                 column_gmms=gmms)
    assert ours.output_info == theirs.output_info
    assert ours.output_dim == theirs.output_dim
    enc = ours.transform(data, rng=np.random.default_rng(5))
    want = theirs.transform(data, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(enc, want)
    np.testing.assert_allclose(ours.inverse_transform(enc),
                               theirs.inverse_transform(want), rtol=1e-12)
    # decode columns: active modes, and frequency-ordered codes
    assert isinstance(ours.columns[0], ContinuousColumn)
    assert isinstance(ours.columns[1], DiscreteColumn)
    assert ours.columns[1].codes.tolist() == [4, 1, 7]
    g = ours.gmms[0]
    np.testing.assert_array_equal(ours.columns[0].means, g.means[g.active])


def test_mode_normalizer_own_fit_round_trips_and_rejects_unknown_codes():
    data = _table(seed=2)
    norm = ModeNormalizer(device="cpu").fit(data, categorical_idx=[1, 2])
    enc = norm.transform(data, rng=np.random.default_rng(0))
    assert enc.shape == (len(data), norm.output_dim) and enc.dtype == np.float32
    back = norm.inverse_transform(enc)
    np.testing.assert_array_equal(back[:, 1:3], data[:, 1:3])
    # the continuous value comes back up to the +-0.99 clip of its mode
    assert np.mean(np.abs(back[:, 0] - data[:, 0]) < 1e-3) > 0.95
    bad = data.copy()
    bad[0, 1] = 5.0  # a code inside the fitted range that never occurred
    with pytest.raises(ValueError, match="unseen"):
        norm.transform(bad)
    bad[0, 1] = 99.0
    with pytest.raises(ValueError, match="out of fitted range"):
        norm.transform(bad)
    with pytest.raises(ValueError, match="missing"):
        ModeNormalizer(device="cpu").fit(data, categorical_idx=[1, 2],
                                         column_gmms={0: norm.gmms[0]})
