"""The port's federated init against ``fed_tgan_tpu.federation.init`` on
the same three ragged client shards.

- category harmonization: equal global meta, encoders and JSD scores;
- with the same client mixtures injected: equal pooled Monte-Carlo
  samples and Wasserstein scores (atol 1e-12) and equal weights (atol
  1e-12); the pooled refit within slice 2's BGM tolerance (active modes
  equal, means rtol 1e-3 + atol 1e-4, stds rtol 1e-3, weights atol 1e-4);
- the whole protocol: equal meta, encoders and JSD, weights within 1e-3.
"""

import numpy as np
import pytest
import torch

from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.features.transformer import ModeNormalizer
from fed_tgan_torch.federation import init as port_init
from fed_tgan_torch.interop import federated_init_from_jax, gmm_from_jax
from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
from fed_tgan_tpu.features.bgm import ColumnGMM as JaxGMM
from fed_tgan_tpu.federation import init as jax_init

torch.set_num_threads(1)
ROWS = (150, 120, 90)
KW = dict(categorical_columns=["kind", "level"], non_negative_columns=["size"])


def client_tables(seed=0):
    """Three shards of one schema: a bimodal column, a non-negative one,
    two categorical ones whose frequencies differ per client."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(ROWS):
        modes = rng.choice([-4.0, 3.0], n, p=[0.3 + 0.2 * i, 0.7 - 0.2 * i])
        out.append({
            "x": np.round(modes + rng.normal(0, 0.4, n), 3),
            "size": np.round(np.exp(rng.choice([2.0, 6.0], n)
                                    + rng.normal(0, 0.1, n))),
            "kind": rng.choice(["p", "q", "r"], n,
                               p=[0.5, 0.3, 0.2] if i else [0.2, 0.3, 0.5]),
            "level": rng.integers(0, 3 + i, n),
        })
    return out


def both_clients():
    tables = client_tables()
    ours = [TablePreprocessor(table=t, name="toy", **KW) for t in tables]
    import pandas as pd

    theirs = [JaxPre(frame=pd.DataFrame(t), name="toy", **KW) for t in tables]
    return ours, theirs


def to_jax_gmm(g):
    return JaxGMM(means=g.means, stds=g.stds, weights=g.weights,
                  active=g.active, mean_precision=g.mean_precision, dof=g.dof,
                  stick_a=g.stick_a, stick_b=g.stick_b)


def test_harmonize_categories_matches_jax():
    ours, theirs = both_clients()
    metas = [c.local_meta() for c in ours]
    assert metas == [c.local_meta() for c in theirs]
    meta, enc, jsd, jsd_raw = port_init.harmonize_categories(metas, raw=True)
    jmeta, jenc, jjsd, jjsd_raw, _ = jax_init.harmonize_categories(metas,
                                                                   raw=True)
    assert meta == jmeta
    assert [e.classes_.tolist() for e in enc] == [
        e.classes_.tolist() for e in jenc]
    np.testing.assert_array_equal(jsd, jjsd)
    np.testing.assert_array_equal(jsd_raw, jjsd_raw)
    bad = [dict(m) for m in metas]
    bad[1] = {**bad[1], "columns": bad[1]["columns"][::-1]}
    with pytest.raises(ValueError, match="positionally"):
        port_init.harmonize_categories(bad)


@pytest.fixture(scope="module")
def injected():
    """The port's local mixtures of every client, and both packages'
    ``harmonize_continuous`` over them."""
    ours, _ = both_clients()
    metas = [c.local_meta() for c in ours]
    _, enc, _ = port_init.harmonize_categories(metas)
    mats = [c.encode(enc) for c in ours]
    gmms = [ModeNormalizer(device="cpu").fit(m, cat).column_gmms
            for m, cat, _ in mats]
    jgmms = [[None if g is None else to_jax_gmm(g) for g in row]
             for row in gmms]
    rows = [len(m) for m, _, _ in mats]
    port = port_init.harmonize_continuous(gmms, rows, seed=3, raw=True,
                                          device="cpu")
    jax = jax_init.harmonize_continuous(jgmms, rows, seed=3, backend="jax",
                                        raw=True)
    return gmms, jgmms, rows, port, jax


def test_pooled_samples_and_wd_match_jax(injected):
    gmms, jgmms, rows, (_, wd, wd_raw), (_, jwd, jwd_raw) = injected
    samples = port_init.pooled_samples(gmms, rows, seed=3)
    # the JAX protocol's draws, made with its own ColumnGMM.sample
    rng = np.random.default_rng(3)
    n = sum(rows)
    for j, per_client in samples.items():
        for i, got in enumerate(per_client):
            want = jgmms[i][j].sample(int(n * (float(rows[i]) / n)), rng)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(wd_raw, jwd_raw, rtol=0, atol=1e-12)
    np.testing.assert_allclose(wd, jwd, rtol=0, atol=1e-12)
    jsd = np.random.default_rng(0).random((3, 2))
    np.testing.assert_allclose(
        port_init.aggregation_weights(jsd, wd, rows),
        jax_init.aggregation_weights(jsd, jwd, rows), rtol=0, atol=1e-12)


def test_pooled_refit_within_bgm_tolerance(injected):
    *_, (port_g, _, _), (jax_g, _, _) = injected
    assert [g is None for g in port_g] == [g is None for g in jax_g]
    for t, j in zip(port_g, jax_g):
        if t is None:
            continue
        np.testing.assert_array_equal(t.active, j.active)
        np.testing.assert_allclose(t.means[t.active], j.means[j.active],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(t.stds[t.active], j.stds[j.active],
                                   rtol=1e-3)
        np.testing.assert_allclose(t.weights, j.weights, atol=1e-4)


def test_renormalize_weights_matches_jax():
    w = np.asarray([0.2, 0.5, 0.3])
    alive = np.asarray([True, False, True])
    np.testing.assert_array_equal(port_init.renormalize_weights(w, alive),
                                  jax_init.renormalize_weights(w, alive))
    with pytest.raises(ValueError, match="no surviving"):
        port_init.renormalize_weights(w, np.zeros(3, dtype=bool))


def test_federated_initialize_matches_jax():
    ours, theirs = both_clients()
    init = port_init.federated_initialize(ours, seed=1, device="cpu")
    jinit = jax_init.federated_initialize(theirs, seed=1, backend="jax")
    assert (init.global_meta.to_json_dict()
            == jinit.global_meta.to_json_dict())
    np.testing.assert_array_equal(init.jsd, jinit.jsd)
    assert init.rows_per_client == jinit.rows_per_client == list(ROWS)
    np.testing.assert_allclose(init.weights, jinit.weights, atol=1e-3)
    assert init.output_info == jinit.output_info
    assert [m.shape for m in init.client_matrices] == [
        m.shape for m in jinit.client_matrices]
    assert set(init.timings) == {
        "category_harmonize", "encode", "local_bgm_fit",
        "continuous_harmonize", "refit_transform", "aggregation_weights"}
    uniform = port_init.federated_initialize(ours, seed=1, weighted=False,
                                             device="cpu")
    np.testing.assert_allclose(uniform.weights, 1 / 3)
    # the JAX init converts into the port's, mixtures included
    conv = federated_init_from_jax(jinit)
    assert conv.output_info == jinit.output_info
    for tf, jtf in zip(conv.transformers, jinit.transformers):
        for g, jg in zip(tf.column_gmms, jtf.column_gmms):
            assert (g is None) == (jg is None)
            if g is not None:
                np.testing.assert_array_equal(g.means, jg.means)
    np.testing.assert_array_equal(conv.client_matrices[2],
                                  jinit.client_matrices[2])
    with pytest.raises(ValueError, match="variational"):
        gmm_from_jax(JaxGMM(means=np.zeros(2), stds=np.ones(2),
                            weights=np.ones(2) / 2,
                            active=np.ones(2, dtype=bool)))
