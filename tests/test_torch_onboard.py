"""Cohort-batched onboarding in the port against ``tests/test_onboard.py``'s
cases on the same inputs (the toy table, 6 Dirichlet shards: 4 residents,
2 newcomers), JAX's ``fit_shards_jax``, ``federated_initialize``,
``InitCache`` and ``OnboardingSession`` beside the port's:

- the bucketed fit: a shard's fit is bit for bit the same alone and among
  any batch-mates (the cache's premise), batched init == per-client init
  bitwise, and ``fit_shards`` against ``fit_shards_jax`` within the BGM
  tolerance of ``test_torch_bgm.py``;
- the sketch: ``wd_sketch`` against JAX's within 1e-4 relative, the
  pooled draw equal to JAX's bit for bit, the init's sketch weights
  within 1e-4 of JAX's sketch weights and within 5e-3 of exact (the same
  argmax);
- ``shard_fingerprint`` equal to JAX's, for the toy shards and for CSVs
  read by each package's reader;
- the cache: a warm run bit-identical, invalidation by data, schema and
  seed, corrupt entries and the ``corrupt_cache`` fault refitted;
- streaming registration: newcomers admitted with weights within 1e-4 of
  JAX's ``register_clients``, residents untouched, bad shards rejected or
  dropped;
- encoded-only init, and the init's phase timings and cache events.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from fed_tgan_torch.data.csvio import read_csv
from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.sharding import shard_table
from fed_tgan_torch.features.bgm import fit_columns, fit_shards
from fed_tgan_torch.federation import sketch
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.federation.init_cache import InitCache, shard_fingerprint
from fed_tgan_torch.federation.streaming import OnboardingSession
from fed_tgan_torch.serve.demo import write_dated_csv, write_intrusion_csv
from fed_tgan_torch.testing.faults import FaultPlan, install_plan
from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
from fed_tgan_tpu.data.sharding import shard_dataframe
from fed_tgan_tpu.features.bgm_jax import fit_shards_jax
from fed_tgan_tpu.federation import OnboardingSession as JaxSession
from fed_tgan_tpu.federation import federated_initialize as jax_initialize
from fed_tgan_tpu.federation import sketch as jax_sketch
from fed_tgan_tpu.federation.init_cache import (
    shard_fingerprint as jax_fingerprint,
)

torch.set_num_threads(1)
RTOL = 1e-3  # float32 fits in two frameworks (test_torch_bgm.py)
FP = dict(n_components=10, backend="jax", seed=0)


def as_table(frame: pd.DataFrame) -> dict:
    return {c: frame[c].to_numpy() for c in frame.columns}


@pytest.fixture(scope="module")
def shards(toy_frame):
    """The six shards of ``tests/test_onboard.py`` in both packages."""
    jax_shards = shard_dataframe(toy_frame, 6, "dirichlet",
                                 label_column="flag", alpha=2.0, seed=13)
    port_shards = shard_table(as_table(toy_frame), 6, "dirichlet",
                              label_column="flag", alpha=2.0, seed=13)
    return jax_shards, port_shards


@pytest.fixture(scope="module")
def clients(shards, toy_spec):
    return [TablePreprocessor(table=s, **toy_spec) for s in shards[1][:4]]


@pytest.fixture(scope="module")
def newcomers(shards, toy_spec):
    return [TablePreprocessor(table=s, **toy_spec) for s in shards[1][4:]]


@pytest.fixture(scope="module")
def jax_clients(shards, toy_spec):
    return [JaxPre(frame=s, **toy_spec) for s in shards[0][:4]]


def init(clients, **kw):
    return federated_initialize(clients, seed=0, device="cpu", **kw)


@pytest.fixture(scope="module")
def sketch_init(clients):
    return init(clients, similarity="sketch")


@pytest.fixture(scope="module")
def jax_sketch_init(jax_clients):
    return jax_initialize(jax_clients, seed=0, backend="jax",
                          similarity="sketch")


def same_init(a, b):
    assert len(a.client_matrices) == len(b.client_matrices)
    for ma, mb in zip(a.client_matrices, b.client_matrices):
        assert np.array_equal(ma, mb)
    assert np.array_equal(a.weights, b.weights)
    assert a.output_info == b.output_info


def same_gmm(a, b):
    for f in ("means", "stds", "weights", "mean_precision", "dof",
              "stick_a", "stick_b"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


# --------------------------------------------------------------- batched fit


def test_batched_fit_matches_per_client(clients):
    solo = init(clients, batch_fit=False)
    batched = init(clients, batch_fit=True)
    for ma, mb in zip(solo.client_matrices, batched.client_matrices):
        assert np.array_equal(ma, mb), "batched fit must be bitwise-identical"
    assert np.array_equal(solo.weights, batched.weights)


def test_fit_shards_ragged_matches_fit_columns():
    rng = np.random.default_rng(3)
    shard_cols = [
        [rng.normal(0, 1, 150), rng.normal(5, 2, 150)],
        [rng.normal(-3, 0.5, 140), rng.normal(1, 1, 140)],
        [rng.normal(2, 1, 70)],
        [rng.normal(0, 1, 5)],
    ]
    out = fit_shards(shard_cols, device="cpu")
    assert [len(s) for s in out] == [len(s) for s in shard_cols]
    for shard in out:
        for g in shard:
            assert np.all(np.isfinite(g.means)) and np.all(g.stds > 0)
            assert np.isclose(g.weights.sum(), 1.0, atol=1e-5)
    # bucketing independence: a shard's fit does not depend on its
    # batch-mates, or cache entries would change meaning across cohorts
    for got, want in zip(out[0], fit_columns(shard_cols[0], device="cpu")):
        same_gmm(got, want)
    # the JAX fit of the same shards (the tiny column is the port's clamp,
    # not sklearn: an accepted divergence)
    theirs = fit_shards_jax(shard_cols[:3])
    for ours_s, theirs_s in zip(out[:3], theirs):
        for a, b in zip(ours_s, theirs_s):
            assert np.array_equal(a.active, b.active)
            np.testing.assert_allclose(a.means[a.active], b.means[b.active],
                                       rtol=RTOL, atol=1e-4)
            np.testing.assert_allclose(a.weights, b.weights, atol=1e-4)


@pytest.mark.parametrize("mates", [7, 40, 300])
def test_fit_is_independent_of_the_batch_size(mates):
    """One column alone and among ``mates`` others of its row bucket (and
    of other buckets, spilled over the batch floor) gives the same bits."""
    rng = np.random.default_rng(mates)
    col = np.concatenate([rng.normal(-2, 0.5, 90), rng.normal(4, 1, 110)])
    others = [rng.normal(rng.uniform(-5, 5), 1, rng.integers(129, 256))
              for _ in range(mates)]
    alone = fit_columns([col], device="cpu")[0]
    among = fit_columns(others[:3] + [col] + others[3:], device="cpu")[3]
    same_gmm(alone, among)


# ----------------------------------------------------------- sketch parity


def test_wd_sketch_and_pooled_draw_match_jax(sketch_init):
    ob = sketch_init.onboarding
    stacks = (ob["mix_means"], ob["mix_stds"], ob["mix_weights"])
    rows = sketch_init.rows_per_client
    cont = ob["cont_idx"]
    ours = sketch.wd_sketch(None, rows, cont, stacks=stacks, device="cpu")
    theirs = jax_sketch.wd_sketch(None, rows, cont, stacks=stacks)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-6)
    alive = np.array([True, False, True, True])
    np.testing.assert_array_equal(sketch.live_omega(rows, alive),
                                  jax_sketch.live_omega(rows, alive))
    for a, b in zip(sketch.pooled_mixture_sample(None, rows, cont, 4096, 5,
                                                 stacks=stacks),
                    jax_sketch.pooled_mixture_sample(None, rows, cont, 4096,
                                                     5, stacks=stacks)):
        assert np.array_equal(a, b)


def test_sketch_similarity_matches_exact_weights(clients, sketch_init,
                                                 jax_sketch_init):
    exact = init(clients, similarity="exact")
    assert np.allclose(exact.jsd_raw, sketch_init.jsd_raw)
    assert np.allclose(sketch_init.wd.sum(axis=0), 1.0)
    assert np.abs(exact.weights - sketch_init.weights).max() < 5e-3
    assert exact.weights.argmax() == sketch_init.weights.argmax()
    np.testing.assert_allclose(sketch_init.weights, jax_sketch_init.weights,
                               atol=1e-4)
    np.testing.assert_allclose(sketch_init.jsd_raw, jax_sketch_init.jsd_raw,
                               atol=1e-12)


def test_encoded_only_skips_matrices(clients):
    got = init(clients, similarity="sketch", transform_matrices=False)
    assert got.client_matrices == []
    assert got.weights.shape == (4,)
    assert np.isclose(got.weights.sum(), 1.0)
    assert got.rows_per_client == [c.n_rows for c in clients]


# ---------------------------------------------------------- fingerprints


def test_shard_fingerprint_equals_jax(clients, jax_clients):
    for ours, theirs in zip(clients, jax_clients):
        assert shard_fingerprint(ours, **FP) == jax_fingerprint(theirs, **FP)


@pytest.mark.parametrize("kind", ["intrusion", "dated"])
def test_fingerprint_of_a_csv_equals_jax(tmp_path, kind):
    """Each package reads the same CSV with its own reader and ingest:
    the fingerprints agree (every column typed as pandas types it)."""
    path = str(tmp_path / "t.csv")
    if kind == "intrusion":
        from fed_tgan_torch.datasets import INTRUSION, preprocessor_kwargs

        write_intrusion_csv(path, 300, 4)
        kw = preprocessor_kwargs(INTRUSION)
    else:
        write_dated_csv(path, 300, 4)
        kw = dict(categorical_columns=["protocol_type", "class"],
                  non_negative_columns=["src_bytes"],
                  date_formats={"when": "YYYY-MM-DD",
                                "stamp": "yymmdd|YYYY-MM-DD"})
    ours = TablePreprocessor(table=read_csv(path), **kw)
    theirs = JaxPre(frame=pd.read_csv(path), **kw)
    assert list(ours.columns) == list(theirs.df.columns)
    assert shard_fingerprint(ours, **FP) == jax_fingerprint(theirs, **FP)


# -------------------------------------------------------------- init cache


def test_cache_warm_run_bit_identical(clients, tmp_path):
    root = str(tmp_path / "cache")
    cold = init(clients, similarity="sketch", cache=root)
    assert os.listdir(root), "cold run must populate the cache"
    warm = init(clients, similarity="sketch", cache=root)
    same_init(cold, warm)
    assert "cache_restore" in warm.timings
    assert warm.onboarding["params"] == cold.onboarding["params"]
    for k in ("jsd_raw", "wd_raw", "mix_means", "mix_stds", "mix_weights"):
        assert np.array_equal(warm.onboarding[k], cold.onboarding[k])


def test_cache_fingerprint_invalidation(clients, toy_spec, tmp_path):
    fp0 = shard_fingerprint(clients[0], **FP)
    assert fp0 == shard_fingerprint(clients[0], **FP)
    shifted = dict(clients[0].table)
    shifted["score"] = shifted["score"] + 1.0
    assert shard_fingerprint(TablePreprocessor(table=shifted, **toy_spec),
                             **FP) != fp0
    spec = dict(toy_spec, non_negative_columns=[])
    assert shard_fingerprint(TablePreprocessor(
        table=dict(clients[0].table), **spec), **FP) != fp0
    assert shard_fingerprint(clients[0], **dict(FP, seed=1)) != fp0
    cache = InitCache(str(tmp_path / "c"))
    assert cache.load_client(fp0) is None
    assert cache.counts[("miss", "client")] == 1


def _ops(cache: InitCache) -> dict:
    ops = {}
    for e in cache.events:
        key = f"{e['op']}_{e['scope']}"
        ops[key] = ops.get(key, 0) + int(e["count"])
    return ops


def test_cache_corrupt_entries_detected_and_refit(clients, tmp_path):
    root = str(tmp_path / "cache")
    cold = init(clients, similarity="sketch", cache=root)
    names = sorted(os.listdir(root))
    victims = [n for n in names if n.startswith("global-")
               and n.endswith(".npz")][:1]
    victims += [n for n in names if n.startswith("client-")][:1]
    assert len(victims) == 2
    for name in victims:
        path = os.path.join(root, name)
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
    cache = InitCache(root)
    warm = init(clients, similarity="sketch", cache=cache)
    same_init(cold, warm)
    ops = _ops(cache)
    assert ops.get("corrupt_global") == 1
    assert ops.get("corrupt_client") == 1
    assert ops.get("hit_client") == 3


def test_fault_injected_cache_corruption(clients, tmp_path):
    root = str(tmp_path / "cache")
    try:
        # stores land client by client, then the global npz (store #5)
        install_plan(FaultPlan.parse("corrupt_cache:nth=5"))
        cold = init(clients, similarity="sketch", cache=root)
    finally:
        install_plan(None)
    cache = InitCache(root)
    warm = init(clients, similarity="sketch", cache=cache)
    same_init(cold, warm)
    ops = _ops(cache)
    assert ops.get("corrupt_global") == 1
    assert ops.get("hit_client") == 4


def test_init_timings_and_cache_events(clients, tmp_path):
    """What JAX journals as ``init_phase`` and ``init_cache`` events: the
    phases' seconds in ``timings`` and the cache's op counts."""
    root = str(tmp_path / "cache")
    cache = InitCache(root)
    cold = init(clients, similarity="sketch", cache=cache)
    assert {"cache_lookup", "local_bgm_fit", "continuous_harmonize",
            "cache_store"} <= set(cold.timings)
    warm = init(clients, similarity="sketch", cache=cache)
    assert set(warm.timings) == {"cache_lookup", "cache_restore"}
    ops = _ops(cache)
    assert ops["store_client"] == 4 and ops["store_global"] == 1
    assert ops["hit_global"] == 1 and ops["miss_global"] == 1
    assert all(e["type"] == "init_cache" and e["root"] == root
               for e in cache.events)


# ---------------------------------------------------------------- streaming


def test_streaming_register_admits_newcomers(clients, newcomers, shards,
                                             toy_spec, jax_sketch_init):
    resident = init(clients, similarity="sketch")
    frozen = [m.copy() for m in resident.client_matrices]
    session = OnboardingSession(resident, device="cpu")
    grown = session.register_clients(newcomers)
    assert grown is session.init and session.n_clients == 6
    assert len(grown.client_matrices) == 6
    for got, want in zip(grown.client_matrices[:4], frozen):
        assert np.array_equal(got, want)
    assert len({m.shape[1] for m in grown.client_matrices}) == 1
    assert np.isclose(grown.weights.sum(), 1.0)
    assert grown.rows_per_client[4:] == [c.n_rows for c in newcomers]
    theirs = JaxSession(jax_sketch_init).register_clients(
        [JaxPre(frame=s, **toy_spec) for s in shards[0][4:]])
    np.testing.assert_allclose(grown.weights, theirs.weights, atol=1e-4)
    np.testing.assert_allclose(grown.jsd_raw, theirs.jsd_raw, atol=1e-12)
    np.testing.assert_allclose(grown.wd_raw, theirs.wd_raw, rtol=1e-4,
                               atol=1e-6)


def test_streaming_screen_rejects_bad_shards(clients, newcomers, toy_spec):
    resident = init(clients, similarity="sketch")
    alien = {k: v.copy() for k, v in newcomers[0].table.items()}
    alien["color"] = alien["color"].astype(object)
    alien["color"][: len(alien["color"]) // 2 + 1] = "purple"
    bad_vocab = TablePreprocessor(table=alien, **toy_spec)
    poisoned = {k: v.copy() for k, v in newcomers[0].table.items()}
    poisoned["score"][0] = np.inf
    bad_payload = TablePreprocessor(table=poisoned, **toy_spec)
    for bad in (bad_vocab, bad_payload):
        with pytest.raises(ValueError):
            OnboardingSession(resident, device="cpu").register_clients([bad])
    session = OnboardingSession(resident, device="cpu")
    grown = session.register_clients([bad_vocab, newcomers[1]],
                                     on_invalid="drop")
    assert session.n_clients == 5
    assert np.array_equal(grown.client_matrices[4],
                          session.init.client_matrices[4])


def test_streaming_registration_through_the_cache(clients, newcomers,
                                                  tmp_path):
    """A newcomer fitted once is a client-cache hit the next time, with
    the same scores."""
    resident = init(clients, similarity="sketch")
    cache = InitCache(str(tmp_path / "c"))
    first = OnboardingSession(resident, cache=cache,
                              device="cpu").register_clients(newcomers)
    again = OnboardingSession(resident, cache=cache,
                              device="cpu").register_clients(newcomers)
    assert np.array_equal(first.wd_raw, again.wd_raw)
    assert np.array_equal(first.weights, again.weights)
    assert _ops(cache) == {"miss_client": 2, "store_client": 2,
                           "hit_client": 2}
