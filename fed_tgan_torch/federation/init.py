"""The federation's one-time init: category harmonization, pooled mixture
refit, similarity weights
(counterpart of ``fed_tgan_tpu/federation/init.py``).

1. :func:`harmonize_categories`: merge the clients' category frequency
   dicts, order each global vocabulary by total frequency, fit one encoder
   per categorical column, and score every client per column by the
   Jensen-Shannon distance between its frequencies and the global ones.
2. :func:`harmonize_continuous`: per continuous column, every client
   scored by a Wasserstein distance to the pooled reference, and one
   global mixture refitted on a pooled sample (on the device, all columns
   in one batch).  ``method="exact"`` is the reference protocol (a
   rows-proportional Monte-Carlo sample from every client's mixture,
   scipy's ``wasserstein_distance`` on the host); ``method="sketch"``
   scores the mixtures' CDFs on the device and refits on a fixed-budget
   draw from the pooled mixture (:mod:`fed_tgan_torch.federation.sketch`),
   so its cost does not grow with the population.  ``backend="sklearn"``
   refits on the host (the reference-exact fit, seeded with ``seed``).
3. :func:`aggregation_weights`: ``softmax((1 - d_i / sum(d)) * n_i / N)``
   with ``d_i`` the client's summed normalized JSD and WD scores;
   :func:`recompute_weights` reruns it from raw scores over the live
   clients (the elastic federation's drift windows).

:func:`federated_initialize` fits every client's continuous columns in one
bucketed batch (:func:`~fed_tgan_torch.features.bgm.fit_shards`), can
restore or store the whole result through a content-hashed
:class:`~fed_tgan_torch.federation.init_cache.InitCache`, and keeps the
frozen references streaming registration scores newcomers against
(:attr:`FederatedInit.onboarding`).
"""

from __future__ import annotations

import copy
import logging
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
from scipy.spatial import distance as _sdistance
from scipy.stats import wasserstein_distance

from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.schema import TableMeta
from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.features.bgm import (
    BACKENDS,
    N_CLUSTERS,
    WEIGHT_EPS,
    ColumnGMM,
    fit_backend,
    fit_columns,
    fit_shards,
)
from fed_tgan_torch.features.transformer import ModeNormalizer
from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.obs.trace import record_span

log = logging.getLogger("fed_tgan_torch.federation")


def _normalize_per_column(dist: np.ndarray, n_clients: int) -> np.ndarray:
    """Each column's distances over their sum across clients; an all-zero
    column becomes ``1 / n_clients`` for everyone."""
    dist = dist.astype(np.float64).copy()
    col_sum = dist.sum(axis=0)
    nonzero = col_sum != 0
    dist[:, nonzero] = dist[:, nonzero] / col_sum[nonzero]
    dist[:, ~nonzero] = 1.0 / n_clients
    return dist


def harmonize_categories(local_metas: Sequence[dict], raw: bool = False,
                         counts: bool = False):
    """``(global_meta_dict, encoders, jsd)``: the first client's meta with
    each categorical ``i2s`` replaced by the frequency-ordered global
    vocabulary (ties in merge order), one encoder per categorical column,
    and the (n_clients, n_categorical) normalized JSD scores.  ``raw=True``
    appends the unnormalized scores; ``counts=True`` then the global count
    vector of each categorical column, indexed by code (the frozen
    reference of streaming registration).  Columns are merged by position,
    so every client must present the same names and kinds in the same
    order."""
    n_clients = len(local_metas)
    base = copy.deepcopy(local_metas[0])

    def signature(meta: dict) -> list:
        return [(c.get("column_name", ""), c["type"]) for c in meta["columns"]]

    base_sig = signature(base)
    for ci, meta in enumerate(local_metas[1:], start=1):
        sig = signature(meta)
        if sig != base_sig:
            mismatches = [
                f"position {k}: client0 has {a!r}, client{ci} has {b!r}"
                for k, (a, b) in enumerate(zip(base_sig, sig)) if a != b
            ] or [f"column count {len(base_sig)} vs {len(sig)}"]
            raise ValueError(
                "client metas disagree on column names/types/order; category "
                "harmonization merges positionally, so all clients must "
                "present the same schema in the same order. "
                + "; ".join(mismatches[:5]))

    cat_cols = [i for i, c in enumerate(base["columns"])
                if c["type"] == "categorical"]
    encoders: list[CategoryEncoder] = []
    jsd = np.zeros((n_clients, len(cat_cols)))
    global_counts = []
    for cursor, col_idx in enumerate(cat_cols):
        merged: dict[str, int] = {}
        for meta in local_metas:
            for key, count in meta["columns"][col_idx]["i2s"].items():
                merged[key] = merged.get(key, 0) + int(count)
        ordered = [k for k, _ in sorted(merged.items(), key=lambda kv: kv[1],
                                        reverse=True)]
        base["columns"][col_idx]["i2s"] = ordered
        base["columns"][col_idx]["size"] = len(ordered)
        enc = CategoryEncoder.fit(ordered)
        encoders.append(enc)
        codes = dict(zip(ordered, enc.transform(ordered).tolist()))
        vec_global = np.zeros(len(ordered))
        for key, count in merged.items():
            vec_global[codes[key]] = count
        global_counts.append(vec_global)
        for ci, meta in enumerate(local_metas):
            vec = np.zeros(len(ordered))
            for key, count in meta["columns"][col_idx]["i2s"].items():
                vec[codes[key]] = count
            jsd[ci, cursor] = _sdistance.jensenshannon(vec_global, vec)
    jsd = np.nan_to_num(jsd, nan=0.0)
    out = (base, encoders, _normalize_per_column(jsd, n_clients))
    if raw:
        out += (jsd,)
        if counts:
            out += (global_counts,)
    return out


def pooled_samples(client_gmms: Sequence[Sequence], rows_per_client:
                   Sequence[int], seed: int = 0) -> dict:
    """``{column: [client samples]}``: per continuous column (in column
    order), each client's rows-proportional draw from its mixture, all
    from one ``default_rng(seed)`` stream in the JAX package's order."""
    n_sample = int(np.sum(rows_per_client))
    by_number = [float(r) / n_sample for r in rows_per_client]
    rng = np.random.default_rng(seed)
    out = {}
    for j, gmm0 in enumerate(client_gmms[0]):
        if gmm0 is None:
            continue
        out[j] = [gmms[j].sample(int(n_sample * by_number[i]), rng)
                  for i, gmms in enumerate(client_gmms)]
    return out


def harmonize_continuous(client_gmms: Sequence[Sequence],
                         rows_per_client: Sequence[int], seed: int = 0,
                         n_components: int = N_CLUSTERS,
                         eps: float = WEIGHT_EPS, raw: bool = False,
                         device="cuda", method: str = "exact",
                         pool_budget: int = 0, grid_points: int = 0,
                         backend: str = "jax"):
    """``(global_gmms, wd)``: ``client_gmms[i][j]`` is client i's mixture
    of column j (None when discrete); ``global_gmms[j]`` the mixture
    refitted on the pooled sample, ``wd`` the (n_clients, n_continuous)
    normalized Wasserstein scores.  ``raw=True`` appends the unnormalized
    scores.  ``method`` is ``"exact"`` or ``"sketch"`` (the module
    docstring); the sketch's pool draws ``min(pool_budget or
    POOL_BUDGET, total rows)`` values a column on a ``grid_points`` (or
    ``GRID_POINTS``) grid.  ``backend`` picks the refit
    (:func:`~fed_tgan_torch.features.bgm.fit_backend`)."""
    n_clients = len(client_gmms)
    cont_cols = [j for j, g in enumerate(client_gmms[0]) if g is not None]
    if method == "sketch":
        from fed_tgan_torch.federation import sketch as _sketch

        stacks = _sketch.stack_client_gmms(client_gmms, cont_cols)
        wd = _sketch.wd_sketch(None, rows_per_client, cont_cols,
                               grid_points=grid_points or _sketch.GRID_POINTS,
                               stacks=stacks, device=device)
        budget = min(pool_budget or _sketch.POOL_BUDGET,
                     int(np.sum(rows_per_client)))
        pooled_cols = _sketch.pooled_mixture_sample(
            None, rows_per_client, cont_cols, budget=budget, seed=seed,
            stacks=stacks)
    elif method == "exact":
        samples = pooled_samples(client_gmms, rows_per_client, seed)
        wd = np.zeros((n_clients, len(samples)))
        pooled_cols = []
        for cursor, per_client in enumerate(samples.values()):
            pooled = np.concatenate(per_client)
            for i in range(n_clients):
                wd[i, cursor] = wasserstein_distance(pooled, per_client[i])
            pooled_cols.append(pooled)
    else:
        raise ValueError(f"unknown similarity method {method!r}")
    global_gmms: list = [None] * len(client_gmms[0])
    if pooled_cols:
        refits = fit_backend(pooled_cols, backend, n_components, eps, seed,
                             device=device)
        for j, gmm in zip(cont_cols, refits):
            global_gmms[j] = gmm
    if raw:
        return global_gmms, _normalize_per_column(wd, n_clients), wd
    return global_gmms, _normalize_per_column(wd, n_clients)


def aggregation_weights(jsd: np.ndarray, wd: np.ndarray,
                        rows_per_client: Sequence[int]) -> np.ndarray:
    """``softmax((1 - d_i / sum(d)) * n_i / N)``."""
    combo = jsd.sum(axis=1) + wd.sum(axis=1)
    total = combo.sum()
    by_number = np.asarray(rows_per_client, dtype=np.float64)
    by_number = by_number / by_number.sum()
    e = np.exp((1.0 - combo / total) * by_number)
    return e / e.sum()


def recompute_weights(jsd_raw: np.ndarray, wd_raw: np.ndarray,
                      rows_per_client: Sequence[int],
                      alive: Optional[np.ndarray] = None,
                      weighted: bool = True) -> np.ndarray:
    """Similarity weights (float32) from RAW per-column distances over the
    live clients: per-column normalization over the survivors, then the
    softmax combine, so they equal a fresh init's weights over the
    survivor set; a departed client gets 0.  ``weighted=False`` splits
    the mass evenly over the live clients."""
    n = len(rows_per_client)
    alive = (np.ones(n, dtype=bool) if alive is None
             else np.asarray(alive, dtype=bool))
    if not weighted:
        return renormalize_weights(np.full(n, 1.0 / n), alive)
    idx = np.nonzero(alive)[0]
    if idx.size == 0:
        raise ValueError("no surviving clients: all aggregation weight lost")
    live_jsd = _normalize_per_column(
        np.asarray(jsd_raw, dtype=np.float64)[idx], idx.size)
    live_wd = _normalize_per_column(
        np.asarray(wd_raw, dtype=np.float64)[idx], idx.size)
    w = np.zeros(n, dtype=np.float32)
    w[idx] = aggregation_weights(live_jsd, live_wd,
                                 [rows_per_client[i] for i in idx])
    return w


def renormalize_weights(weights: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """The weights restricted to the live clients and rescaled to sum 1
    (float32); a dropped client gets exactly 0."""
    w = np.asarray(weights, dtype=np.float64) * np.asarray(alive, dtype=bool)
    total = w.sum()
    if total <= 0.0:
        raise ValueError("no surviving clients: all aggregation weight lost")
    return (w / total).astype(np.float32)


@dataclass
class FederatedInit:
    """Everything the trainer needs after init."""

    global_meta: TableMeta
    encoders: list
    transformers: list            # one ModeNormalizer per client
    client_matrices: list         # encoded (rows, dim) float32 per client
    weights: np.ndarray           # (n_clients,) aggregation weights
    jsd: np.ndarray
    wd: np.ndarray
    rows_per_client: list = field(default_factory=list)
    jsd_raw: Optional[np.ndarray] = None
    wd_raw: Optional[np.ndarray] = None
    timings: dict = field(default_factory=dict)  # phase -> seconds
    # the frozen references streaming registration scores newcomers
    # against (:func:`_onboarding_state`)
    onboarding: Optional[dict] = None

    @property
    def output_info(self):
        return self.transformers[0].output_info


def _onboarding_state(client_gmms, cont_idx, cat_idx, jsd_raw, wd_raw,
                      cat_counts, seed, backend, weighted,
                      similarity) -> dict:
    """Raw scores, global category counts and the clients' stacked
    mixtures (``fed_tgan_tpu/federation/init.py:334-354``)."""
    from fed_tgan_torch.federation import sketch as _sketch

    mix_means, mix_stds, mix_weights = _sketch.stack_client_gmms(
        client_gmms, cont_idx, n_components=N_CLUSTERS)
    return {
        "jsd_raw": np.asarray(jsd_raw, dtype=np.float64),
        "wd_raw": np.asarray(wd_raw, dtype=np.float64),
        "cat_counts": [np.asarray(c, dtype=np.float64) for c in cat_counts],
        "mix_means": mix_means, "mix_stds": mix_stds,
        "mix_weights": mix_weights,
        "cont_idx": list(cont_idx), "cat_idx": list(cat_idx),
        "params": {"seed": seed, "backend": backend, "weighted": weighted,
                   "similarity": similarity},
    }


def _restore_from_cache(entry: dict, seed: int, transform_matrices: bool,
                        device, backend: str) -> FederatedInit:
    """A ``FederatedInit`` from a global cache entry: the matrices come
    back byte for byte from the entry, never re-transformed."""
    payload, arrays = entry["payload"], entry["arrays"]
    global_meta = TableMeta.from_json_dict(payload["global_meta"])
    encoders = [CategoryEncoder.fit([str(v) for v in c.i2s])
                for c in global_meta.columns if not c.is_continuous]
    global_gmms: list = [None] * len(global_meta.columns)
    for j, d in payload["gmms"].items():
        global_gmms[int(j)] = ColumnGMM.from_dict(d)
    rows_per_client = [int(r) for r in payload["rows_per_client"]]
    n_clients = len(rows_per_client)
    transformers = [ModeNormalizer(device=device, backend=backend,
                                   seed=seed).refit_with_global(
        global_meta, encoders, global_gmms) for _ in range(n_clients)]
    onboarding = {
        "jsd_raw": arrays["jsd_raw"], "wd_raw": arrays["wd_raw"],
        "cat_counts": [arrays[f"cat_counts{c}"]
                       for c in range(len(encoders))],
        "mix_means": arrays["mix_means"], "mix_stds": arrays["mix_stds"],
        "mix_weights": arrays["mix_weights"],
        "cont_idx": [int(j) for j in payload["cont_idx"]],
        "cat_idx": [int(j) for j in payload["cat_idx"]],
        "params": payload["params"],
    }
    return FederatedInit(
        global_meta=global_meta, encoders=encoders,
        transformers=transformers,
        client_matrices=([arrays[f"m{i}"] for i in range(n_clients)]
                         if transform_matrices else []),
        weights=arrays["weights"], jsd=arrays["jsd"], wd=arrays["wd"],
        rows_per_client=rows_per_client, jsd_raw=arrays["jsd_raw"],
        wd_raw=arrays["wd_raw"], onboarding=onboarding)


def federated_initialize(clients: Sequence[TablePreprocessor], seed: int = 0,
                         weighted: bool = True, device="cuda",
                         similarity: str = "exact",
                         batch_fit: bool = True, cache=None,
                         transform_matrices: bool = True,
                         backend: str = "jax") -> FederatedInit:
    """The init protocol over in-process client shards: harmonize
    categories -> encode -> local mixture fits -> pooled refit and WD
    scores -> transform every shard with the global models -> weights.

    - ``weighted=False`` gives uniform weights;
    - ``similarity`` is :func:`harmonize_continuous`'s ``method``;
    - ``batch_fit`` (default) fits every client's continuous columns in
      one bucketed batch (:func:`~fed_tgan_torch.features.bgm.
      fit_shards`); ``False`` fits client by client, with the same bits;
    - ``cache`` (a directory or an :class:`~fed_tgan_torch.federation.
      init_cache.InitCache`) restores a whole init, or the clients'
      local fits, from content-hashed entries, and stores what it fitted;
    - ``transform_matrices=False`` skips the encoded matrices
      (registration-only onboarding: weights without training data);
    - ``backend`` picks the mixture fits: ``"jax"``, the batched fit on
      ``device``, or ``"sklearn"``, the reference-exact host fit, client
      by client and column by column with ``random_state=seed``
      (``batch_fit`` does not apply).  Everything after the fits runs on
      ``device`` either way, and the cache keeps the two apart.

    ``timings`` holds each phase's seconds, every phase ended on the
    host, each also logged as JAX's ``init_phase`` event dict:
    ``cache_lookup``, then ``cache_restore`` on a global hit, else
    ``category_harmonize``, ``encode``, ``local_bgm_fit``,
    ``continuous_harmonize``, ``refit_transform``,
    ``aggregation_weights`` and ``cache_store``."""
    from fed_tgan_torch.federation.init_cache import (
        InitCache,
        global_key,
        shard_fingerprint,
    )

    device = resolve_device(device)
    if similarity not in ("exact", "sketch"):
        raise ValueError(f"unknown similarity {similarity!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown BGM backend {backend!r}")
    n_clients = len(clients)
    total_rows = int(sum(c.n_rows for c in clients))
    cache = InitCache.resolve(cache)
    timings: dict = {}

    def done(phase: str, t0: float) -> float:
        """Phase ``phase`` ran from ``t0``: its ``init.<phase>`` span and
        its ``init_phase`` event."""
        t1 = time.perf_counter()
        timings[phase] = t1 - t0
        record_span(f"init.{phase}", t0, t1, clients=n_clients)
        _emit_event("init_phase", phase=phase, seconds=round(t1 - t0, 6),
                    clients=n_clients, rows=total_rows)
        return t1

    t = time.perf_counter()
    fps: list = []
    cached: dict = {}
    if cache is not None:
        fps = [shard_fingerprint(c, n_components=N_CLUSTERS,
                                 backend=backend, seed=seed)
               for c in clients]
        gkey = global_key(fps, seed=seed, backend=backend, weighted=weighted,
                          similarity=similarity, matrices=transform_matrices)
        entry = cache.load_global(gkey)
        if entry is None:
            for i, fp in enumerate(fps):
                hit = cache.load_client(fp)
                if hit is not None:
                    cached[i] = hit
        t = done("cache_lookup", t)
        if entry is not None:
            init = _restore_from_cache(entry, seed, transform_matrices,
                                       device, backend)
            done("cache_restore", t)
            init.timings = timings
            cache.flush_events()
            return init

    local_metas = [cached[i]["local_meta"] if i in cached
                   else c.local_meta() for i, c in enumerate(clients)]
    global_meta_dict, encoders, jsd, jsd_raw, cat_counts = (
        harmonize_categories(local_metas, raw=True, counts=True))
    t = done("category_harmonize", t)

    encoded = [c.encode(encoders) for c in clients]
    matrices = [m for m, _, _ in encoded]
    cat_idx = encoded[0][1]
    rows_per_client = [len(m) for m in matrices]
    t = done("encode", t)

    n_cols = matrices[0].shape[1]
    cont_idx = [j for j in range(n_cols) if j not in set(cat_idx)]
    gmms_by_client = {i: hit["gmms"] for i, hit in cached.items()}
    need = [i for i in range(n_clients) if i not in gmms_by_client]
    shards = [[matrices[i][:, j] for j in cont_idx] for i in need]
    if backend == "sklearn":
        fitted = [fit_backend(cols, backend, seed=seed) for cols in shards]
    elif batch_fit:
        fitted = fit_shards(shards, device=device)
    else:
        fitted = [fit_columns(cols, device=device) for cols in shards]
    for i, gl in zip(need, fitted):
        gmms_by_client[i] = dict(zip(cont_idx, gl))
    client_gmms = []
    for i, m in enumerate(matrices):
        tf = ModeNormalizer(device=device, backend=backend, seed=seed).fit(
            m, cat_idx, column_gmms=gmms_by_client[i])
        client_gmms.append(tf.column_gmms)
    if cache is not None:
        for i in need:
            cache.store_client(fps[i], local_metas[i], gmms_by_client[i])
    t = done("local_bgm_fit", t)

    global_gmms, wd, wd_raw = harmonize_continuous(
        client_gmms, rows_per_client, seed=seed, raw=True, device=device,
        method=similarity, backend=backend)
    t = done("continuous_harmonize", t)

    global_meta = TableMeta.from_json_dict(global_meta_dict)
    transformers, client_matrices = [], []
    for i in range(n_clients):
        tf = ModeNormalizer(device=device, backend=backend,
                            seed=seed).refit_with_global(
            global_meta, encoders, global_gmms)
        transformers.append(tf)
        if transform_matrices:
            client_matrices.append(tf.transform(
                matrices[i], rng=np.random.default_rng(seed + i)))
    t = done("refit_transform", t)

    weights = (aggregation_weights(jsd, wd, rows_per_client) if weighted
               else np.full(n_clients, 1.0 / n_clients))
    onboarding = _onboarding_state(client_gmms, cont_idx, cat_idx, jsd_raw,
                                   wd_raw, cat_counts, seed, backend,
                                   weighted, similarity)
    t = done("aggregation_weights", t)
    init = FederatedInit(
        global_meta=global_meta, encoders=encoders, transformers=transformers,
        client_matrices=client_matrices, weights=weights, jsd=jsd, wd=wd,
        rows_per_client=rows_per_client, jsd_raw=jsd_raw, wd_raw=wd_raw,
        timings=timings, onboarding=onboarding)
    if cache is not None:
        payload = {
            "global_meta": global_meta_dict,
            "gmms": {str(j): g.to_dict() for j, g in enumerate(global_gmms)
                     if g is not None},
            "cont_idx": list(cont_idx), "cat_idx": list(cat_idx),
            "rows_per_client": list(map(int, rows_per_client)),
            "params": onboarding["params"],
        }
        arrays = {"jsd": jsd, "wd": wd, "jsd_raw": jsd_raw, "wd_raw": wd_raw,
                  "weights": np.asarray(weights, dtype=np.float64),
                  "mix_means": onboarding["mix_means"],
                  "mix_stds": onboarding["mix_stds"],
                  "mix_weights": onboarding["mix_weights"]}
        for c, vec in enumerate(cat_counts):
            arrays[f"cat_counts{c}"] = vec
        for i, m in enumerate(client_matrices):
            arrays[f"m{i}"] = m
        cache.store_global(gkey, payload, arrays)
        done("cache_store", t)
        cache.flush_events()
    return init
