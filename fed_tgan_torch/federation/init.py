"""The federation's one-time init: category harmonization, pooled mixture
refit, similarity weights
(counterpart of ``fed_tgan_tpu/federation/init.py:51-307, 414-639``).

1. :func:`harmonize_categories`: merge the clients' category frequency
   dicts, order each global vocabulary by total frequency, fit one encoder
   per categorical column, and score every client per column by the
   Jensen-Shannon distance between its frequencies and the global ones.
2. :func:`harmonize_continuous` (the reference's exact protocol): per
   continuous column, a rows-proportional Monte-Carlo sample from every
   client's mixture, pooled; every client scored by the Wasserstein
   distance of its sample to the pool; one global mixture refitted on the
   pool (on the device, all columns in one batch).
3. :func:`aggregation_weights`: ``softmax((1 - d_i / sum(d)) * n_i / N)``
   with ``d_i`` the client's summed normalized JSD and WD scores.

Distances use scipy's ``jensenshannon`` and ``wasserstein_distance``, as the
JAX package does.  The sketch similarity, the init cache and the streaming
onboarding state are not ported yet.
"""

from __future__ import annotations

import copy
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
from fed_tgan_torch.features.bgm import N_CLUSTERS, WEIGHT_EPS, fit_columns
from fed_tgan_torch.features.transformer import ModeNormalizer


def _normalize_per_column(dist: np.ndarray, n_clients: int) -> np.ndarray:
    """Each column's distances over their sum across clients; an all-zero
    column becomes ``1 / n_clients`` for everyone."""
    dist = dist.astype(np.float64).copy()
    col_sum = dist.sum(axis=0)
    nonzero = col_sum != 0
    dist[:, nonzero] = dist[:, nonzero] / col_sum[nonzero]
    dist[:, ~nonzero] = 1.0 / n_clients
    return dist


def harmonize_categories(local_metas: Sequence[dict], raw: bool = False):
    """``(global_meta_dict, encoders, jsd)``: the first client's meta with
    each categorical ``i2s`` replaced by the frequency-ordered global
    vocabulary (ties in merge order), one encoder per categorical column,
    and the (n_clients, n_categorical) normalized JSD scores.  ``raw=True``
    appends the unnormalized scores.  Columns are merged by position, so
    every client must present the same names and kinds in the same order."""
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
        for ci, meta in enumerate(local_metas):
            vec = np.zeros(len(ordered))
            for key, count in meta["columns"][col_idx]["i2s"].items():
                vec[codes[key]] = count
            jsd[ci, cursor] = _sdistance.jensenshannon(vec_global, vec)
    jsd = np.nan_to_num(jsd, nan=0.0)
    if raw:
        return base, encoders, _normalize_per_column(jsd, n_clients), jsd
    return base, encoders, _normalize_per_column(jsd, n_clients)


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
                         device="cuda"):
    """``(global_gmms, wd)``: ``client_gmms[i][j]`` is client i's mixture
    of column j (None when discrete); ``global_gmms[j]`` the mixture
    refitted on the pooled sample, ``wd`` the (n_clients, n_continuous)
    normalized Wasserstein scores.  ``raw=True`` appends the unnormalized
    scores."""
    n_clients = len(client_gmms)
    samples = pooled_samples(client_gmms, rows_per_client, seed)
    wd = np.zeros((n_clients, len(samples)))
    pooled_cols = []
    for cursor, per_client in enumerate(samples.values()):
        pooled = np.concatenate(per_client)
        for i in range(n_clients):
            wd[i, cursor] = wasserstein_distance(pooled, per_client[i])
        pooled_cols.append(pooled)
    global_gmms: list = [None] * len(client_gmms[0])
    if pooled_cols:
        refits = fit_columns(pooled_cols, n_components, eps, device=device)
        for j, gmm in zip(samples, refits):
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

    @property
    def output_info(self):
        return self.transformers[0].output_info


def federated_initialize(clients: Sequence[TablePreprocessor], seed: int = 0,
                         weighted: bool = True,
                         device="cuda") -> FederatedInit:
    """The init protocol over in-process client shards: harmonize
    categories -> encode -> local mixture fits (every client's continuous
    columns in one batch on ``device``) -> pooled refit and WD scores ->
    transform every shard with the global models -> weights.
    ``weighted=False`` gives uniform weights.  ``timings`` holds each
    phase's seconds (every phase ends on the host)."""
    device = resolve_device(device)
    n_clients = len(clients)
    timings: dict = {}

    def done(phase: str, t0: float) -> float:
        t1 = time.perf_counter()
        timings[phase] = t1 - t0
        return t1

    t = time.perf_counter()
    local_metas = [c.local_meta() for c in clients]
    global_meta_dict, encoders, jsd, jsd_raw = harmonize_categories(
        local_metas, raw=True)
    t = done("category_harmonize", t)

    encoded = [c.encode(encoders) for c in clients]
    matrices = [m for m, _, _ in encoded]
    cat_idx = encoded[0][1]
    rows_per_client = [len(m) for m in matrices]
    t = done("encode", t)

    n_cols = matrices[0].shape[1]
    cont_idx = [j for j in range(n_cols) if j not in set(cat_idx)]
    fitted = fit_columns([m[:, j] for m in matrices for j in cont_idx],
                         device=device)
    client_gmms = []
    for i, m in enumerate(matrices):
        mine = fitted[i * len(cont_idx):(i + 1) * len(cont_idx)]
        tf = ModeNormalizer(device=device).fit(
            m, cat_idx, column_gmms=dict(zip(cont_idx, mine)))
        client_gmms.append(tf.column_gmms)
    t = done("local_bgm_fit", t)

    global_gmms, wd, wd_raw = harmonize_continuous(
        client_gmms, rows_per_client, seed=seed, raw=True, device=device)
    t = done("continuous_harmonize", t)

    global_meta = TableMeta.from_json_dict(global_meta_dict)
    transformers, client_matrices = [], []
    for i in range(n_clients):
        tf = ModeNormalizer(device=device).refit_with_global(
            global_meta, encoders, global_gmms)
        transformers.append(tf)
        client_matrices.append(
            tf.transform(matrices[i], rng=np.random.default_rng(seed + i)))
    t = done("refit_transform", t)

    weights = (aggregation_weights(jsd, wd, rows_per_client) if weighted
               else np.full(n_clients, 1.0 / n_clients))
    done("aggregation_weights", t)
    return FederatedInit(
        global_meta=global_meta, encoders=encoders, transformers=transformers,
        client_matrices=client_matrices, weights=weights, jsd=jsd, wd=wd,
        rows_per_client=rows_per_client, jsd_raw=jsd_raw, wd_raw=wd_raw,
        timings=timings)
