"""The federation's init across processes, over the port's transport
(counterpart of ``fed_tgan_tpu/federation/distributed.py``).

The protocol of the in-process :func:`~fed_tgan_torch.federation.init.
federated_initialize`, with real process separation, mirroring the
reference's RPC choreography (reference Server/dtds/distributed.py:
866-874):

  server                          clients (rank 1..N)
  ------                          -------------------
  gather local metas         <--  send local_meta()
  harmonize categories
  broadcast meta+encoders    -->  encode data, fit local mixtures
  gather (gmms, n_rows)      <--  send the mixtures
  harmonize continuous
  broadcast global GMMs      -->  refit the transformer, transform data
  gather one-hot counts      <--  send the shard's condition counts
  compute weights
  broadcast weights          -->  ready to train

Rank r encodes its shard with client r - 1's stream (``seed + r - 1``), as
the in-process init does, and a mixture fit's bits do not depend on the
columns it is batched with (:func:`~fed_tgan_torch.features.bgm.
fit_columns`), so a world of processes holds the bits of the in-process
init.  Each participant fits on its own ``device``, the server refits the
pooled mixtures on its own.
"""

from __future__ import annotations

import logging

import numpy as np

from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.schema import TableMeta
from fed_tgan_torch.features.transformer import ModeNormalizer
from fed_tgan_torch.federation.init import (
    aggregation_weights,
    harmonize_categories,
    harmonize_continuous,
)
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.transport import ClientTransport, ServerTransport
from fed_tgan_torch.train.sampler import CondSampler

log = logging.getLogger("fed_tgan_torch.federation")


def _check_floor(transport: ServerTransport, phase: str,
                 min_clients: int | None, newly_dropped: list[int]) -> None:
    if newly_dropped:
        log.warning("init %s: dropped client rank(s) %s; continuing with %d "
                    "survivors", phase, newly_dropped,
                    len(transport.live_ranks()))
    floor = transport.n_clients if min_clients is None else min_clients
    live = len(transport.live_ranks())
    if live < floor or live == 0:
        raise RuntimeError(
            f"aborting during init ({phase}): {live} live clients is below "
            f"min_clients={floor} (dropped: {sorted(transport.dropped)})")


def _gather_phase(transport: ServerTransport, phase: str,
                  min_clients: int | None) -> dict:
    """One fault-tolerant gather: ``{rank: payload}`` over the ranks that
    answered.  With ``min_clients`` set a missing client is dropped
    (weights later renormalized over the survivors); without it any drop
    aborts cleanly, the reference's all-or-nothing contract minus the
    hang."""
    results, newly_dropped = transport.gather_surviving()
    _check_floor(transport, phase, min_clients, newly_dropped)
    return results


def _all_finite(obj) -> bool:
    """Every float reachable in ``obj`` (containers, arrays, plain
    objects) is finite; non-numeric leaves pass."""
    if isinstance(obj, (bool, int, str, bytes)) or obj is None:
        return True
    if isinstance(obj, float):
        return bool(np.isfinite(obj))
    if isinstance(obj, (np.ndarray, np.generic)):
        return not np.issubdtype(obj.dtype, np.floating) or bool(
            np.isfinite(obj).all())
    if isinstance(obj, dict):
        return all(_all_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple, set)):
        return all(_all_finite(v) for v in obj)
    d = getattr(obj, "__dict__", None)
    return _all_finite(d) if d is not None else True


def _validate_gathered(transport: ServerTransport, phase: str,
                       min_clients: int | None, results: dict) -> dict:
    """Drop every rank whose payload holds a NaN or an Inf (a diverged or
    hostile local fit must not poison the global artifacts), like a dead
    socket and under the same ``min_clients`` floor."""
    bad = [r for r in sorted(results) if not _all_finite(results[r])]
    for r in bad:
        transport.mark_dropped(r, f"non-finite payload in init {phase}")
        del results[r]
    _check_floor(transport, phase + "-validate", min_clients, bad)
    return results


def _broadcast_phase(transport: ServerTransport, obj, phase: str,
                     min_clients: int | None) -> None:
    newly_dropped = transport.broadcast_surviving(obj)
    _check_floor(transport, phase, min_clients, newly_dropped)


def server_initialize(transport: ServerTransport, seed: int = 0,
                      weighted: bool = True, run_name: str | None = None,
                      min_clients: int | None = None, device="cuda",
                      similarity: str = "exact",
                      backend: str = "jax") -> dict:
    """Drive the init protocol from rank 0; returns the global artifacts
    (``global_meta``, ``encoders``, ``global_gmms``, ``weights``, ``jsd``,
    ``wd``, ``rows_per_client``, ``cond_counts``, ``live_ranks``,
    ``dropped``).

    ``run_name`` rides along with the meta so every client labels its
    artifacts as the server does.  ``min_clients`` enables graceful
    degradation: a client that misses its deadline, dies or sends a
    non-finite payload is dropped and the weights are computed over the
    survivors; below the floor the run aborts.  ``None`` requires every
    client.  ``similarity`` is :func:`harmonize_continuous`'s method; the
    pooled refit runs on ``device`` (``backend="jax"``) or on the host
    (``"sklearn"``)."""
    metas = _gather_phase(transport, "gather-metas", min_clients)
    meta_ranks = sorted(metas)
    global_meta_dict, encoders, jsd = harmonize_categories(
        [metas[r] for r in meta_ranks])
    jsd_by_rank = dict(zip(meta_ranks, np.asarray(jsd)))
    _broadcast_phase(transport, {"meta": global_meta_dict,
                                 "encoders": encoders, "run_name": run_name},
                     "broadcast-meta", min_clients)

    infos = _validate_gathered(
        transport, "gather-gmms", min_clients,
        _gather_phase(transport, "gather-gmms", min_clients))
    info_ranks = sorted(infos)
    rows_by_rank = {r: infos[r]["rows"] for r in info_ranks}
    global_gmms, wd = harmonize_continuous(
        [infos[r]["gmms"] for r in info_ranks],
        [rows_by_rank[r] for r in info_ranks], seed=seed, device=device,
        method=similarity, backend=backend)
    wd_by_rank = dict(zip(info_ranks, np.asarray(wd)))
    _broadcast_phase(transport, {"gmms": global_gmms}, "broadcast-gmms",
                     min_clients)

    # pooled conditional-sampling counts: the reference server rebuilds
    # its Cond on the full table (distributed.py:565-580); the clients
    # send additive one-hot counts instead of rows
    counts = _validate_gathered(
        transport, "gather-cond-counts", min_clients,
        _gather_phase(transport, "gather-cond-counts", min_clients))
    cond_counts = sum(counts[r] for r in sorted(counts))

    # the weights run over the ranks that survived every phase
    final_ranks = [r for r in transport.live_ranks() if r in wd_by_rank]
    jsd_live = np.asarray([jsd_by_rank[r] for r in final_ranks])
    wd_live = np.asarray([wd_by_rank[r] for r in final_ranks])
    rows = [rows_by_rank[r] for r in final_ranks]
    weights = (aggregation_weights(jsd_live, wd_live, rows) if weighted
               else np.full(len(rows), 1.0 / len(rows)))
    _broadcast_phase(transport, {"weights": weights, "rows_per_client": rows,
                                 "cond_counts": cond_counts,
                                 "live_ranks": final_ranks},
                     "broadcast-weights", min_clients)
    return {
        "global_meta": TableMeta.from_json_dict(global_meta_dict),
        "encoders": encoders,
        "global_gmms": global_gmms,
        "weights": weights,
        "jsd": jsd_live,
        "wd": wd_live,
        "rows_per_client": rows,
        "cond_counts": cond_counts,
        "live_ranks": final_ranks,
        "dropped": sorted(transport.dropped),
    }


def client_initialize(transport: ClientTransport,
                      preprocessor: TablePreprocessor, seed: int = 0,
                      device="cuda", backend: str = "jax") -> dict:
    """Take part in the init protocol as ``transport.rank``; returns this
    shard's artifacts (``global_meta``, ``encoders``, ``transformer``,
    ``matrix``, ``weights``, ``rows_per_client``, ``cond_counts``,
    ``run_name``).  ``backend`` picks the local fit as
    :class:`~fed_tgan_torch.features.transformer.ModeNormalizer` does."""
    transport.send_obj(preprocessor.local_meta())

    msg = transport.recv_obj()
    global_meta = TableMeta.from_json_dict(msg["meta"])
    encoders = msg["encoders"]
    matrix, cat_idx, _ = preprocessor.encode(encoders)
    local_tf = ModeNormalizer(device=device, backend=backend,
                              seed=seed).fit(matrix, cat_idx)
    transport.send_obj({"gmms": local_tf.column_gmms, "rows": len(matrix)})

    global_gmms = transport.recv_obj()["gmms"]
    transformer = ModeNormalizer(device=device, backend=backend,
                                 seed=seed).refit_with_global(
        global_meta, encoders, global_gmms)
    encoded = transformer.transform(
        matrix, rng=np.random.default_rng(seed + transport.rank - 1))
    spec = SegmentSpec.from_output_info(transformer.output_info)
    transport.send_obj(CondSampler.count_matrix(encoded, spec))

    final = transport.recv_obj()
    return {
        "global_meta": global_meta,
        "encoders": encoders,
        "transformer": transformer,
        "matrix": encoded,
        "weights": final["weights"],
        "rows_per_client": final["rows_per_client"],
        "cond_counts": final["cond_counts"],
        "run_name": msg.get("run_name"),
    }
