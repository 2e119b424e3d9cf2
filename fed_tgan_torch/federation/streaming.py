"""Streaming client registration: admit newcomers into a resident init
(counterpart of ``fed_tgan_tpu/federation/streaming.py``).

An :class:`OnboardingSession` wraps a finished :class:`~fed_tgan_torch.
federation.init.FederatedInit` and admits newcomers at the cost of the
newcomers alone:

- the global artifacts stay frozen: the harmonized vocabulary, the global
  mixtures and the encoded layout (the trainer's stacks have its width).
  A newcomer with a category outside the frozen vocabulary is rejected
  (``on_invalid="raise"``) or dropped (``"drop"``): re-harmonizing is a
  full init;
- a newcomer passes the init-payload screen (:func:`_all_finite` over its
  meta and encoded matrix, then over its fitted mixtures);
- its local fits go through the bucketed batch fit and the init cache, as
  a cold init's do;
- its scores are taken against the frozen references (global category
  counts, the residents' pooled mixture CDF, newcomers at pool weight 0)
  and appended to the raw score matrices; the per-column normalization
  and the softmax then rerun over the whole population, so residents'
  scores are never recomputed.

Residents' weights move when newcomers join (the softmax renormalizes);
their encoded matrices and transformers do not.  A rejected newcomer is
journaled as a ``client_dropped`` event; each call journals its
``init_phase`` event and records its ``init.<phase>`` span.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import numpy as np
from scipy.spatial import distance as _sdistance

from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.features.bgm import N_CLUSTERS, fit_backend, fit_shards
from fed_tgan_torch.features.transformer import ModeNormalizer
from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.obs.trace import record_span
from fed_tgan_torch.federation.init import (
    FederatedInit,
    _normalize_per_column,
    aggregation_weights,
)

log = logging.getLogger("fed_tgan_torch.federation")
_MIX = ("mix_means", "mix_stds", "mix_weights")  # the onboarding stacks


def _all_finite(obj) -> bool:
    """Every float reachable in ``obj`` (containers, arrays, plain
    objects) is finite; non-numeric leaves pass (``fed_tgan_tpu/
    federation/distributed.py::_all_finite``)."""
    if isinstance(obj, (bool, int, str, bytes)) or obj is None:
        return True
    if isinstance(obj, float):
        return bool(np.isfinite(obj))
    if isinstance(obj, (np.ndarray, np.generic)):
        return (not np.issubdtype(obj.dtype, np.floating)
                or bool(np.isfinite(obj).all()))
    if isinstance(obj, dict):
        return all(_all_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple, set)):
        return all(_all_finite(v) for v in obj)
    d = getattr(obj, "__dict__", None)
    return _all_finite(d) if d is not None else True


class OnboardingSession:
    """Incremental registration over a resident :class:`FederatedInit`;
    ``session.init`` is the latest snapshot.  Fits and scores run on
    ``device``."""

    def __init__(self, init: FederatedInit, cache=None, device="cuda"):
        if init.onboarding is None:
            raise ValueError(
                "this FederatedInit has no onboarding state (a restored "
                "checkpoint of an older format?); re-run "
                "federated_initialize")
        from fed_tgan_torch.federation.init_cache import InitCache

        self.init = init
        self.cache = InitCache.resolve(cache)
        self.device = resolve_device(device)
        self.timings: dict = {}  # phase -> seconds of the last call

    @property
    def n_clients(self) -> int:
        return len(self.init.rows_per_client)

    def register_clients(self, newcomers: Sequence[TablePreprocessor],
                         on_invalid: str = "raise") -> FederatedInit:
        """Admit a batch of newcomers; returns the extended snapshot.
        ``on_invalid="drop"`` skips a shard that fails the screen instead
        of raising."""
        if on_invalid not in ("raise", "drop"):
            raise ValueError(f"unknown on_invalid policy {on_invalid!r}")
        init, ob = self.init, self.init.onboarding
        params = ob["params"]
        seed = params["seed"]
        cont_idx, cat_idx = ob["cont_idx"], ob["cat_idx"]
        n_res = len(init.rows_per_client)
        t0 = time.perf_counter()
        admitted, matrices, metas = self._screen(newcomers, cat_idx,
                                                 on_invalid)
        if not admitted:
            return init
        gmms_list = self._fit_locals(admitted, matrices, metas, cont_idx,
                                     params)
        jsd_new = self._jsd_raw(metas)
        wd_new, stacks_new = self._wd_raw(gmms_list, cont_idx)
        rows = list(init.rows_per_client) + [len(m) for m in matrices]
        # the frozen layout: each newcomer its own transformer and the
        # transform stream seed + its global index, as a cold init
        transformers = list(init.transformers)
        client_matrices = list(init.client_matrices)
        global_gmms = transformers[0].column_gmms
        for k, m in enumerate(matrices):
            tf = ModeNormalizer(device=self.device).refit_with_global(
                init.global_meta, init.encoders, global_gmms)
            transformers.append(tf)
            if init.client_matrices:
                client_matrices.append(tf.transform(
                    m, rng=np.random.default_rng(seed + n_res + k)))
        # raw scores extended; normalization and softmax rerun over all
        self.init = self._snapshot(
            transformers, client_matrices, rows,
            np.vstack([ob["jsd_raw"], jsd_new]),
            np.vstack([ob["wd_raw"], wd_new]),
            [np.concatenate([ob[k], new]) for k, new in zip(_MIX,
                                                            stacks_new)])
        self._phase("register_clients", t0)
        return self.init

    def score_clients(self, shards: Sequence[TablePreprocessor],
                      alive: Optional[np.ndarray] = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """``(jsd_raw_rows, wd_raw_rows)`` of ``shards`` against the
        frozen references, without changing the session: the screen
        (raising), the cache-aware local fits and the raw scores.
        ``alive`` masks departed residents out of the pool."""
        ob = self.init.onboarding
        admitted, matrices, metas = self._screen(shards, ob["cat_idx"],
                                                 "raise")
        gmms_list = self._fit_locals(admitted, matrices, metas,
                                     ob["cont_idx"], ob["params"])
        wd_rows, _ = self._wd_raw(gmms_list, ob["cont_idx"], alive=alive)
        return self._jsd_raw(metas), wd_rows

    def rescore_client(self, idx: int,
                       shard: TablePreprocessor) -> FederatedInit:
        """Online refit of a drifted resident ``idx``; returns the new
        snapshot.  The frozen layout stays; the client's matrix is
        re-transformed, its local fits redone, its rows of the raw scores
        and of the mixture stacks replaced, and the weights recomputed
        over the population."""
        init, ob = self.init, self.init.onboarding
        if not 0 <= idx < len(init.rows_per_client):
            raise IndexError(f"client index {idx} out of range")
        params = ob["params"]
        t0 = time.perf_counter()
        admitted, matrices, metas = self._screen([shard], ob["cat_idx"],
                                                 "raise")
        gmms_list = self._fit_locals(admitted, matrices, metas,
                                     ob["cont_idx"], params)
        jsd_row = self._jsd_raw(metas)
        wd_row, stacks_new = self._wd_raw(gmms_list, ob["cont_idx"])
        jsd_raw = np.array(ob["jsd_raw"], copy=True)
        wd_raw = np.array(ob["wd_raw"], copy=True)
        jsd_raw[idx] = jsd_row[0]
        wd_raw[idx] = wd_row[0]
        rows = list(init.rows_per_client)
        rows[idx] = len(matrices[0])
        transformers = list(init.transformers)
        client_matrices = list(init.client_matrices)
        tf = ModeNormalizer(device=self.device).refit_with_global(
            init.global_meta, init.encoders, transformers[0].column_gmms)
        transformers[idx] = tf
        if client_matrices:
            client_matrices[idx] = tf.transform(
                matrices[0], rng=np.random.default_rng(params["seed"] + idx))
        mix = [np.array(ob[k], copy=True) for k in _MIX]
        for stack, new in zip(mix, stacks_new):
            stack[idx] = new[0]
        self.init = self._snapshot(transformers, client_matrices, rows,
                                   jsd_raw, wd_raw, mix)
        self._phase("rescore_client", t0)
        return self.init

    def _phase(self, phase: str, t0: float) -> None:
        """Record the call's seconds in :attr:`timings`, its span and its
        ``init_phase`` event."""
        t1 = time.perf_counter()
        self.timings = {phase: t1 - t0}
        record_span(f"init.{phase}", t0, t1, clients=self.n_clients)
        _emit_event("init_phase", phase=phase, seconds=round(t1 - t0, 6),
                    clients=self.n_clients,
                    rows=int(np.sum(self.init.rows_per_client)))

    def _snapshot(self, transformers, client_matrices, rows, jsd_raw,
                  wd_raw, mix) -> FederatedInit:
        """The session's next init: the raw scores normalized per column
        over the whole population, the weights' softmax rerun, the
        mixture stacks ``mix`` in the onboarding state."""
        init, ob = self.init, self.init.onboarding
        n_all = len(rows)
        jsd = _normalize_per_column(jsd_raw, n_all)
        wd = _normalize_per_column(wd_raw, n_all)
        weights = (aggregation_weights(jsd, wd, rows)
                   if ob["params"]["weighted"]
                   else np.full(n_all, 1.0 / n_all))
        return FederatedInit(
            global_meta=init.global_meta, encoders=init.encoders,
            transformers=transformers, client_matrices=client_matrices,
            weights=weights, jsd=jsd, wd=wd, rows_per_client=rows,
            jsd_raw=jsd_raw, wd_raw=wd_raw, timings=dict(init.timings),
            onboarding=dict(ob, jsd_raw=jsd_raw, wd_raw=wd_raw,
                            **dict(zip(_MIX, mix))))

    # ------------------------------------------------------------ internals

    @staticmethod
    def _reject(why: str, on_invalid: str) -> None:
        """Raise, or journal the drop (``on_invalid="drop"``)."""
        if on_invalid == "raise":
            raise ValueError(why)
        log.warning("dropped newcomer: %s", why)
        _emit_event("client_dropped", reason=why, where="register_clients")

    def _screen(self, newcomers, cat_idx, on_invalid):
        """Schema, vocabulary and finiteness screen; returns the admitted
        shards, their encoded matrices and their local metas."""
        init = self.init
        gsig = [(c.name, "continous" if c.is_continuous else "categorical")
                for c in init.global_meta.columns]
        vocabs = [{str(v) for v in c.i2s}
                  for c in init.global_meta.columns if not c.is_continuous]
        admitted, matrices, metas = [], [], []
        for c in newcomers:
            meta = c.local_meta()
            who = f"newcomer {meta.get('name', '?')!r}"
            sig = [(col.get("column_name", ""), col["type"])
                   for col in meta["columns"]]
            if sig != gsig:
                self._reject(f"{who}: schema mismatch with the frozen "
                             "global meta", on_invalid)
                continue
            unseen = []
            cats = [col for col in meta["columns"]
                    if col["type"] == "categorical"]
            for col, vocab in zip(cats, vocabs):
                extra = set(col["i2s"]) - vocab
                if extra:
                    unseen.append((col["column_name"], sorted(extra)[:5]))
            if unseen:
                self._reject(f"{who}: categories outside the frozen global "
                             f"vocabulary {unseen}; re-run full init to "
                             "re-harmonize", on_invalid)
                continue
            matrix, this_cat_idx, _ = c.encode(init.encoders)
            if this_cat_idx != list(cat_idx):
                self._reject(f"{who}: categorical column positions "
                             f"{this_cat_idx} != frozen {cat_idx}",
                             on_invalid)
                continue
            if not (_all_finite(meta) and _all_finite(matrix)):
                self._reject(f"{who}: non-finite init payload", on_invalid)
                continue
            admitted.append(c)
            matrices.append(matrix)
            metas.append(meta)
        return admitted, matrices, metas

    def _fit_locals(self, admitted, matrices, metas, cont_idx, params):
        """The admitted shards' local fits: cache hits, then one bucketed
        batch for the rest (the host fit shard by shard under the
        ``"sklearn"`` backend), stored back into the cache."""
        from fed_tgan_torch.federation.init_cache import shard_fingerprint

        gmms_list: list = [None] * len(admitted)
        fps = []
        if self.cache is not None:
            for k, c in enumerate(admitted):
                fps.append(shard_fingerprint(
                    c, n_components=N_CLUSTERS, backend=params["backend"],
                    seed=params["seed"]))
                hit = self.cache.load_client(fps[k])
                if hit is not None:
                    gmms_list[k] = hit["gmms"]
        need = [k for k in range(len(admitted)) if gmms_list[k] is None]
        if need:
            shards = [[matrices[k][:, j] for j in cont_idx] for k in need]
            if params["backend"] == "sklearn":
                fitted = [fit_backend(cols, "sklearn", seed=params["seed"])
                          for cols in shards]
            else:
                fitted = fit_shards(shards, device=self.device)
            for k, gl in zip(need, fitted):
                gmms_list[k] = dict(zip(cont_idx, gl))
                # a diverged fit is screened like a bad payload
                if not _all_finite({j: g.to_dict()
                                    for j, g in gmms_list[k].items()}):
                    raise ValueError(f"newcomer {k}: non-finite local GMM "
                                     "fit")
                if self.cache is not None:
                    self.cache.store_client(fps[k], metas[k], gmms_list[k])
        if self.cache is not None:
            self.cache.flush_events()
        return gmms_list

    def _jsd_raw(self, metas) -> np.ndarray:
        """Raw JSD of each shard against the frozen global counts."""
        init, ob = self.init, self.init.onboarding
        out = np.zeros((len(metas), len(ob["cat_idx"])))
        for r, meta in enumerate(metas):
            for cursor, j in enumerate(ob["cat_idx"]):
                counts = ob["cat_counts"][cursor]
                enc = init.encoders[cursor]
                vec = np.zeros_like(counts)
                i2s = meta["columns"][j]["i2s"]
                codes = enc.transform([str(k) for k in i2s])
                for code, count in zip(codes, i2s.values()):
                    vec[int(code)] = count
                out[r, cursor] = _sdistance.jensenshannon(counts, vec)
        return np.nan_to_num(out, nan=0.0)

    def _wd_raw(self, gmms_list, cont_idx, alive=None):
        """Raw WD of each shard against the frozen resident pool: one
        sketch where the residents carry the pool weights (departed ones
        masked by ``alive``) and every scored shard weight 0."""
        from fed_tgan_torch.federation import sketch as _sketch

        ob = self.init.onboarding
        width = max(cont_idx, default=-1) + 1
        client_gmms = [[g.get(j) for j in range(width)] for g in gmms_list]
        stacks_new = _sketch.stack_client_gmms(client_gmms, cont_idx,
                                               n_components=N_CLUSTERS)
        stacks = tuple(np.concatenate([ob[k], new])
                       for k, new in zip(_MIX, stacks_new))
        n_res = ob["mix_means"].shape[0]
        omega = np.concatenate([
            _sketch.live_omega(self.init.rows_per_client, alive),
            np.zeros(len(gmms_list))])
        wd_all = _sketch.wd_sketch(None, None, cont_idx, omega=omega,
                                   stacks=stacks, device=self.device)
        return wd_all[n_res:], stacks_new

