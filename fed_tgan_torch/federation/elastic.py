"""Elastic federation: membership churn and drift as handled events
(counterpart of ``fed_tgan_tpu/federation/elastic.py``).

- **Joins** go through :meth:`OnboardingSession.register_clients` (frozen
  layout, cache-aware local fits, the softmax rerun over the grown
  population) and land in the trainer's padded slots through
  :meth:`FederatedTrainer.admit_clients`.
- **Departures** go through ``drop_client``: steps to 0, the survivors'
  weights renormalized.
- **Drift** is data, not corruption.  A ``drift:`` fault swaps a client's
  shard silently; every ``detect_every`` rounds a detection window
  rescores every live client's current shard against its previous
  window's scores (the sketch scorer; unchanged shards are cache hits
  when the session has a cache), refits the drifted clients online
  (``rescore_client``), recomputes the weights over the live population
  in the same window, and feeds drift that persists into the quarantine
  strikes.  Rolling back is never the remedy: an old model cannot undrift
  a shard.

``client_left``, ``drift_alarm``, ``drift_window`` and ``quarantine``
(``test="drift"``) events are journaled with the JAX events' fields, and
kept as dicts (``type`` and fields) in :attr:`ElasticFederation.events`
beside the trainer's ``client_joined`` events of each join.  A detection
window is the ``elastic.detect`` span.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Sequence

import numpy as np

from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.federation.init import recompute_weights
from fed_tgan_torch.federation.streaming import OnboardingSession
from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.obs.trace import span as _span

log = logging.getLogger("fed_tgan_torch.federation")


@dataclasses.dataclass
class DriftConfig:
    """The detection windows' policy.  ``jsd_alarm`` is an absolute rise
    of a raw per-column JSD (scored against the frozen global counts);
    ``wd_alarm_rel`` a rise of the sketch WD in units of the population's
    median baseline WD of the column (the pool moves whenever a member
    leaves or refits).  ``detect_every=0`` turns the probe off."""

    detect_every: int = 5        # rounds between detection windows
    jsd_alarm: float = 0.05      # absolute per-column raw-JSD rise
    wd_alarm_rel: float = 3.0    # WD rise in population-median-WD units
    refit: bool = True           # online refit + weight recompute on alarm


def clone_with_frame(client: TablePreprocessor, table: dict
                     ) -> TablePreprocessor:
    """A preprocessor of the same knobs around a new raw ``table``.
    Ingest extends ``categorical_columns`` with the date columns and their
    parts, so only the named categoricals of the raw table that are not
    date columns are passed on (they extend again on construction)."""
    cats = [c for c in client.categorical_columns
            if c in client.table and c not in client.date_formats]
    return TablePreprocessor(
        table=table, name=client.name, categorical_columns=cats,
        non_negative_columns=list(client.non_negative_columns),
        date_formats=dict(client.date_formats),
        target_column=client.target_column,
        problem_type=client.problem_type,
        selected_columns=client.selected_columns)


class ElasticFederation:
    """Membership and drift over a live ``FederatedTrainer``: the trainer
    owns the device state, the :class:`OnboardingSession` the similarity
    state, and this class keeps them in step.  ``clients[i]`` is client
    i's current raw shard (drift swaps it); joins append, so indices stay
    those of the trainer and the init."""

    def __init__(self, trainer, session: OnboardingSession,
                 clients: Sequence[TablePreprocessor], watchdog=None,
                 config: Optional[DriftConfig] = None):
        if len(clients) != trainer.n_clients:
            raise ValueError(
                f"{len(clients)} client shards for a {trainer.n_clients}-"
                "client trainer; pass the same population both got")
        self.trainer = trainer
        self.session = session
        self.clients: list = list(clients)
        self.watchdog = watchdog
        self.cfg = config or DriftConfig()
        self.windows: list = []   # one record per detection window
        self.events: list = []    # the journal's events, as dicts
        self._applied_events: set = set()
        # per client (jsd_row, wd_row) of the last window, seeded from the
        # onboarding scores: drift is window over window
        self._baseline: dict = {}
        # a membership change moved the pooled WD reference under every
        # survivor: the next window alarms on JSD alone
        self._pool_changed = False
        self.trainer.init = self.session.init

    def _emit(self, event: dict) -> None:
        _emit_event(**event)
        self.events.append(event)

    # ------------------------------------------------------------- membership

    @property
    def population(self) -> int:
        return self.trainer.n_clients

    def _alive_mask(self) -> np.ndarray:
        alive = np.ones(self.population, dtype=bool)
        if self.trainer.dropped_clients:
            alive[sorted(self.trainer.dropped_clients)] = False
        return alive

    def join(self, newcomers: Sequence[TablePreprocessor],
             reason: str = "join") -> None:
        """Admit newcomers between rounds: registration, then the
        trainer's slots."""
        new_init = self.session.register_clients(newcomers)
        self.trainer.admit_clients(new_init, reason=reason)
        for event in self.trainer.last_admission:
            self.events.append(event)
        self.clients.extend(newcomers)
        self._pool_changed = True

    def leave(self, idx: int, reason: str = "scripted departure") -> None:
        """Departure through ``drop_client``; the survivors renormalize."""
        self._emit({"type": "client_left", "client": int(idx),
                    "round": int(self.trainer.completed_epochs),
                    "reason": reason,
                    "survivors": self.population
                    - len(self.trainer.dropped_clients) - 1})
        self.trainer.drop_client(idx, reason)
        self._pool_changed = True

    def apply_drift(self, idx: int, shift: float, seed: int = 0) -> None:
        """Silently swap client ``idx``'s shard for a drifted one
        (:func:`~fed_tgan_torch.testing.faults.drift_frame`), encoded with
        the frozen encoders and transformed by the client's existing
        transformer: no similarity state moves, the next window must
        catch it."""
        from fed_tgan_torch.testing import faults as _faults

        if not 0 <= idx < self.population:
            raise IndexError(f"client index {idx} out of range")
        cur = self.clients[idx]
        drifted = clone_with_frame(
            cur, _faults.drift_frame(cur.table, shift=shift, seed=seed))
        matrix, _, _ = drifted.encode(self.session.init.encoders)
        encoded = self.session.init.transformers[idx].transform(
            matrix, rng=np.random.default_rng(seed + idx))
        self.trainer.update_client_shard(idx, encoded)
        self.clients[idx] = drifted
        log.info("drift applied to client %d (shift=%s, seed=%d)", idx,
                 shift, seed)

    # ------------------------------------------------------------- detection

    def detect(self, round_idx: Optional[int] = None) -> dict:
        """One detection window (``fed_tgan_tpu/federation/elastic.py:
        196-352``): rescore every live client's current shard, alarm on
        a rise over its last window, refit and reweight the drifted in
        this window, charge sustained drift as quarantine strikes.
        Returns the window's record (also in :attr:`windows`)."""
        if round_idx is None:
            round_idx = int(self.trainer.completed_epochs)
        with _span("elastic.detect", round=round_idx,
                   clients=int(self._alive_mask().sum())):
            return self._detect(round_idx)

    def _detect(self, round_idx: int) -> dict:
        alive = self._alive_mask()
        live = np.nonzero(alive)[0]
        if live.size == 0:
            raise RuntimeError("no live clients to score")
        ob = self.session.init.onboarding
        jsd_rows, wd_rows = self.session.score_clients(
            [self.clients[i] for i in live], alive=alive)
        ob_jsd = np.asarray(ob["jsd_raw"], dtype=np.float64)
        ob_wd = np.asarray(ob["wd_raw"], dtype=np.float64)
        base = [self._baseline.get(int(c), (ob_jsd[c], ob_wd[c]))
                for c in live]
        base_jsd = np.stack([b[0] for b in base])
        base_wd = np.stack([b[1] for b in base])
        jsd_rise = ((jsd_rows - base_jsd).max(axis=1) if jsd_rows.shape[1]
                    else np.zeros(len(live)))
        # per-column population scale: a pool shift that moves every
        # client's WD alike is not everyone drifting
        if wd_rows.shape[1]:
            scale = np.maximum(np.median(np.abs(base_wd), axis=0), 1e-6)
            wd_rise = ((wd_rows - base_wd) / scale).max(axis=1)
        else:
            wd_rise = np.zeros(len(live))
        wd_suppressed = self._pool_changed
        hit = jsd_rise > self.cfg.jsd_alarm
        if not wd_suppressed:
            hit = hit | (wd_rise > self.cfg.wd_alarm_rel)
        self._pool_changed = False
        for k, c in enumerate(live):
            self._baseline[int(c)] = (jsd_rows[k], wd_rows[k])
        drifted = [int(live[k]) for k in np.nonzero(hit)[0]]
        for k in np.nonzero(hit)[0]:
            self._emit({"type": "drift_alarm", "client": int(live[k]),
                        "round": round_idx,
                        "jsd_rise": round(float(jsd_rise[k]), 6),
                        "wd_rise": round(float(wd_rise[k]), 6)})
        if drifted and self.cfg.refit:
            for c in drifted:
                new_init = self.session.rescore_client(c, self.clients[c])
                self.trainer.update_client_shard(
                    c, new_init.client_matrices[c])
            ob = self.session.init.onboarding
            self.trainer.update_weights(recompute_weights(
                ob["jsd_raw"], ob["wd_raw"],
                self.session.init.rows_per_client, alive=alive,
                weighted=ob["params"]["weighted"]))
            self.trainer.init = self.session.init
            # the refit moved the pool: every survivor's baseline
            # re-anchors on the post-refit pool
            jsd2, wd2 = self.session.score_clients(
                [self.clients[i] for i in live], alive=alive)
            for k, c in enumerate(live):
                self._baseline[int(c)] = (jsd2[k], wd2[k])
        sustained = (self.watchdog.observe_drift(round_idx, drifted)
                     if self.watchdog is not None else [])
        evicted = []
        for c in sustained:
            if c in self.trainer.dropped_clients:
                continue
            self.trainer._strikes[c] += 1
            strikes = int(self.trainer._strikes[c])
            self._emit({"type": "quarantine", "client": int(c), "rounds": 1,
                        "first": round_idx, "last": round_idx,
                        "strikes": strikes, "test": "drift"})
            if strikes >= self.trainer.quarantine_strikes:
                self.leave(c, f"sustained drift across "
                              f"{self.watchdog.cfg.drift_patience}+ windows "
                              f"(strike limit "
                              f"{self.trainer.quarantine_strikes})")
                evicted.append(int(c))
        record = {
            "round": round_idx,
            "population": int(self.population),
            "live": int(alive.sum() - len(evicted)),
            "scored": int(live.size),
            "alarms": len(drifted),
            "drifted": drifted,
            "sustained": [int(c) for c in sustained],
            "evicted": evicted,
            "max_jsd_rise": round(float(jsd_rise.max(initial=0.0)), 6),
            "max_wd_rise": round(float(wd_rise.max(initial=0.0)), 6),
            # the refit and the recompute run in this same window
            "recompute_lag_rounds": (0 if (drifted and self.cfg.refit)
                                     else None),
            "wd_suppressed": True if wd_suppressed else None,
        }
        self.windows.append(record)
        self._emit({"type": "drift_window",
                    **{k: v for k, v in record.items() if v is not None}})
        return record

    # -------------------------------------------------------------- training

    def run(self, epochs: int, plan=None, fit_kwargs: Optional[dict] = None,
            ckpt_dir: Optional[str] = None,
            newcomer_factory: Optional[Callable[[int, int], list]] = None,
            on_rollback: Optional[Callable] = None):
        """Train ``epochs`` rounds: the plan's ``join:``/``leave:``/
        ``drift:`` events at their rounds, a detection window every
        ``detect_every`` rounds, training in segments between them.
        ``plan`` defaults to the active fault plan;
        ``newcomer_factory(count, round)`` supplies raw shards for joins.
        With a watchdog and ``ckpt_dir`` each segment runs under
        :func:`~fed_tgan_torch.train.watchdog.fit_with_watchdog`; a churn
        event applies exactly once even when a rollback re-traverses its
        round.  Returns the trainer (a rollback replaces it)."""
        from fed_tgan_torch.testing.faults import active_plan

        if plan is None:
            plan = active_plan()
        churn = plan is not None and plan.has_churn()
        fit_kwargs = dict(fit_kwargs or {})
        start = int(self.trainer.completed_epochs)
        target = start + int(epochs)
        de = int(self.cfg.detect_every)
        while self.trainer.completed_epochs < target:
            e = int(self.trainer.completed_epochs)
            for ev in (plan.churn_events(e) if churn else ()):
                key = (e,) + tuple(ev)
                if key in self._applied_events:
                    continue  # a rollback's re-traversal: applied already
                self._applied_events.add(key)
                if ev[0] == "join":
                    if newcomer_factory is None:
                        raise ValueError(
                            f"fault plan schedules a join at round {e + 1} "
                            "but no newcomer_factory was given")
                    self.join(newcomer_factory(int(ev[1]), e))
                elif ev[0] == "leave":
                    self.leave(int(ev[1]),
                               f"scripted departure at round {e + 1}")
                else:
                    self.apply_drift(int(ev[1]), float(ev[2]), seed=e)
            if (de and e > start and (e - start) % de == 0
                    and ("window", e) not in self._applied_events):
                self._applied_events.add(("window", e))
                self.detect(e)
            # the segment ends at the next churn round, the next window or
            # the target, whichever comes first
            edges = [target]
            nxt = plan.next_churn_round(e + 1) if churn else None
            if nxt is not None:
                edges.append(nxt)
            if de:
                edges.append(e + de - (e - start) % de)
            seg = max(e + 1, min(edges)) - e
            if self.watchdog is not None and ckpt_dir:
                from fed_tgan_torch.train.watchdog import fit_with_watchdog

                def _rb(tr):
                    self._on_rollback(tr)
                    if on_rollback is not None:
                        on_rollback(tr)

                self.trainer = fit_with_watchdog(
                    self.trainer, seg, self.watchdog, ckpt_dir,
                    fit_kwargs=dict(fit_kwargs), on_rollback=_rb)
            else:
                self.trainer.fit(seg, **fit_kwargs)
        return self.trainer

    def _on_rollback(self, trainer) -> None:
        """Re-sync to the restored trainer: the session's similarity
        snapshot reverts with the checkpointed init; the raw shards stay
        current (drift before the checkpoint is re-detected)."""
        self.trainer = trainer
        self.session.init = trainer.init
