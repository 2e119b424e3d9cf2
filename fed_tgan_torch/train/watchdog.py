"""Training-health watchdog with automatic rollback
(counterpart of ``fed_tgan_tpu/train/watchdog.py:43-130, 159-290``).

:class:`TrainingWatchdog` reads what the trainer already produces, the
per-round losses (``FederatedTrainer.fit(health_cb=)``) and the similarity
monitor's Avg_JSD, and raises :class:`WatchdogAlarm` on

- a non-finite loss the update gate did not contain (a quarantined
  client's losses are excused);
- a loss explosion: any |loss| above ``loss_threshold``;
- a sustained similarity regression: ``similarity_patience`` consecutive
  reads worse than ``similarity_factor`` x the best seen.

:func:`fit_with_watchdog` turns an alarm into a rollback: it reloads the
newest valid checkpoint (the next-older one when the restored run alarms
again within a round), multiplies the learning rate by ``lr_reanneal``
and goes on, at most ``max_rollbacks`` times before it aborts with
``RuntimeError``.  :meth:`TrainingWatchdog.observe_drift` takes the
elastic federation's drift windows and names the clients whose drift
persisted ``drift_patience`` windows; it never raises (rolling the model
back cannot undrift a shard).  Alarms and rollbacks are logged as
warnings, journaled (``watchdog_alarm``, ``watchdog_rollback``), counted
(``fed_tgan_watchdog_alarms_total``, ``fed_tgan_watchdog_rollbacks_total``)
and shown on ``/healthz``, all from host bookkeeping.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np

from fed_tgan_torch.obs.exporter import get_health
from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.obs.registry import counter as _metric_counter

log = logging.getLogger("fed_tgan_torch.watchdog")

_ALARMS_TOTAL = _metric_counter(
    "fed_tgan_watchdog_alarms_total", "training-health alarms raised")
_ROLLBACKS_TOTAL = _metric_counter(
    "fed_tgan_watchdog_rollbacks_total", "automatic checkpoint rollbacks")


class WatchdogAlarm(RuntimeError):
    """Training health violated; the caller should roll back or abort."""


@dataclasses.dataclass
class WatchdogConfig:
    loss_threshold: float = 100.0     # |loss| beyond this = explosion
    similarity_factor: float = 2.0    # vs the best avg_jsd seen so far
    similarity_patience: int = 3      # consecutive bad monitor reads
    max_rollbacks: int = 2            # rollbacks before a clean abort
    lr_reanneal: float = 0.5          # lr multiplier on each rollback
    drift_patience: int = 2           # consecutive drifted windows/client


class TrainingWatchdog:
    """Stateful health checks; one instance spans rollbacks."""

    def __init__(self, config: Optional[WatchdogConfig] = None):
        self.cfg = config or WatchdogConfig()
        self.rollbacks = 0
        self._best_jsd: Optional[float] = None
        self._bad_streak = 0
        self._drift_streaks: dict = {}

    def reset_window(self) -> None:
        """Forget the in-flight streaks (after a rollback); the rollback
        count bounds the whole run and stays."""
        self._bad_streak = 0
        self._drift_streaks.clear()

    def health_cb(self, first_round: int, metrics: dict) -> None:
        """Inspect the host metric arrays of the rounds from
        ``first_round`` ((rounds, n_clients) each); raise on an explosion.
        A ``quarantined`` entry excuses the same-shaped losses it marks; a
        ``cohort`` entry (the sampled clients' ids) is bookkeeping, not
        health."""
        q = None
        if "quarantined" in metrics:
            q = np.asarray(metrics["quarantined"]) > 0
        for name, leaf in metrics.items():
            if name in ("quarantined", "cohort"):
                continue
            arr = np.asarray(leaf)
            bad = ~np.isfinite(arr) | (np.abs(arr) > self.cfg.loss_threshold)
            if q is not None and bad.shape == q.shape:
                bad = bad & ~q
            if bad.any():
                r = first_round + int(
                    np.argmax(bad.reshape(arr.shape[0], -1).any(axis=1)))
                raise WatchdogAlarm(
                    f"{name} unhealthy at round {r}: "
                    f"max |{name}|={np.nanmax(np.abs(arr)):.3g}, "
                    f"finite={bool(np.isfinite(arr).all())} "
                    f"(threshold {self.cfg.loss_threshold})")

    def observe_similarity(self, round_idx: int, avg_jsd: float) -> None:
        """Feed one monitor read (lower is better); raise after
        ``similarity_patience`` consecutive reads worse than
        ``similarity_factor`` x the best seen."""
        if not np.isfinite(avg_jsd):
            raise WatchdogAlarm(
                f"non-finite similarity score at round {round_idx}")
        if self._best_jsd is None or avg_jsd < self._best_jsd:
            self._best_jsd = float(avg_jsd)
            self._bad_streak = 0
            return
        if avg_jsd > self.cfg.similarity_factor * self._best_jsd:
            self._bad_streak += 1
            if self._bad_streak >= self.cfg.similarity_patience:
                raise WatchdogAlarm(
                    f"similarity regressed for {self._bad_streak} "
                    f"consecutive reads (avg_jsd={avg_jsd:.4f} vs best "
                    f"{self._best_jsd:.4f}, factor "
                    f"{self.cfg.similarity_factor}) at round {round_idx}")
        else:
            self._bad_streak = 0

    def observe_drift(self, round_idx: int, drifted) -> list:
        """One detection window's drifted clients; returns those drifted
        ``drift_patience`` windows in a row (the caller charges them a
        quarantine strike).  A window without a client clears its
        streak.  Never raises."""
        hit = {int(c) for c in drifted}
        for c in list(self._drift_streaks):
            if c not in hit:
                del self._drift_streaks[c]
        sustained = []
        for c in sorted(hit):
            self._drift_streaks[c] = self._drift_streaks.get(c, 0) + 1
            if self._drift_streaks[c] >= self.cfg.drift_patience:
                sustained.append(c)
        return sustained


def fit_with_watchdog(trainer, epochs: int, watchdog: TrainingWatchdog,
                      ckpt_dir: Optional[str],
                      fit_kwargs: Optional[dict] = None,
                      on_rollback: Optional[Callable] = None):
    """Run ``trainer.fit`` for ``epochs`` more rounds under the watchdog.

    On a :class:`WatchdogAlarm`: reload the newest valid checkpoint under
    ``ckpt_dir`` onto the trainer's device, multiply the learning rate by
    ``lr_reanneal`` (``set_lr``), and go on.  When the restored run
    alarms again within one round, the restored generation carried the
    corruption (it was published before the explosion surfaced): the next
    rollback takes the next-older rotation slot (save with ``keep`` > 1
    to have one).  Past ``max_rollbacks``, or with no checkpoint, abort
    with ``RuntimeError``.

    Returns the final trainer: a rollback replaces the instance, so
    reassign it.  ``on_rollback(trainer)`` runs after each reload.

    With ``fit_kwargs["max_rounds_per_call"]`` = K the trainer hands the
    watchdog a chunk of up to K rounds at a time, so an alarm discards up
    to K rounds.  After a rollback, until training has re-run the stretch
    the alarming chunk covered, K is clamped to 1: the watchdog sees every
    round and a due checkpoint lands after each
    (``fed_tgan_tpu/train/watchdog.py:186-225``); past it the caller's K
    resumes."""
    from fed_tgan_torch.runtime.checkpoint import list_resumable, load_federated

    fit_kwargs = dict(fit_kwargs or {})
    fit_kwargs["health_cb"] = watchdog.health_cb
    target = trainer.completed_epochs + epochs
    base_rounds = int(fit_kwargs.get("max_rounds_per_call", 1))
    gen_skip = 0          # how many newest generations to skip over
    restore_round = None  # completed_epochs right after the last restore
    clamp_until = None    # a rollback's window: one round a chunk below it
    while trainer.completed_epochs < target:
        kw, stop = fit_kwargs, target
        if clamp_until is not None:
            if trainer.completed_epochs < clamp_until:
                kw = {**fit_kwargs, "max_rounds_per_call": 1}
                stop = min(clamp_until, target)
            else:
                clamp_until = None
        try:
            trainer.fit(stop - trainer.completed_epochs, **kw)
        except WatchdogAlarm as alarm:
            # completed_epochs stops at the chunk that alarmed: clamp
            # through the stretch that chunk could have covered
            clamp_until = max(clamp_until or 0,
                              trainer.completed_epochs + base_rounds)
            watchdog.rollbacks += 1
            _ALARMS_TOTAL.inc()
            _emit_event("watchdog_alarm", reason=str(alarm),
                        round=int(trainer.completed_epochs),
                        rollbacks=watchdog.rollbacks)
            get_health().update(
                watchdog_last_alarm=str(alarm),
                watchdog_alarm_round=int(trainer.completed_epochs),
                watchdog_rollbacks=watchdog.rollbacks)
            log.warning("watchdog alarm (%s); rollback %d/%d", alarm,
                        watchdog.rollbacks, watchdog.cfg.max_rollbacks)
            if watchdog.rollbacks > watchdog.cfg.max_rollbacks:
                raise RuntimeError(
                    f"aborting: watchdog fired {watchdog.rollbacks} times, "
                    f"exceeding max_rollbacks={watchdog.cfg.max_rollbacks} "
                    f"(last: {alarm})") from alarm
            gens = list_resumable(ckpt_dir) if ckpt_dir else []
            if not gens:
                raise RuntimeError(
                    "aborting: watchdog fired but no resumable checkpoint "
                    f"exists under {ckpt_dir!r} (pass --save-every to make "
                    "rollback possible)") from alarm
            # a checkpoint published at round E carries a corruption of
            # round E, which only shows in round E+1's losses
            if (restore_round is not None
                    and trainer.completed_epochs <= restore_round + 1):
                gen_skip += 1
            else:
                gen_skip = 0
            src = gens[min(gen_skip, len(gens) - 1)]
            if gen_skip:
                log.warning("watchdog: newest checkpoint re-alarmed "
                            "immediately; falling back %d generation(s) to "
                            "%s", gen_skip, src)
            old_lr = trainer.cfg.lr
            trainer = load_federated(src, device=trainer.device)
            trainer.set_lr(old_lr * watchdog.cfg.lr_reanneal)
            watchdog.reset_window()
            restore_round = trainer.completed_epochs
            _ROLLBACKS_TOTAL.inc()
            _emit_event("watchdog_rollback", restored_from=str(src),
                        round=int(trainer.completed_epochs),
                        generation_skip=gen_skip, lr=float(trainer.cfg.lr))
            get_health().update(
                watchdog_rollbacks=watchdog.rollbacks,
                watchdog_restored_round=int(trainer.completed_epochs),
                lr=float(trainer.cfg.lr))
            log.warning("rolled back to %s (round %d); lr re-annealed %g -> "
                        "%g", src, trainer.completed_epochs, old_lr,
                        trainer.cfg.lr)
            if on_rollback is not None:
                on_rollback(trainer)
    return trainer
