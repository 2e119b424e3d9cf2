"""The federated trainer: every client stacked on one device
(counterpart of ``fed_tgan_tpu/train/federated.py:102-135, 166-458,
1123-1190, 1256-1600, 1604-1669``).

A round, as the JAX program computes it (``vmap(run_one)`` over the
clients of a ``lax.scan`` of ``max_steps`` masked steps):

- every client's weights, BatchNorm state, Adam state and shard are
  stacked on a leading clients axis once (:func:`build_client_stacks`,
  :func:`~fed_tgan_torch.train.steps.stack_models`); a round is
  ``max(steps_i)`` calls of
  :func:`~fed_tgan_torch.train.steps.stacked_train_step`, each one train
  step of every client at once (K1 over N * batch rows, K2 in its
  backward), where client i's step s runs only while ``s < steps_i``:
  past it the step changes nothing of that client (its shard is
  ``len(shard) // batch_size`` steps; a client with no step reports zero
  metrics);
- each client draws from its own device ``torch.Generator``, on its
  active steps only, into its slice of the step's stacked draws;
- the stacked ``(params_g, params_d, state_g)`` leaves are gated +
  aggregated on the device
  (:func:`~fed_tgan_torch.parallel.fedavg.robust_aggregate`, or plain
  :func:`weighted_average` when nothing robust can trigger), and the
  aggregate is written into every client's slice.  Adam moments and
  learning-rate schedules stay per client across rounds: the JAX program
  replicates parameters, never optimizer state (``federated.py:409-413``);
- the round's metrics and the gate's quarantine mask come to the host in
  one copy; clients the gate rejects ``quarantine_strikes`` times are
  dropped (down to ``min_clients``) and the weights renormalized.

Snapshots sample the aggregated generator through the slice-1
``SamplingEngine`` with the JAX trainer's sampling-key offset 29, decoded
by the packed8 layout unless another is asked for.

The active fault plan (:mod:`fed_tgan_torch.testing.faults`) acts on the
round: ``kill_client`` drops its client at the start of its round, and the
update faults corrupt their client's update in every round of their window
(:func:`corrupt_updates`).  ``fit(health_cb=)`` hands each round's losses
to the training watchdog before the sample hook runs, so a round the
watchdog rejects is never checkpointed.

Under ``precision="bf16"`` the clients' steps run in bf16 with float32
islands (:mod:`fed_tgan_torch.runtime.precision`) and the aggregate is
re-encoded: each round's weighted step rounded to bf16 and added to the
float32 previous weights (``weighted_delta_average``, or the robust
aggregators' ``payload_dtype``), which needs weights summing to 1 (checked
at construction, as ``fed_tgan_tpu/train/federated.py:706-716``).

Elastic membership (``capacity=N``, ``fed_tgan_tpu/train/federated.py:
614-657, 898-1120``): the stacks hold ``N`` slots, the clients first and
then padded slots with zero weight and zero steps, whose sampler tables
are client 0's over zero data rows and whose models hold the global
parameters (every aggregate is written into every slot) with untouched
Adam state.  A padded slot is computed in every stacked step (static
shapes) and changes nothing.  The stacked data's per-slot stride is the
power of two at or above the longest shard.  :meth:`admit_clients` lands
newcomers in padded slots and grows the capacity to the next power of two
on overflow, the new slots copies of slot 0 as JAX's are;
:meth:`update_client_shard` swaps one client's rows (drift).

Not ported yet, each rejected with the ROADMAP item it waits for: cohort
sampling, buffered aggregation and EMA (A.17); several rounds per program
is CLI-level and refused there.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.federation.init import FederatedInit, renormalize_weights
from fed_tgan_torch.ops.decode import select_snapshot_decode
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.parallel.fedavg import (
    agg_leaves,
    robust_aggregate,
    weighted_average,
    weighted_delta_average,
)
from fed_tgan_torch.runtime.checkpoint import SavedSynthesizer
from fed_tgan_torch.runtime.precision import resolve_precision
from fed_tgan_torch.serve.engine import SamplingEngine, step_seed
from fed_tgan_torch.serve.registry import LoadedModel
from fed_tgan_torch.testing.faults import active_plan, update_fault_window
from fed_tgan_torch.train.sampler import (
    CondSampler,
    RowSampler,
    StackedCondSampler,
    StackedRowSampler,
)
from fed_tgan_torch.train.steps import (
    StepDraws,
    TrainConfig,
    client_draws,
    draw_into,
    init_models,
    require_trainable,
    stack_models,
    stacked_draws,
    stacked_train_step,
)

KEY_OFFSET = 29  # the JAX trainer's sampling stream offset
METRICS = ("loss_d", "pen", "loss_g")
log = logging.getLogger("fed_tgan_torch.train")

# (round, client, step) -> that step's draws; tests inject JAX draws here
Draws = Callable[[int, int, int], StepDraws]


def require_federated(cfg: TrainConfig) -> None:
    """The federated options this port runs (see the module docstring)."""
    for name, off, item in (("cohort", 0, "A.17"), ("aggregation", "sync",
                                                     "A.17"),
                            ("ema_decay", 0.0, "A.17")):
        if getattr(cfg, name) != off:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported yet "
                f"(ROADMAP {item})")
    require_trainable(cfg)


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def build_client_stacks(init: FederatedInit, cfg: TrainConfig,
                        spec: SegmentSpec, device, slots: int = 0,
                        stride: int = 0) -> tuple:
    """Per-client tables stacked on the clients axis
    (``fed_tgan_tpu/train/federated.py:102-135``): ``(cond, rows, data,
    steps, server_cond)``.  ``data`` is (slots * stride, dim), each shard
    padded to ``stride`` (default its longest shard); ``steps`` (slots,)
    is the reference's ``len(train) // batch_size`` per client
    (distributed.py:304).  Slots past the clients (``slots`` > N) train
    0 steps over zero rows with client 0's sampler tables
    (``_pad_population``, ``:898-933``).  A shard smaller than one batch
    trains 0 steps, which the reference silently allows: here that needs
    ``cfg.allow_zero_step_clients``."""
    mats = [np.asarray(m, dtype=np.float32) for m in init.client_matrices]
    pad = max(0, slots - len(mats))
    steps = np.asarray([len(m) // cfg.batch_size for m in mats],
                       dtype=np.int64)
    if (steps == 0).any() and not cfg.allow_zero_step_clients:
        small = [i for i, s in enumerate(steps) if s == 0]
        raise ValueError(
            f"clients {small} hold fewer than batch_size={cfg.batch_size} "
            "rows (reference behavior: they would train 0 steps); rebalance "
            "shards, shrink the batch, or opt in with "
            "TrainConfig(allow_zero_step_clients=True)")
    stride = max(stride, 1, max(len(m) for m in mats))
    data = np.zeros(((len(mats) + pad) * stride, spec.dim), dtype=np.float32)
    for i, m in enumerate(mats):
        data[i * stride:i * stride + len(m)] = m
    conds = [CondSampler.from_data(m, spec, device) for m in mats]
    rows = [RowSampler.from_data(m, spec, device) for m in mats]
    cond = StackedCondSampler.stack(conds + conds[:1] * pad)
    rows = StackedRowSampler.stack(rows + rows[:1] * pad, stride)
    steps = np.concatenate([steps, np.zeros(pad, dtype=np.int64)])
    # generation draws from the pooled empirical frequencies (the
    # reference server rebuilds Cond on the full table)
    server_cond = CondSampler.from_data(np.concatenate(mats), spec, device)
    return (cond, rows, torch.as_tensor(data, device=device), steps,
            server_cond)


class FederatedTrainer:
    """Federated training from a finished :class:`FederatedInit`, on
    ``device`` (the card unless the caller asks for the CPU).

    ``capacity`` > 0 makes the trainer elastic (the module docstring):
    that many slots, at least the population.  ``models`` (tests,
    interop) replaces the initial models, one per client or per slot,
    which are otherwise one ``init_models(spec, cfg, seed)`` copied to
    every slot; ``draws`` (tests) replaces every step's draws."""

    def __init__(self, init: FederatedInit, config: Optional[TrainConfig] = None,
                 seed: int = 0, min_clients: int = 1,
                 quarantine_strikes: int = 3, device="cuda",
                 decode: str = "packed8", models: Optional[list] = None,
                 draws: Optional[Draws] = None, capacity: int = 0):
        self.init = init
        self.cfg = config or TrainConfig()
        require_federated(self.cfg)
        self.device = resolve_device(device)
        self.seed = seed
        self.min_clients = min_clients
        self.quarantine_strikes = quarantine_strikes
        self.draws = draws
        self.n_clients = len(init.client_matrices)
        if capacity and capacity < self.n_clients:
            raise ValueError(
                f"capacity={capacity} below the resident population "
                f"{self.n_clients}: elastic slots can only add headroom")
        self.elastic = bool(capacity)
        self.capacity = capacity or self.n_clients
        self.spec = SegmentSpec.from_output_info(init.output_info)

        t0 = time.perf_counter()
        longest = max(len(m) for m in init.client_matrices)
        self._stride = _next_pow2(longest) if self.elastic else longest
        self._pack(init)
        self.timings = {"shard_packing": time.perf_counter() - t0}

        if models is None:
            models = [init_models(self.spec, self.cfg, seed, self.device)
                      ] * self.capacity
        if len(models) == self.n_clients < self.capacity:
            models = list(models) + [models[0]] * (self.capacity
                                                   - self.n_clients)
        if len(models) != self.capacity:
            raise ValueError(f"{len(models)} models for {self.n_clients} "
                             f"clients in {self.capacity} slots")
        self.stack = stack_models(models)
        # one client's dropout masks; the step's draws, every slot's slice
        self._keep = [s[1:] for s in self.stack.discriminator.keep_shapes(
            self.cfg.batch_size)]
        self.gens: list = []
        self._slot_draws()
        self.weights = np.concatenate([
            np.asarray(init.weights, dtype=np.float32),
            np.zeros(self.capacity - self.n_clients, dtype=np.float32)])
        if (self.cfg.precision == "bf16"
                and not np.isclose(self.weights.sum(), 1.0, atol=1e-4)):
            # the bf16 delta path re-anchors on prev and assumes
            # sum(w) == 1 (parallel/fedavg.py::weighted_delta_average)
            raise ValueError(
                f"similarity weights sum to {self.weights.sum():.6f}, not 1: "
                "the bf16 delta-encoded aggregation requires normalized "
                "weights (renormalize init.weights first)")
        self._strikes = np.zeros(self.capacity, dtype=np.int64)
        self.dropped_clients: set[int] = set()

        self.columns = init.transformers[0].columns
        self.decode = select_snapshot_decode(self.columns, decode)
        self._engine: Optional[SamplingEngine] = None
        self.epoch_times: list[float] = []
        self.phase_times = {"train_aggregate": [], "distribution": []}
        self.round_split = {"local_steps": [], "aggregate": []}
        self.completed_epochs = 0
        self.last_metrics: Optional[np.ndarray] = None
        self.last_quarantined: Optional[np.ndarray] = None
        self.run_name: Optional[str] = None  # set by load_federated

    def _pack(self, init: FederatedInit, server_cond: bool = True) -> None:
        """Stack ``init``'s shards into the trainer's slots (dropped
        clients at 0 steps); ``server_cond=False`` keeps the generation
        sampler (a drifted shard does not change it, as in JAX)."""
        cond, rows, data, steps, srv = build_client_stacks(
            init, self.cfg, self.spec, self.device, self.capacity,
            self._stride)
        self.conds, self.rows, self.data = cond, rows, data
        dropped = list(getattr(self, "dropped_clients", ()))
        steps[dropped] = 0
        self.steps = steps
        if server_cond:
            self.server_cond = srv
            self._engine = None

    def _slot_draws(self) -> None:
        """The stacked draw buffers and a generator per slot (a new slot's
        seeded as a fresh trainer's slot of that index)."""
        self._draws = stacked_draws(self.spec, self.cfg, self.capacity,
                                    self._keep, self.device)
        self._client_draws = [client_draws(self._draws, i)
                              for i in range(self.capacity)]
        self.gens += [torch.Generator(device=self.device).manual_seed(
            step_seed(self.seed, i))
            for i in range(len(self.gens), self.capacity)]

    @property
    def models(self) -> list:
        """Every client as a per-client ``Models`` (copies unstacked from
        :attr:`stack`, with torch optimizers at the client's state): for
        reading, as tests and interop do; training runs on the stack."""
        return [self.stack.to_models(i) for i in range(self.n_clients)]

    # ---------------------------------------------------------- the round

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _local_steps(self, e: int) -> torch.Tensor:
        """Every client's steps of round ``e``: ``max(steps)`` stacked
        steps, client i's active while ``s < steps[i]``; returns the
        (n_clients, 3) metrics of each client's last step (zeros without
        a step)."""
        steps = self.steps
        n_max = int(steps.max(initial=0))
        active = torch.as_tensor(np.arange(n_max)[:, None] < steps[None],
                                 device=self.device)
        metrics = torch.zeros((self.capacity, len(METRICS)),
                              device=self.device)
        for s in range(n_max):
            # each client draws on its own steps only, into its slice
            for i in np.flatnonzero(s < steps):
                dst = self._client_draws[i]
                if self.draws is not None:
                    src = self.draws(e, int(i), s).tensors()
                    for a, b in zip(dst.tensors(), src):
                        a.copy_(b)
                else:
                    draw_into(self.gens[i], self.spec, self.cfg, self._keep,
                              self.device, dst)
            metrics = stacked_train_step(self.stack, self.data, self.conds,
                                         self.rows, self._draws, active[s],
                                         metrics)
        return metrics

    @torch.no_grad()
    def _aggregate(self, prev: list, update_fault=None):
        """Gate and aggregate the clients' stacked leaves against
        ``prev``, write the result into every client's slice; returns the
        quarantine mask."""
        new = agg_leaves(self.stack)
        if update_fault is not None:
            new = corrupt_updates(prev, new, update_fault)
        w = torch.as_tensor(self.weights, device=self.device)
        cfg = self.cfg
        payload = resolve_precision(cfg.precision).payload_dtype
        if cfg.update_gate or cfg.aggregator != "weighted" or update_fault:
            agg, quar = robust_aggregate(
                prev, new, w, torch.as_tensor(self.steps, device=self.device),
                aggregator=cfg.aggregator, update_gate=cfg.update_gate,
                gate_norm_factor=cfg.gate_norm_factor,
                update_clip=cfg.update_clip, trim_ratio=cfg.trim_ratio,
                payload_dtype=payload)
        elif payload is not None:
            agg = weighted_delta_average(prev, new, w, payload)
        else:
            agg = weighted_average(new, w)
            quar = torch.zeros(self.capacity, dtype=torch.bool,
                               device=self.device)
        for x, a in zip(agg_leaves(self.stack), agg):
            x.copy_(a)
        return quar

    def run_round(self, e: int, update_fault=None):
        """One round: local steps, aggregation; returns ``(metrics
        (capacity, 3), quarantined (capacity,) bool)`` on the host and
        records the local / aggregate split (the device synchronised
        between them)."""
        t0 = time.perf_counter()
        with torch.no_grad():  # every client holds the global state
            prev = [x[0].clone() for x in agg_leaves(self.stack)]
        metrics = self._local_steps(e)
        self._sync()
        t1 = time.perf_counter()
        quar = self._aggregate(prev, update_fault)
        host = torch.cat([metrics.flatten(),
                          quar.to(torch.float32)]).cpu().numpy()
        t2 = time.perf_counter()
        self.round_split["local_steps"].append(t1 - t0)
        self.round_split["aggregate"].append(t2 - t1)
        n = self.capacity
        self.last_metrics = host[:n * len(METRICS)].reshape(n, len(METRICS))
        self.last_quarantined = host[n * len(METRICS):] > 0.5
        return self.last_metrics, self.last_quarantined

    def _strike(self, q: np.ndarray, metrics: np.ndarray, e: int) -> None:
        """Count the gate's strikes and evict repeat offenders."""
        if not q.any():
            return
        self._strikes += q.astype(np.int64)
        for idx in np.flatnonzero(q):
            tripped = ("nonfinite" if not np.isfinite(metrics[idx]).all()
                       else "norm_outlier")
            log.warning("update gate quarantined client %d in round %d "
                        "(%s; strikes %d/%d)", idx, e, tripped,
                        self._strikes[idx], self.quarantine_strikes)
        for idx in np.flatnonzero(self._strikes >= self.quarantine_strikes):
            if int(idx) not in self.dropped_clients:
                self.drop_client(int(idx), f"quarantined {self._strikes[idx]} "
                                 f"rounds (strike limit "
                                 f"{self.quarantine_strikes})")

    @staticmethod
    def _warn_nonfinite(metrics: np.ndarray, q: np.ndarray, e: int) -> None:
        """Warn of non-finite losses of a client the gate did not contain."""
        for j, name in enumerate(METRICS):
            if not (np.isfinite(metrics[:, j]) | q).all():
                print(f"WARNING: non-finite {name} at round {e}: training "
                      "has diverged (lower the learning rate)")
                return

    def _fault_kill(self, plan, e: int) -> None:
        """The ``kill_client`` fault: drop its client at the start of its
        round (``fed_tgan_tpu/train/federated.py:1314-1318``)."""
        if (plan is not None and plan.kill_rank
                and plan.should_kill(plan.kill_rank, e + 1)):
            self.drop_client(plan.kill_rank - 1,
                             f"fault-injected kill at round {e + 1}")

    def fit(self, epochs: int, log_every: int = 0, sample_hook=None,
            hook_epochs=None, update_fault=None,
            health_cb=None) -> "FederatedTrainer":
        """Run ``epochs`` rounds; ``sample_hook(epoch, self)`` after each
        round (or only the rounds in ``hook_epochs``).

        ``update_fault`` ``(kind, client, factor)`` corrupts that client's
        update after its local steps in every round of this call:
        ``"nan"``, ``"scale"`` (``prev + factor * delta``) or ``"stuck"``
        (the pre-round values).  Without it, the active fault plan's
        update fault applies in the rounds of its window.

        ``health_cb(round, metrics)`` gets ``loss_d``, ``pen`` and
        ``loss_g`` as (1, capacity) host arrays and ``quarantined``, after
        the strikes and before the sample hook; an exception it raises
        ends the call with the round's state in place and the round not
        counted."""
        e = self.completed_epochs
        end = e + epochs
        if sample_hook is None:
            firing = set()
        elif hook_epochs is None:
            firing = set(range(e, end))
        else:
            firing = {x for x in hook_epochs if e <= x < end}
        while e < end:
            plan = active_plan()
            self._fault_kill(plan, e)
            fault = (update_fault if update_fault is not None
                     else update_fault_window(plan, e, 1)[0])
            t0 = time.perf_counter()
            metrics, q = self.run_round(e, fault)
            self._warn_nonfinite(metrics, q, e)
            self._strike(q, metrics, e)
            if health_cb is not None:
                health_cb(e, {**{name: metrics[None, :, j]
                                 for j, name in enumerate(METRICS)},
                              "quarantined": q[None].astype(np.float32)})
            t_round = time.perf_counter() - t0
            self.phase_times["train_aggregate"].append(t_round)
            self.phase_times["distribution"].append(0.0)
            self.epoch_times.append(t_round)
            self.completed_epochs += 1
            if e in firing:
                t1 = time.perf_counter()
                sample_hook(e, self)
                t_hook = time.perf_counter() - t1
                self.phase_times["distribution"][-1] = t_hook
                self.epoch_times[-1] = t_round + t_hook
            if log_every and e % log_every == 0:
                m = metrics.mean(axis=0)
                print(f"round {e}: loss_d={m[0]:.3f} pen={m[1]:.3f} "
                      f"loss_g={m[2]:.3f} ({self.epoch_times[-1]:.3f}s/round)")
            e += 1
        return self

    def set_lr(self, lr: float) -> None:
        """Set every client's learning rate to ``lr`` from the next update
        on (the watchdog's re-anneal): the schedules keep their step
        counts and scale from the new base."""
        self.cfg = dataclasses.replace(self.cfg, lr=float(lr))
        self.stack.set_config(self.cfg)

    # ---------------------------------------------------------- membership

    def drop_client(self, idx: int, reason: str = "") -> None:
        """Drop client ``idx`` from every later round: its steps go to 0
        and the weights renormalize over the survivors.  Raises
        ``RuntimeError`` below ``min_clients`` survivors."""
        if not 0 <= idx < self.n_clients:
            raise IndexError(f"client index {idx} out of range")
        if idx in self.dropped_clients:
            return
        survivors = self.n_clients - len(self.dropped_clients) - 1
        if survivors < self.min_clients:
            raise RuntimeError(
                f"aborting: dropping client {idx} leaves {survivors} live "
                f"clients, below min_clients={self.min_clients}")
        self.dropped_clients.add(idx)
        alive = self._alive()
        self.weights = renormalize_weights(self.weights, alive)
        self.steps = np.where(alive, self.steps, 0)
        log.warning("dropped client %d%s; weights renormalized over %d "
                    "survivors", idx, f" ({reason})" if reason else "",
                    survivors)

    def update_weights(self, weights: np.ndarray) -> None:
        """Install new similarity weights (one per client, or per slot);
        dropped clients stay at 0 and the survivors renormalize."""
        w = np.asarray(weights, dtype=np.float32)
        if w.shape[0] == self.n_clients < len(self.weights):
            w = np.concatenate([w, np.zeros(len(self.weights)
                                            - self.n_clients, np.float32)])
        if w.shape != self.weights.shape:
            raise ValueError(f"weights shape {w.shape} does not match the "
                             f"population {self.weights.shape}")
        self.weights = renormalize_weights(w, self._alive())

    def _alive(self) -> np.ndarray:
        """Per slot: not dropped (a padded slot is alive at weight 0)."""
        alive = np.ones(len(self.weights), dtype=bool)
        alive[list(self.dropped_clients)] = False
        return alive

    def admit_clients(self, new_init: FederatedInit,
                      reason: str = "join") -> "FederatedTrainer":
        """Admit newcomers between rounds (``fed_tgan_tpu/train/
        federated.py:935-1046``).  ``new_init`` is the grown init from
        ``OnboardingSession.register_clients``: the residents first, then
        the newcomers.  Inside the capacity they land in padded slots,
        which already hold the global parameters and untouched Adam
        state; past it the capacity grows to the next power of two, the
        new slots copies of slot 0 (``repacked``).  The stacks are
        rebuilt from ``new_init`` (the row stride grows to the next power
        of two when a shard needs it) and its weights installed, dropped
        clients kept at 0.  Each newcomer is logged as a
        ``client_joined`` event dict, kept in :attr:`last_admission`."""
        if not self.elastic:
            raise RuntimeError(
                "admit_clients needs an elastic trainer: construct "
                "FederatedTrainer(..., capacity=N) with headroom slots")
        n_total = len(new_init.client_matrices)
        if n_total <= self.n_clients:
            raise ValueError(
                f"new_init holds {n_total} shards, not more than the "
                f"{self.n_clients} residents: nothing to admit")
        t0 = time.perf_counter()
        repacked = n_total > self.capacity
        if repacked:
            grow = _next_pow2(n_total) - self.capacity
            self.stack = stack_models(
                [self.stack.to_models(i) for i in range(self.capacity)]
                + [self.stack.to_models(0)] * grow)
            self.capacity += grow
            self._strikes = np.concatenate(
                [self._strikes, np.zeros(grow, dtype=np.int64)])
            self._slot_draws()
        longest = max(len(m) for m in new_init.client_matrices)
        if longest > self._stride:
            self._stride = _next_pow2(longest)
            repacked = True
        first_new = self.n_clients
        self.init = new_init
        self.n_clients = n_total
        self._pack(new_init)
        self.weights = np.zeros(self.capacity, dtype=np.float32)
        self.update_weights(np.asarray(new_init.weights, dtype=np.float32))
        self.timings["shard_packing"] = time.perf_counter() - t0
        self.last_admission = [{
            "type": "client_joined", "client": idx,
            "round": self.completed_epochs, "population": n_total,
            "capacity": self.capacity,
            "weight": round(float(self.weights[idx]), 8),
            "rows": int(len(new_init.client_matrices[idx])),
            "repacked": repacked, "reason": reason}
            for idx in range(first_new, n_total)]
        for event in self.last_admission:
            log.info("%s", event)
        return self

    def update_client_shard(self, idx: int, matrix: np.ndarray) -> None:
        """Swap client ``idx``'s training rows between rounds (drift,
        ``fed_tgan_tpu/train/federated.py:1048-1120``): its sampler
        tables, data rows and step count follow the new shard; its model
        slice and the generation sampler stay."""
        if not 0 <= idx < self.n_clients:
            raise IndexError(f"client index {idx} out of range")
        matrix = np.asarray(matrix, dtype=np.float32)
        if len(matrix) // self.cfg.batch_size == 0 \
                and not self.cfg.allow_zero_step_clients:
            raise ValueError(f"drifted shard for client {idx} holds fewer "
                             f"than batch_size={self.cfg.batch_size} rows")
        if len(matrix) > self._stride:
            self._stride = (_next_pow2(len(matrix)) if self.elastic
                            else len(matrix))
        self.init.client_matrices[idx] = matrix
        self._pack(self.init, server_cond=False)

    # ------------------------------------------------------------ sampling

    def _sampler(self) -> SamplingEngine:
        """The engine over the aggregated generator (client 0's copy,
        refreshed on every call; all clients hold the aggregate)."""
        if self._engine is None:
            synth = SavedSynthesizer(self.stack.generator.unstack(0),
                                     self.server_cond, self.columns, self.cfg,
                                     key_offset=KEY_OFFSET)
            self._engine = SamplingEngine(LoadedModel(
                model_id="in-memory", synth=synth, meta=self.init.global_meta,
                encoders=tuple(self.init.encoders), artifact=None))
        gen = self._engine.model.synth.generator
        gen.load_state_dict(self.stack.generator.client_state(0))
        return self._engine

    def sample_encoded(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` activated rows of stream ``seed`` (encoded layout)."""
        return self._sampler().sample_encoded(n, seed=seed)

    def sample_parts(self, n: int, seed: int = 0,
                     to_host: bool = True) -> dict:
        """``n`` rows of stream ``seed`` in the snapshot decode's packed
        parts: host arrays, or with ``to_host=False`` tensors on the
        trainer's device, still being computed."""
        return self._sampler().sample_parts(n, self.decode, seed=seed,
                                            to_host=to_host)

    def sample(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` decoded rows: numeric values, categorical codes."""
        return self.decode.assemble(self.sample_parts(n, seed))

    def to_saved(self) -> SavedSynthesizer:
        """The aggregated model as a sampling artifact."""
        return SavedSynthesizer(self.stack.generator.unstack(0),
                                self.server_cond, self.columns, self.cfg,
                                key_offset=KEY_OFFSET)

    def write_timing(self, out_dir: str = ".") -> None:
        """``timestamp_experiment.csv`` (one wall-clock value per round)
        and ``timing_phases.csv`` (epoch, train_aggregate_s,
        distribution_s, total_s), the reference's layout."""
        with open(os.path.join(out_dir, "timestamp_experiment.csv"),
                  "w") as f:
            csv.writer(f).writerows([[t] for t in self.epoch_times])
        with open(os.path.join(out_dir, "timing_phases.csv"), "w") as f:
            w = csv.writer(f)
            w.writerow(["epoch", "train_aggregate_s", "distribution_s",
                        "total_s"])
            for i, t in enumerate(self.epoch_times):
                w.writerow([i, self.phase_times["train_aggregate"][i],
                            self.phase_times["distribution"][i], t])


def corrupt_updates(prev: list, new: list, fault) -> list:
    """``fault = (kind, client, factor)`` applied to that client's stacked
    leaves: ``nan`` fills them with NaN, ``scale`` gives ``prev + factor *
    (new - prev)``, ``stuck`` the pre-round values
    (``fed_tgan_tpu/train/federated.py:286-307``)."""
    kind, idx, factor = fault
    if kind not in ("nan", "scale", "stuck"):
        raise ValueError(f"unknown update fault {kind!r}")
    out = []
    for p, x in zip(prev, new):
        x = x.clone()
        if kind == "nan":
            x[idx] = torch.nan
        elif kind == "scale":
            x[idx] = p + factor * (x[idx] - p)
        else:
            x[idx] = p
        out.append(x)
    return out
