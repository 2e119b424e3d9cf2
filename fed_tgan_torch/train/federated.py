"""The federated trainer: every client stacked on one device
(counterpart of ``fed_tgan_tpu/train/federated.py:102-135, 166-458,
1123-1190, 1203-1600, 1604-1669``).

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
- clients the gate rejects ``quarantine_strikes`` times are dropped (down
  to ``min_clients``) and the weights renormalized.

Rounds run in chunks (``fit(max_rounds_per_call=K)``, the CLI's
``--rounds-per-program``): the rounds of a chunk are queued on the device
back to back, their metrics, quarantine masks and finite flag stay there,
and the chunk makes one copy to the host; strikes and evictions follow
the chunk, as JAX's host code applies them after its fused program.  The
hook rounds, the ``kill_client`` round, the update-fault and straggle
windows and buffered arrivals each end a chunk.  A chunk of K rounds
computes what K chunks of one round compute, bit for bit.

Cohort sampling (``cfg.cohort`` = C, ``0 < C < slots``,
``federated.py:187-198, 326-407``): each round trains and aggregates C
slots drawn from ``(seed, round)`` (:meth:`FederatedTrainer.cohort_ids`,
or an injected ``cohort_fn``).  Their models, BatchNorm state, Adam state
and sampler tables are gathered into a C-slot working stack allocated
once (the data rows stay where they are: the gathered row tables point
at them), the working stack runs the masked steps, the cohort's weights
renormalize as ``w / max(sum(w), 1e-12)``, and the aggregate is written
into every slot after the cohort's local state is scattered back with
``index_copy_``.  Only sampled clients draw, each from its own generator,
into its position of the working stack.  ``C = 0`` or ``C = slots`` is
full participation.

Buffered aggregation (``cfg.aggregation = "buffered"``, ``federated.py:
204-210, 309-324, 1203-1254``): in a ``straggle`` fault's window a chunk
is one round; the straggler trains but leaves the round's barrier (its
weight masked to 0, the others renormalized; ``self.weights`` stays),
its float32 delta over ``(params_g, params_d, state_g)`` is queued and
lands at the start of round ``origin + max(1, delay)``, scaled by
``weight * staleness_discount ** staleness``, in every slot; a non-finite
delta is a strike instead.  Without a straggler, buffered is sync.

The generator EMA (``cfg.ema_decay`` = d > 0, ``federated.py:414-422,
1604-1627``): a float32 tensor of the aggregated generator's weights and
running statistics, zero at the start, ``d * ema + (1 - d) * avg`` after
every round; :meth:`FederatedTrainer._global_model` debiases it by ``1 /
(1 - d ** n)`` once a round has been folded in, and every sampling
surface (snapshots, ``sample_encoded``, the monitor, ``to_saved``) reads
it.

Snapshots sample the aggregated generator through the slice-1
``SamplingEngine`` with the JAX trainer's sampling-key offset 29, decoded
by the packed8 layout unless another is asked for.

The active fault plan (:mod:`fed_tgan_torch.testing.faults`) acts on the
round: ``kill_client`` drops its client at the start of its round, and the
update faults corrupt their client's update in every round of their window
(:func:`corrupt_updates`).  ``fit(health_cb=)`` hands each chunk's losses
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
shapes) and changes nothing; a cohort draws over every slot, padded ones
included, as JAX's does.  The stacked data's per-slot stride is the
power of two at or above the longest shard.  :meth:`admit_clients` lands
newcomers in padded slots and grows the capacity to the next power of two
on overflow, the new slots copies of slot 0 as JAX's are;
:meth:`update_client_shard` swaps one client's rows (drift).

The round journals what JAX's does (``fed_tgan_tpu/train/federated.py:
816-895, 1172, 1228-1254, 1377-1589``) through the process journal
(:mod:`fed_tgan_torch.obs.journal`, a free no-op without one): per
logical round ``round``, ``aggregate``, ``cohort`` (under a cohort or
buffered aggregation) and ``client_contribution`` (chunk-head convention:
``first`` is the chunk's first round, ``rounds_per_program`` its size),
``quarantine`` per gated client, ``client_dropped``, ``client_joined``,
``init_phase`` (shard packing) and, once per distinct chunk while a
journal is installed, ``program_cost`` measured on that real dispatch
(:func:`fed_tgan_torch.obs.ledger.measure_dispatch`).  The
``/healthz`` fields and the per-client registry series follow each chunk.
Every one of them is built from the chunk's one host copy and host state
(weights, strikes, clocks): the journal adds no device-to-host copy and
no synchronisation.  Host phases are spans (``train.local_steps``,
``train.aggregate.sync``, ``train.monitor``, ``train.snapshot``).
Buffered mode's ``aggregate`` and ``quarantine`` events are also kept in
:attr:`FederatedTrainer.events`.
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

from fed_tgan_torch.analysis.sanitizers import hot_region, sanctioned_sync
from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.federation.init import FederatedInit, renormalize_weights
from fed_tgan_torch.obs.exporter import get_health
from fed_tgan_torch.obs.journal import emit as _emit_event, get_journal
from fed_tgan_torch.obs.registry import counter as _metric_counter, get_registry
from fed_tgan_torch.obs.trace import span as _span
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
from fed_tgan_torch.testing.faults import (
    active_plan,
    straggle_window,
    update_fault_window,
)
from fed_tgan_torch.train.sampler import (
    CondSampler,
    RowSampler,
    StackedCondSampler,
    StackedRowSampler,
)
from fed_tgan_torch.train.steps import (
    StackedModels,
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
COHORT_STREAM = 0x636F686F7274  # the cohort draw's stream ("cohort")
log = logging.getLogger("fed_tgan_torch.train")

_ROUNDS_TOTAL = _metric_counter(
    "fed_tgan_training_rounds_total", "federated rounds completed")
_CHUNKS_TOTAL = _metric_counter(
    "fed_tgan_training_chunks_total", "fused round-chunks dispatched")
_QUARANTINED_TOTAL = _metric_counter(
    "fed_tgan_training_quarantined_rounds_total",
    "client-rounds quarantined by the update gate")
_DROPPED_TOTAL = _metric_counter(
    "fed_tgan_training_clients_dropped_total",
    "clients dropped from the federation")
# labelled registry series are bounded: past this many clients the
# contribution ledger lives in the journal only
_LEDGER_LABEL_CAP = 64

# (round, client, step) -> that step's draws; tests inject JAX draws here
Draws = Callable[[int, int, int], StepDraws]
# round -> the ids of the slots that round samples; tests inject JAX's
CohortFn = Callable[[int], np.ndarray]


def require_federated(cfg: TrainConfig) -> None:
    """The federated options this port runs: a known aggregation mode
    and what :func:`require_trainable` checks."""
    if cfg.aggregation not in ("sync", "buffered"):
        raise ValueError(
            f"aggregation={cfg.aggregation!r}: expected sync|buffered")
    if cfg.cohort < 0:
        raise ValueError(f"cohort={cfg.cohort}: must be >= 0")
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


@dataclasses.dataclass
class _Part:
    """One round's participants: the stack they train in (the trainer's
    own, or the cohort's working stack), their samplers and draw buffers,
    and per position the client id and its local steps."""

    stack: StackedModels
    conds: StackedCondSampler
    rows: StackedRowSampler
    draws: StepDraws
    client_draws: list
    ids: np.ndarray               # (P,) slot of each position
    steps: np.ndarray             # (P,) local steps of each position
    steps_dev: torch.Tensor       # the same on the device
    idx: Optional[torch.Tensor]   # the cohort's slots on the device


class FederatedTrainer:
    """Federated training from a finished :class:`FederatedInit`, on
    ``device`` (the card unless the caller asks for the CPU).

    ``capacity`` > 0 makes the trainer elastic (the module docstring):
    that many slots, at least the population.  ``models`` (tests,
    interop) replaces the initial models, one per client or per slot,
    which are otherwise one ``init_models(spec, cfg, seed)`` copied to
    every slot; ``draws`` (tests) replaces every step's draws and
    ``cohort_fn`` every round's cohort."""

    def __init__(self, init: FederatedInit, config: Optional[TrainConfig] = None,
                 seed: int = 0, min_clients: int = 1,
                 quarantine_strikes: int = 3, device="cuda",
                 decode: str = "packed8", models: Optional[list] = None,
                 draws: Optional[Draws] = None, capacity: int = 0,
                 cohort_fn: Optional[CohortFn] = None):
        self.init = init
        self.cfg = config or TrainConfig()
        require_federated(self.cfg)
        self.device = resolve_device(device)
        self.seed = seed
        self.min_clients = min_clients
        self.quarantine_strikes = quarantine_strikes
        self.draws = draws
        self.cohort_fn = cohort_fn
        self.n_clients = len(init.client_matrices)
        if capacity and capacity < self.n_clients:
            raise ValueError(
                f"capacity={capacity} below the resident population "
                f"{self.n_clients}: elastic slots can only add headroom")
        if self.cfg.cohort and not 0 < self.cfg.cohort <= self.n_clients:
            raise ValueError(
                f"cohort={self.cfg.cohort} must be in 1..{self.n_clients} "
                "(the resident client population)")
        self.elastic = bool(capacity)
        self.capacity = capacity or self.n_clients
        self.spec = SegmentSpec.from_output_info(init.output_info)

        t0 = time.perf_counter()
        longest = max(len(m) for m in init.client_matrices)
        self._stride = _next_pow2(longest) if self.elastic else longest
        with _span("init.shard_packing", clients=self.n_clients):
            self._pack(init)
        self.timings = {"shard_packing": time.perf_counter() - t0}
        self._emit_packing(init, self.timings["shard_packing"])

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
        self._work: Optional[tuple] = None  # the cohort's working stack
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
        # buffered mode's straggler deltas awaiting their arrival round
        self._buffered: list[dict] = []
        self._buffered_applied = 0
        self.events: list[dict] = []
        # the EMA of the aggregated generator: its flat weights and its
        # running statistics (one slot's), zero until the first round
        G = self.stack.generator
        self._bn0 = self._slot0_bn()
        self.ema = ([torch.zeros_like(G.params[0].detach()),
                     torch.zeros_like(G.bn_state[self._bn0])]
                    if self.cfg.ema_decay > 0.0 else None)
        self._ema_updates = 0
        self.host_copies = 0  # device-to-host copies of round results
        self._costed: set = set()  # chunks whose program_cost is journaled
        # the stacked row counts the steps ran (the sanitizers' training
        # budget: one launch plan each)
        self.step_rows: set = set()

        self.columns = init.transformers[0].columns
        self.decode = select_snapshot_decode(self.columns, decode)
        self._engine: Optional[SamplingEngine] = None
        self.epoch_times: list[float] = []
        self.phase_times = {"train_aggregate": [], "distribution": []}
        self.round_split = {"local_steps": [], "aggregate": []}
        self.completed_epochs = 0
        self.last_metrics: Optional[np.ndarray] = None
        self.last_quarantined: Optional[np.ndarray] = None
        self.last_cohort: Optional[np.ndarray] = None
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

    @staticmethod
    def _emit_packing(init: FederatedInit, seconds: float) -> None:
        _emit_event("init_phase", phase="shard_packing",
                    seconds=round(seconds, 6),
                    clients=len(init.client_matrices),
                    rows=int(sum(len(m) for m in init.client_matrices)))

    def _slot0_bn(self) -> torch.Tensor:
        """Where slot 0's running statistics sit in the stack's
        ``bn_state``."""
        return self.stack.generator.bn_index(
            torch.zeros(1, dtype=torch.long, device=self.device))

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
            with sanctioned_sync():  # the local / aggregate split's timing
                torch.cuda.synchronize(self.device)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the device without waiting for the device's
        queue: pinned and copied asynchronously on the card."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """The one device-to-host copy of a chunk's results (counted in
        :attr:`host_copies`)."""
        self.host_copies += 1
        with sanctioned_sync(), _span("train.host_copy"):
            return t.cpu().numpy()

    @property
    def cohort_size(self) -> int:
        """C while a cohort is sampled (``0 < cfg.cohort < slots``), else
        0: full participation."""
        c = self.cfg.cohort
        return c if 0 < c < self.capacity else 0

    def cohort_ids(self, e: int) -> np.ndarray:
        """The C slots round ``e`` samples: the injected ``cohort_fn``, or
        the first C of a permutation of the slots from a generator seeded
        with ``(seed, e)``, so a round's cohort depends on nothing but
        those two (not on chunking, not on a resume)."""
        if self.cohort_fn is not None:
            ids = np.asarray(self.cohort_fn(e), dtype=np.int64)
        else:
            gen = torch.Generator().manual_seed(
                step_seed(step_seed(self.seed, COHORT_STREAM), e))
            ids = torch.randperm(self.capacity, generator=gen)[
                :self.cohort_size].numpy()
        if ids.shape != (self.cohort_size,) or len(set(ids.tolist())) \
                != ids.size or ids.min() < 0 or ids.max() >= self.capacity:
            raise ValueError(f"round {e}: cohort {ids.tolist()} is not "
                             f"{self.cohort_size} distinct slots of "
                             f"{self.capacity}")
        return ids

    def _full_part(self, steps_dev: Optional[torch.Tensor] = None) -> _Part:
        """Every slot, in the trainer's own stack."""
        if steps_dev is None:
            steps_dev = self._upload(self.steps)
        return _Part(self.stack, self.conds, self.rows, self._draws,
                     self._client_draws, np.arange(self.capacity),
                     self.steps, steps_dev, None)

    def _cohort_part(self, ids: np.ndarray, idx: torch.Tensor,
                     steps_dev: torch.Tensor) -> _Part:
        """Slots ``ids`` gathered into the working stack (allocated on
        first use; its shapes never change)."""
        if self._work is None:
            c = self.cohort_size
            draws = stacked_draws(self.spec, self.cfg, c, self._keep,
                                  self.device)
            self._work = (self.stack.empty_like(c), draws,
                          [client_draws(draws, j) for j in range(c)])
        work, draws, cdraws = self._work
        work.set_config(self.cfg)
        work.gather(self.stack, idx)
        return _Part(work, self.conds.take(idx), self.rows.take(idx), draws,
                     cdraws, ids, self.steps[ids], steps_dev, idx)

    def _local_steps(self, e: int, part: Optional[_Part] = None
                     ) -> torch.Tensor:
        """The participants' steps of round ``e`` (every slot by
        default): ``max(steps)`` stacked steps, position j active while
        ``s < steps[j]``; returns the (P, 3) metrics of each position's
        last step (zeros without a step)."""
        part = part or self._full_part()
        steps = part.steps
        self.step_rows.add(len(steps) * self.cfg.batch_size)
        n_max = int(steps.max(initial=0))
        active = (torch.arange(n_max, device=self.device)[:, None]
                  < part.steps_dev[None])
        metrics = torch.zeros((len(steps), len(METRICS)), device=self.device)
        for s in range(n_max):
            # each client draws on its own steps only, into its position
            with _span("train.draws"):
                for j in np.flatnonzero(s < steps):
                    i = int(part.ids[j])
                    dst = part.client_draws[j]
                    if self.draws is not None:
                        src = self.draws(e, i, s).tensors()
                        for a, b in zip(dst.tensors(), src):
                            a.copy_(b)
                    else:
                        draw_into(self.gens[i], self.spec, self.cfg,
                                  self._keep, self.device, dst)
            metrics = stacked_train_step(part.stack, self.data, part.conds,
                                         part.rows, part.draws, active[s],
                                         metrics)
        return metrics

    def _updates(self, prev: list, part: _Part, update_fault=None) -> list:
        """The participants' stacked leaves after their local steps, the
        update fault applied to its client's position (if it takes
        part)."""
        new = agg_leaves(part.stack)
        if update_fault is not None:
            new = corrupt_updates(prev, new, update_fault,
                                  np.flatnonzero(part.ids == update_fault[1]))
        return new

    @torch.no_grad()
    def _aggregate(self, prev: list, update_fault=None,
                   part: Optional[_Part] = None,
                   weights: Optional[torch.Tensor] = None,
                   new: Optional[list] = None) -> torch.Tensor:
        """Gate and aggregate the participants' stacked leaves ``new``
        (default :meth:`_updates`) against ``prev`` (every slot by
        default, at :attr:`weights`), scatter a cohort's local state
        back, write the result into every slot and fold it into the EMA;
        returns the quarantine mask (P,)."""
        part = part or self._full_part()
        if new is None:
            new = self._updates(prev, part, update_fault)
        if weights is None:
            weights = self._upload(self.weights)
        w = weights
        if part.idx is not None:  # renormalized over the cohort
            w = w[part.idx]
            w = w / torch.clamp(w.sum(), min=1e-12)
        agg, quar = aggregate_updates(prev, new, w, part.steps_dev, self.cfg,
                                      robust=bool(update_fault))
        if part.idx is not None:
            part.stack.scatter(self.stack, part.idx)
        for x, a in zip(agg_leaves(self.stack), agg):
            x.copy_(a)
        if self.ema is not None:
            fold_ema(self.ema, self.stack.generator, self._bn0,
                     self.cfg.ema_decay)
            self._ema_updates += 1
        return quar

    def run_round(self, e: int, update_fault=None):
        """One round as a chunk of its own: local steps, aggregation;
        returns ``(metrics (P, 3), quarantined (P,) bool)`` on the host
        (P the participants: every slot, or the cohort)."""
        res = self._run_chunk(e, 1, update_fault, None)
        return res["metrics"][0], res["quarantined"][0]

    def _run_chunk(self, e: int, size: int, update_fault, straggle) -> dict:
        """Rounds ``e`` .. ``e + size - 1`` queued on the device, their
        results kept there and copied to the host once; returns the host
        results (``metrics`` (K, P, 3), ``quarantined`` (K, P), ``finite``,
        ``cohort`` (K, C) or None, ``delta`` of the straggler and whether
        it is finite) and records the chunk's local / aggregate split.
        The first chunk of each shape dispatched while a journal is
        installed is measured for its ``program_cost`` event."""
        key = (size, self.cohort_size or self.capacity, update_fault,
               straggle)
        if get_journal() is None or key in self._costed:
            return self._dispatch_chunk(e, size, update_fault, straggle)
        self._costed.add(key)
        from fed_tgan_torch.obs.ledger import (
            CostEntry,
            get_ledger,
            measure_dispatch,
        )

        stack = key[1]
        name = (f"train_step[stack{stack}@{self.cfg.precision}]" if size == 1
                else f"train_step[stack{stack}:r{size}@{self.cfg.precision}]")
        entry = CostEntry(name=name, family="train_live")
        with measure_dispatch(entry, self.device):
            res = self._dispatch_chunk(e, size, update_fault, straggle)
        get_ledger().record(entry)
        _emit_event("program_cost", **entry.to_dict())
        return res

    def _dispatch_chunk(self, e: int, size: int, update_fault,
                        straggle) -> dict:
        """The chunk's device work and its one host copy, a sanitizer hot
        region (``train.chunk[...]``): under ``--sanitize`` any other
        synchronising call in a steady chunk raises."""
        stack = self.cohort_size or self.capacity
        with hot_region(f"train.chunk[stack{stack}@{self.cfg.precision}"
                        f":r{size}]"):
            return self._dispatch_chunk_body(e, size, update_fault,
                                             straggle)

    def _dispatch_chunk_body(self, e: int, size: int, update_fault,
                             straggle) -> dict:
        t0 = time.perf_counter()
        cohort = self.cohort_size
        if cohort:
            ids = np.stack([self.cohort_ids(x) for x in range(e, e + size)])
            steps = self.steps[ids]
        else:
            ids = np.broadcast_to(np.arange(self.capacity),
                                  (size, self.capacity))
            steps = np.broadcast_to(self.steps, (size, self.capacity))
        plan = self._upload(np.stack([ids, steps]).astype(np.int64))
        w = self.weights
        if straggle is not None:
            # the straggler leaves this round's barrier: weight 0, the
            # others renormalized; self.weights stays as it is
            alive = self._alive()
            alive[straggle[0]] = False
            w = renormalize_weights(self.weights, alive)
        weights = self._upload(w)
        mets, quars, delta = [], [], None

        def update(prev, part):
            """Round's gate and aggregation; the straggler's delta."""
            nonlocal delta
            with _span("train.aggregate"):
                new = self._updates(prev, part, update_fault)
                if straggle is not None:  # its delta, zero if not sampled
                    pos = np.flatnonzero(part.ids == straggle[0])
                    delta = [(x[int(pos[0])].float() - p.float()) if pos.size
                             else torch.zeros(p.shape, device=self.device)
                             for p, x in zip(prev, new)]
                quars.append(self._aggregate(prev, update_fault, part,
                                             weights, new))

        # the split: up to the last round's local steps, then its
        # aggregation and the copy
        with _span("train.local_steps", rounds=size,
                   rounds_per_program=size):
            for r in range(size):
                if cohort:
                    part = self._cohort_part(ids[r], plan[0, r], plan[1, r])
                else:
                    part = self._full_part(plan[1, r])
                with torch.no_grad():  # every slot holds the global state
                    prev = [x[0].clone() for x in agg_leaves(part.stack)]
                mets.append(self._local_steps(e + r, part))
                if r < size - 1:
                    update(prev, part)
            self._sync()
        t1 = time.perf_counter()
        with _span("train.aggregate.sync", rounds=size):
            update(prev, part)
            mets, quars = torch.stack(mets), torch.stack(quars)
            flags = [torch.isfinite(mets).all()]
            if delta is not None:
                flags.append(torch.stack([torch.isfinite(d).all()
                                          for d in delta]).all())
        with _span("train.monitor", pulled=True):
            host = self._to_host(torch.cat([
                mets.flatten(), quars.to(torch.float32).flatten(),
                torch.stack(flags).to(torch.float32)]))
        t2 = time.perf_counter()
        self.round_split["local_steps"].append(t1 - t0)
        self.round_split["aggregate"].append(t2 - t1)
        n = mets.numel()
        metrics = host[:n].reshape(mets.shape)
        quar = host[n:n + quars.numel()].reshape(quars.shape) > 0.5
        flags = host[n + quars.numel():] > 0.5
        self.last_metrics, self.last_quarantined = metrics[-1], quar[-1]
        self.last_cohort = ids[-1].copy() if cohort else None
        return {"metrics": metrics, "quarantined": quar,
                "finite": bool(flags[0]),
                "cohort": ids.copy() if cohort else None,
                "delta": delta,
                "delta_finite": bool(flags[1]) if delta is not None else None}

    def _strike(self, res: dict, e: int) -> None:
        """Count the gate's strikes of a chunk from round ``e`` (charged
        through the cohort's ids when one was sampled) and evict repeat
        offenders."""
        q = res["quarantined"]
        if not q.any():
            return
        ids = res["cohort"]
        if ids is not None:
            counts = np.zeros(len(self._strikes), dtype=np.int64)
            np.add.at(counts, ids[q].ravel(), 1)
        else:
            counts = q.sum(axis=0).astype(np.int64)
        self._strikes += counts
        _QUARANTINED_TOTAL.inc(int(counts.sum()))
        metrics, size = res["metrics"], len(q)
        for idx in np.flatnonzero(counts):
            sel = (q & (ids == idx)) if ids is not None else None
            if sel is None:
                sel = np.zeros_like(q)
                sel[:, idx] = q[:, idx]
            tripped = ("nonfinite" if not np.isfinite(metrics[sel]).all()
                       else "norm_outlier")
            if size == 1:
                log.warning("update gate quarantined client %d in round %d "
                            "(%s; strikes %d/%d)", idx, e, tripped,
                            self._strikes[idx], self.quarantine_strikes)
            else:
                log.warning("update gate quarantined client %d for %d of "
                            "rounds %d..%d (%s; strikes %d/%d)", idx,
                            counts[idx], e, e + size - 1, tripped,
                            self._strikes[idx], self.quarantine_strikes)
            _emit_event("quarantine", client=int(idx),
                        rounds=int(counts[idx]), first=e, last=e + size - 1,
                        strikes=int(self._strikes[idx]), test=tripped)
        for idx in np.flatnonzero(self._strikes >= self.quarantine_strikes):
            if int(idx) not in self.dropped_clients:
                self.drop_client(int(idx), f"quarantined {self._strikes[idx]} "
                                 f"rounds (strike limit "
                                 f"{self.quarantine_strikes})")

    @staticmethod
    def _warn_nonfinite(metrics: np.ndarray, q: np.ndarray, e: int) -> None:
        """Warn of non-finite losses of a client the gate did not contain
        (one round's (P, 3) metrics and (P,) mask)."""
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

    def _emit(self, event: dict) -> None:
        """A ``client_joined`` event, journaled and kept in
        :attr:`last_admission`."""
        _emit_event(**event)
        self.last_admission.append(event)

    def _event(self, type: str, **fields) -> None:
        """A journal event that :attr:`events` keeps too."""
        self.events.append({"type": type, **fields})
        _emit_event(type, **fields)

    @torch.no_grad()
    def _apply_buffered(self, e: int) -> None:
        """Land every queued straggler delta due by round ``e`` in every
        slot, scaled by ``weight * staleness_discount ** staleness``; a
        delta of a dropped client is discarded, a non-finite one is a
        strike and never applied (``federated.py:1203-1254``)."""
        due = [u for u in self._buffered if u["arrival"] <= e]
        if not due:
            return
        self._buffered = [u for u in self._buffered if u["arrival"] > e]
        for upd in due:
            idx = int(upd["client"])
            if idx in self.dropped_clients:
                continue
            if not upd["finite"]:
                self._strikes[idx] += 1
                _QUARANTINED_TOTAL.inc()
                self._event("quarantine", client=idx, rounds=1, first=e,
                            last=e, strikes=int(self._strikes[idx]),
                            buffered=True)
                continue
            eff = float(upd["weight"]) * (
                self.cfg.staleness_discount ** upd["staleness"])
            for x, d in zip(agg_leaves(self.stack), upd["delta"]):
                x.copy_((x.float() + d * eff).to(x.dtype))
            self._buffered_applied += 1
            self._event("aggregate", round=e, first=e,
                        rounds_per_program=1, aggregator="buffered",
                        clients=1, client=idx, origin=int(upd["origin"]),
                        staleness=int(upd["staleness"]),
                        discount=round(eff, 8))

    def _chunk_size(self, e: int, end: int, firing: set, max_rounds: int,
                    plan, update_fault):
        """``(size, update fault, straggler)`` of the chunk from round
        ``e`` (``federated.py:1314-1350``): up to the next hook round and
        ``max_rounds``, clipped at the kill round, the update-fault and
        straggle windows and the next buffered arrival."""
        nxt = min((f for f in firing if f >= e), default=end - 1)
        size = min(nxt - e + 1, max_rounds, end - e)
        if plan is not None and plan.kill_rank \
                and e + 1 < plan.kill_round <= e + size:
            size = plan.kill_round - 1 - e
        if update_fault is None:
            update_fault, size = update_fault_window(plan, e, size)
        straggle = None
        if self.cfg.aggregation == "buffered":
            straggle, size = straggle_window(plan, e, size)
            if straggle is not None:
                size = 1  # each straggling round's delta is queued
        return size, update_fault, straggle

    def fit(self, epochs: int, log_every: int = 0, sample_hook=None,
            hook_epochs=None, update_fault=None, health_cb=None,
            max_rounds_per_call: int = 1) -> "FederatedTrainer":
        """Run ``epochs`` rounds; ``sample_hook(epoch, self)`` after each
        round (or only the rounds in ``hook_epochs``).

        Rounds run in chunks of up to ``max_rounds_per_call`` (the module
        docstring); a chunk ends at every hook round.  ``update_fault``
        ``(kind, client, factor)`` corrupts that client's update after its
        local steps in every round of this call: ``"nan"``, ``"scale"``
        (``prev + factor * delta``) or ``"stuck"`` (the pre-round values).
        Without it, the active fault plan's update fault applies in the
        rounds of its window.

        ``health_cb(first_round, metrics)`` gets each chunk's ``loss_d``,
        ``pen`` and ``loss_g`` as (K, P) host arrays, ``quarantined`` and,
        under a cohort, its ``cohort`` ids (K, C), after the strikes and
        before the sample hook; an exception it raises ends the call with
        the chunk's state in place and its rounds not counted.  Each round
        of a chunk is charged the chunk's mean time, the last one the
        residual and its hook."""
        if max_rounds_per_call < 1:
            raise ValueError(f"max_rounds_per_call={max_rounds_per_call}: "
                             "must be >= 1")
        e = self.completed_epochs
        end = e + epochs
        if sample_hook is None:
            firing = set()
        elif hook_epochs is None:
            firing = set(range(e, end))
        else:
            firing = {x for x in hook_epochs if e <= x < end}
        while e < end:
            # the round driver's own work is this span's self time
            with _span("train.fit.chunk"):
                plan = active_plan()
                self._fault_kill(plan, e)
                size, fault, straggle = self._chunk_size(
                    e, end, firing, max_rounds_per_call, plan, update_fault)
                self._apply_buffered(e)
                if self._buffered:  # the next arrival lands on a boundary
                    size = min(size, max(1, min(u["arrival"] for u in
                                                self._buffered) - e))
                t0 = time.perf_counter()
                res = self._run_chunk(e, size, fault, straggle)
                if straggle is not None:
                    idx, delay = straggle
                    self._buffered.append({
                        "client": int(idx), "origin": e,
                        "arrival": e + max(1, int(delay)),
                        "staleness": max(1, int(delay)),
                        "weight": float(self.weights[idx]),
                        "delta": res["delta"], "finite": res["delta_finite"]})
                metrics, q = res["metrics"], res["quarantined"]
                if not res["finite"]:
                    for r in range(size):
                        self._warn_nonfinite(metrics[r], q[r], e + r)
                self._strike(res, e)
                if health_cb is not None:
                    host = {name: metrics[:, :, j]
                            for j, name in enumerate(METRICS)}
                    host["quarantined"] = q.astype(np.float32)
                    if res["cohort"] is not None:
                        host["cohort"] = res["cohort"]
                    health_cb(e, host)
                t_chunk = time.perf_counter() - t0
                per_round = t_chunk / size
                last = e + size - 1
                for ei in range(e, e + size):
                    charge = (t_chunk - per_round * (size - 1) if ei == last
                              else per_round)
                    self.phase_times["train_aggregate"].append(charge)
                    self.phase_times["distribution"].append(0.0)
                    self.epoch_times.append(charge)
                    self.completed_epochs += 1
                if last in firing:
                    t1 = time.perf_counter()
                    with _span("train.snapshot", round=last):
                        sample_hook(last, self)
                    t_hook = time.perf_counter() - t1
                    self.phase_times["distribution"][-1] = t_hook
                    self.epoch_times[-1] += t_hook
                self._journal_chunk(e, size, res, per_round)
                if log_every and any(x % log_every == 0
                                     for x in range(e, e + size)):
                    m = metrics.reshape(-1, len(METRICS)).mean(axis=0)
                    print(f"round {last}: loss_d={m[0]:.3f} pen={m[1]:.3f} "
                          f"loss_g={m[2]:.3f} "
                          f"({self.epoch_times[-1]:.3f}s/round)")
                e += size
        return self

    def _journal_chunk(self, e: int, size: int, res: dict,
                       per_round: float) -> None:
        """The chunk's counters and events, one ``round``, ``aggregate``
        (and ``cohort`` under a cohort or buffered aggregation) per
        logical round, then the contribution ledger and ``/healthz``
        (``fed_tgan_tpu/train/federated.py:1547-1589``); host values
        only."""
        _ROUNDS_TOTAL.inc(size)
        _CHUNKS_TOTAL.inc()
        ok = bool(res["finite"])
        n_live = self.n_clients - len(self.dropped_clients)
        for ei in range(e, e + size):
            _emit_event("round", round=ei, first=e, rounds_per_program=size,
                        per_round_s=round(per_round, 6), finite=ok)
            _emit_event("aggregate", round=ei, first=e,
                        rounds_per_program=size,
                        aggregator=self.cfg.aggregator, clients=n_live)
        ids = res["cohort"]
        if ids is not None or self.cfg.aggregation == "buffered":
            stale: dict = {}
            for u in self._buffered:
                stale[str(u["staleness"])] = stale.get(
                    str(u["staleness"]), 0) + 1
            for r, ei in enumerate(range(e, e + size)):
                _emit_event(
                    "cohort", round=ei, first=e, rounds_per_program=size,
                    population=self.n_clients,
                    cohort=int(ids[r].size) if ids is not None else n_live,
                    clients=(sorted(int(x) for x in ids[r])
                             if ids is not None else []),
                    buffered_pending=len(self._buffered),
                    buffered_applied=self._buffered_applied,
                    staleness=stale)
        self._publish_round_obs(e, size, res, per_round, ok)

    def _publish_round_obs(self, e: int, size: int, res: dict,
                           per_round_s: float, ok: bool) -> None:
        """Per-client contribution ledger and live health from host
        state (``fed_tgan_tpu/train/federated.py:816-895``): the chunk's
        one host copy (``res``), :attr:`weights`, the strikes, clocks.
        One ``client_contribution`` event per logical round; the
        labelled registry series hold the last round's view."""
        n_live = self.n_clients - len(self.dropped_clients)
        health = dict(
            status="training", round=int(e + size - 1),
            rounds_per_s=(round(1.0 / per_round_s, 3)
                          if per_round_s > 0 else None),
            per_round_s=round(per_round_s, 6), finite=bool(ok),
            population=int(self.n_clients), live_clients=int(n_live),
            dropped_clients=sorted(int(i) for i in self.dropped_clients),
            strikes_total=int(self._strikes.sum()),
            clients_with_strikes=int((self._strikes > 0).sum()))
        if res["cohort"] is not None:
            health["cohort_size"] = int(res["cohort"].shape[-1])
        get_health().update(**health)
        if get_journal() is None:
            return

        def num(x):
            return round(float(x), 6) if np.isfinite(x) else None

        metrics = res["metrics"].astype(np.float64)
        ld, lg = METRICS.index("loss_d"), METRICS.index("loss_g")
        ids = None
        for r in range(size):
            if res["cohort"] is not None:
                ids, sel = res["cohort"][r].astype(int), slice(None)
            else:
                # resident clients only: padded elastic slots are
                # capacity, not clients
                ids = np.arange(self.n_clients)
                sel = ids
            _emit_event(
                "client_contribution", round=e + r, first=e,
                rounds_per_program=size, clients=[int(i) for i in ids],
                # unrounded: a round's weights sum to 1 within float32
                weights=[float(self.weights[i]) for i in ids],
                loss_d=[num(v) for v in metrics[r][sel, ld]],
                loss_g=[num(v) for v in metrics[r][sel, lg]],
                quarantined=[int(b) for b in res["quarantined"][r][sel]],
                strikes=[int(self._strikes[i]) for i in ids])
        reg = get_registry()
        for i in ids:
            if i >= _LEDGER_LABEL_CAP:
                continue
            lab = {"client": str(int(i))}
            reg.gauge("fed_tgan_client_weight",
                      "similarity aggregation weight",
                      labels=lab).set(float(self.weights[i]))
            reg.gauge("fed_tgan_client_strikes",
                      "quarantine strikes accumulated",
                      labels=lab).set(float(self._strikes[i]))

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
        _DROPPED_TOTAL.inc()
        _emit_event("client_dropped", client=int(idx), reason=reason,
                    survivors=survivors)
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
        clients kept at 0.  Each newcomer is journaled as a
        ``client_joined`` event, its dict kept in :attr:`last_admission`."""
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
            self._bn0 = self._slot0_bn()
        longest = max(len(m) for m in new_init.client_matrices)
        if longest > self._stride:
            self._stride = _next_pow2(longest)
            repacked = True
        first_new = self.n_clients
        self.init = new_init
        self.n_clients = n_total
        with _span("init.shard_packing", clients=n_total):
            self._pack(new_init)
        self.weights = np.zeros(self.capacity, dtype=np.float32)
        self.update_weights(np.asarray(new_init.weights, dtype=np.float32))
        self.timings["shard_packing"] = time.perf_counter() - t0
        self._emit_packing(new_init, self.timings["shard_packing"])
        self.last_admission = []
        for idx in range(first_new, n_total):
            self._emit({
                "type": "client_joined", "client": int(idx),
                "round": int(self.completed_epochs), "population": n_total,
                "capacity": int(self.capacity),
                "weight": round(float(self.weights[idx]), 8),
                "rows": int(len(new_init.client_matrices[idx])),
                "repacked": bool(repacked), "reason": reason})
        log.info("admitted %d newcomer(s) (population %d -> %d, capacity "
                 "%d%s)", n_total - first_new, first_new, n_total,
                 self.capacity, ", repacked" if repacked else "")
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

    def _global_model(self, use_ema: Optional[bool] = None) -> dict:
        """The generator every sampling surface reads, as a ``Generator``
        ``state_dict`` on the trainer's device: the debiased EMA
        (``ema / (1 - d ** n)``) once a round has been folded into it, or
        with ``use_ema=False`` (and before the first round) the
        aggregate, slot 0's copy (``federated.py:1604-1627``)."""
        if use_ema is None:
            use_ema = self.ema is not None and self._ema_updates > 0
        G = self.stack.generator
        if not use_ema:
            return {k: v.detach().clone() for k, v in
                    G.client_state(0).items()}
        if self.ema is None:
            raise ValueError("EMA sampling requested but cfg.ema_decay=0")
        if self._ema_updates == 0:
            raise ValueError("EMA sampling requested before any round")
        scale = 1.0 / (1.0 - self.cfg.ema_decay ** self._ema_updates)
        params, bn = (x * scale for x in self.ema)
        return G.flat_state(params, bn, G.num_batches[0].clone())

    def _sampler(self, use_ema: Optional[bool] = None) -> SamplingEngine:
        """The engine over :meth:`_global_model`'s generator (refreshed
        on every call)."""
        if self._engine is None:
            synth = SavedSynthesizer(self.stack.generator.unstack(0),
                                     self.server_cond, self.columns, self.cfg,
                                     key_offset=KEY_OFFSET)
            self._engine = SamplingEngine(LoadedModel(
                model_id="in-memory", synth=synth, meta=self.init.global_meta,
                encoders=tuple(self.init.encoders), artifact=None))
        gen = self._engine.model.synth.generator
        gen.load_state_dict(self._global_model(use_ema))
        return self._engine

    def sample_encoded(self, n: int, seed: int = 0,
                       use_ema: Optional[bool] = None) -> np.ndarray:
        """``n`` activated rows of stream ``seed`` (encoded layout)."""
        return self._sampler(use_ema).sample_encoded(n, seed=seed)

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
        """The generator of :meth:`_global_model` as a sampling
        artifact."""
        return SavedSynthesizer(
            self.stack.generator.module(self._global_model()),
            self.server_cond, self.columns, self.cfg, key_offset=KEY_OFFSET)

    def write_timing(self, out_dir: str = ".") -> None:
        write_timing(out_dir, self.epoch_times, self.phase_times)


def write_timing(out_dir: str, epoch_times: list, phase_times: dict) -> None:
    """``timestamp_experiment.csv`` (one wall-clock value per round) and
    ``timing_phases.csv`` (epoch, train_aggregate_s, distribution_s,
    total_s), the reference's layout."""
    with open(os.path.join(out_dir, "timestamp_experiment.csv"), "w") as f:
        csv.writer(f).writerows([[t] for t in epoch_times])
    with open(os.path.join(out_dir, "timing_phases.csv"), "w") as f:
        w = csv.writer(f)
        w.writerow(["epoch", "train_aggregate_s", "distribution_s",
                    "total_s"])
        for i, t in enumerate(epoch_times):
            w.writerow([i, phase_times["train_aggregate"][i],
                        phase_times["distribution"][i], t])


@torch.no_grad()
def aggregate_updates(prev: list, new: list, weights: torch.Tensor,
                      steps: torch.Tensor, cfg: TrainConfig,
                      robust: bool = False) -> tuple:
    """``(aggregate, quarantine mask (P,))`` of the participants' stacked
    leaves ``new`` (P, ...) against the global pre-round ``prev`` at
    ``weights`` (P,), ``steps`` (P,) their local steps: the update gate
    and ``cfg.aggregator`` (:func:`robust_aggregate`) when either can act
    or ``robust`` asks for it (an injected update fault), else the plain
    weighted average, through the bf16 delta payload under ``precision=
    "bf16"``.  The in-process round and every participant of a
    multi-process world (:mod:`fed_tgan_torch.train.multihost`) call it
    on the same stacked input."""
    payload = resolve_precision(cfg.precision).payload_dtype
    if cfg.update_gate or cfg.aggregator != "weighted" or robust:
        return robust_aggregate(
            prev, new, weights, steps, aggregator=cfg.aggregator,
            update_gate=cfg.update_gate,
            gate_norm_factor=cfg.gate_norm_factor,
            update_clip=cfg.update_clip, trim_ratio=cfg.trim_ratio,
            payload_dtype=payload)
    agg = (weighted_delta_average(prev, new, weights, payload)
           if payload is not None else weighted_average(new, weights))
    return agg, torch.zeros(new[0].shape[0], dtype=torch.bool,
                            device=new[0].device)


@torch.no_grad()
def fold_ema(ema: list, G, bn: torch.Tensor, decay: float) -> None:
    """``ema = d * ema + (1 - d) * x`` for the aggregated generator's flat
    weights and the running statistics at ``bn`` (one slot's)."""
    for e_, n in zip(ema, (G.params[0], G.bn_state[bn])):
        e_.copy_(decay * e_ + (1.0 - decay) * n)


def corrupt_updates(prev: list, new: list, fault, positions=None) -> list:
    """``fault = (kind, client, factor)`` applied to that client's stacked
    leaves (at ``positions`` of the stack, default the client's own index;
    none when the client is not among the round's participants): ``nan``
    fills them with NaN, ``scale`` gives ``prev + factor * (new - prev)``,
    ``stuck`` the pre-round values
    (``fed_tgan_tpu/train/federated.py:286-307``)."""
    kind, idx, factor = fault
    if kind not in ("nan", "scale", "stuck"):
        raise ValueError(f"unknown update fault {kind!r}")
    pos = [idx] if positions is None else [int(p) for p in positions]
    out = []
    for p, x in zip(prev, new):
        x = x.clone()
        for i in pos:
            if kind == "nan":
                x[i] = torch.nan
            elif kind == "scale":
                x[i] = p + factor * (x[i] - p)
            else:
                x[i] = p
        out.append(x)
    return out
