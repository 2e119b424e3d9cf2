"""MD-GAN split-model training: one shared generator, one discriminator
per client (counterpart of ``fed_tgan_tpu/train/mdgan.py:1-382``).

The reference's MD-GAN path (GDTS) keeps one generator on the server and
a local discriminator on every client; discriminators are never averaged.
A step, for every client at once, masked to the clients still inside
their own step count (``s < steps_i``, ``mdgan.py:101-218``):

- the critic step: the shared generator in train mode over each client's
  batch (each client's BatchNorm over its own rows, from the shared
  running statistics), K1 over (N * batch, D), the client's critic loss
  and slerp penalty, the client's Adam;
- the generator feedback: the generator from the BatchNorm state of that
  client's critic forward, K1 forward and K2 backward against the
  client's updated critic, plus ``cond_loss``;
- the update: the generator's gradient is ``sum_i w_i * grad loss_i /
  max(sum_i w_i, 1)`` (``w_i`` 1 for a client that stepped), one Adam step
  on the generator, and its running statistics become the mean of the
  stepped clients'.

The clients' generators are one :class:`StackedGenerator` whose N slices
are ``expand`` views of one parameter vector: each client's loss is
weighted by ``w_i / max(sum w, 1)`` before one backward pass, and the
backward of ``expand`` sums the clients' gradients in a fixed order (no
atomics), so a run repeats bit for bit.  The critic step and the
generator's loss are the federated round's own
(:func:`~fed_tgan_torch.train.steps.stacked_train_step`'s parts).

One critic step a generator step whatever ``d_steps`` is, with the JAX
key layout ``split(fold_in(fold_in(key, client), s), 13)`` (critic keys
0-8, generator keys 9-12), so the federated trainer's injected draws
(:data:`~fed_tgan_torch.train.federated.Draws`) apply unchanged.  A
client's metrics are means over the steps it ran.  Snapshots sample the
shared generator (eval BatchNorm) through the slice-1 engine at the JAX
trainer's key offset 29.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.federation.init import FederatedInit
from fed_tgan_torch.models.ctgan import StackedDiscriminator, StackedGenerator
from fed_tgan_torch.ops.decode import select_snapshot_decode
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.checkpoint import SavedSynthesizer
from fed_tgan_torch.serve.engine import SamplingEngine, step_seed
from fed_tgan_torch.serve.registry import LoadedModel
from fed_tgan_torch.train.federated import (
    KEY_OFFSET,
    METRICS,
    Draws,
    FederatedTrainer,
    build_client_stacks,
)
from fed_tgan_torch.train.steps import (
    Models,
    StackedAdam,
    StackedModels,
    TrainConfig,
    _grads,
    _stacked_d_update,
    client_draws,
    draw_into,
    init_models,
    require_trainable,
    stacked_draws,
    stacked_g_loss,
)


@dataclasses.dataclass
class GeneratorBundle:
    """The server's half: the shared generator's flat weights (1, P), its
    running statistics (2 * sum(widths),) block by block (mean, then
    variance), its train-mode batch count and its Adam."""

    params: torch.Tensor
    state: torch.Tensor
    batches: torch.Tensor
    opt: StackedAdam


@dataclasses.dataclass
class DiscriminatorBundle:
    """The clients' halves: N stacked discriminators and their Adam."""

    stack: StackedDiscriminator
    opt: StackedAdam


class MDGANTrainer:
    """Split-model training from a finished :class:`FederatedInit` on
    ``device`` (the card unless the caller asks for the CPU).  ``models``
    (tests, interop) replaces the initial models: one :class:`Models`
    whose generator is shared and whose discriminator every client
    starts from, as JAX's ``init_models(key(seed + 1))``; ``draws``
    (tests) replaces every step's draws."""

    def __init__(self, init: FederatedInit,
                 config: Optional[TrainConfig] = None, seed: int = 0,
                 device="cuda", decode: str = "packed8",
                 models: Optional[Models] = None,
                 draws: Optional[Draws] = None):
        self.init = init
        self.cfg = config or TrainConfig()
        require_trainable(self.cfg)
        self.device = resolve_device(device)
        self.seed = seed
        self.draws = draws
        self.n_clients = n = len(init.client_matrices)
        self.spec = SegmentSpec.from_output_info(init.output_info)
        t0 = time.perf_counter()
        (self.conds, self.rows, self.data, self.steps,
         self.server_cond) = build_client_stacks(init, self.cfg, self.spec,
                                                 self.device)
        self.timings = {"shard_packing": time.perf_counter() - t0}
        if models is None:
            models = init_models(self.spec, self.cfg, seed + 1, self.device)
        one = StackedGenerator.from_modules([models.generator])
        G = StackedGenerator(n, *one.dims, device=self.device)
        shared = one.params.detach().clone().requires_grad_(True)
        G.params = shared.expand(n, -1)  # every client's slice: one vector
        self.gen = GeneratorBundle(
            shared, one.bn_state.clone(), one.num_batches[0].clone(),
            StackedAdam(shared, self.cfg, self.cfg.l2scale))
        D = StackedDiscriminator.from_modules([models.discriminator] * n)
        self.disc = DiscriminatorBundle(D, StackedAdam(D.params, self.cfg))
        # one critic step a generator step, whatever d_steps is
        self._cfg1 = dataclasses.replace(self.cfg, d_steps=1)
        self._stack = StackedModels(G, D, self.gen.opt, self.disc.opt,
                                    self.spec, self._cfg1)
        # the entry of the shared running statistics each client's copies
        self._bn_src = one.bn_index(torch.zeros(n, dtype=torch.long,
                                                device=self.device))
        keep = [s[1:] for s in D.keep_shapes(self.cfg.batch_size)]
        self._keep = keep
        self._draws = stacked_draws(self.spec, self._cfg1, n, keep,
                                    self.device)
        self._client_draws = [client_draws(self._draws, i) for i in range(n)]
        self.gens = [torch.Generator(device=self.device).manual_seed(
            step_seed(self.seed, i)) for i in range(n)]

        self.columns = init.transformers[0].columns
        self.decode = select_snapshot_decode(self.columns, decode)
        self._engine: Optional[SamplingEngine] = None
        self.epoch_times: list[float] = []
        self.phase_times = {"train_aggregate": [], "distribution": []}
        self.completed_epochs = 0
        self.last_metrics: Optional[np.ndarray] = None
        self.run_name: Optional[str] = None  # set by load_federated
        self.host_copies = 0

    # ------------------------------------------------------------ the step

    def set_lr(self, lr: float) -> None:
        """Set every learning rate to ``lr`` from the next update on."""
        self.cfg = dataclasses.replace(self.cfg, lr=float(lr))
        self._cfg1 = dataclasses.replace(self._cfg1, lr=float(lr))
        self._stack.set_config(self._cfg1)

    def _step(self, e: int, s: int, acc: torch.Tensor) -> None:
        """Step ``s`` of round ``e`` for every client at once; adds the
        stepped clients' ``(loss_d, pen, loss_g)`` into ``acc`` (N, 3)."""
        steps, G = self.steps, self._stack.generator
        G.params = self.gen.params.expand(G.n, -1)
        for i in np.flatnonzero(s < steps):
            dst = self._client_draws[i]
            if self.draws is not None:
                for a, b in zip(dst.tensors(), self.draws(e, int(i), s)
                                .tensors()):
                    a.copy_(b)
            else:
                draw_into(self.gens[i], self.spec, self._cfg1, self._keep,
                          self.device, dst)
        active = s < self._steps_dev
        with torch.no_grad():  # every client's BatchNorm from the shared
            G.bn_state.copy_(self.gen.state[self._bn_src])
        loss_d, pen = _stacked_d_update(self._stack, self.data, self.conds,
                                        self.rows, self._draws.d[0], active)
        loss_g = stacked_g_loss(self._stack, self.conds, self._draws.g)
        w = active.to(torch.float32)
        denom = torch.clamp(w.sum(), min=1.0)
        (grad,) = _grads([self.gen.params], (loss_g * (w / denom)).sum())
        with torch.no_grad():
            # some client steps at every s below max(steps)
            self.gen.opt.step(grad, torch.ones(1, dtype=torch.bool,
                                               device=self.device))
            bn, start = G.bn_state, 0
            for h in G.widths:
                for _ in range(2):  # mean, then variance
                    block = bn[start * G.n:(start + h) * G.n].view(G.n, h)
                    self.gen.state[start:start + h] = (
                        block * w[:, None]).sum(dim=0) / denom
                    start += h
            self.gen.batches.add_(2)
            met = torch.stack([loss_d, pen, loss_g.detach()], dim=1)
            acc.add_(torch.where(active[:, None], met, 0.0))

    def run_round(self, e: int) -> np.ndarray:
        """Round ``e``: ``max(steps)`` steps; returns each client's
        (N, 3) metrics, means over the steps it ran, on the host (one
        copy)."""
        acc = torch.zeros((self.n_clients, len(METRICS)), device=self.device)
        self._steps_dev = torch.as_tensor(self.steps, device=self.device)
        for s in range(int(self.steps.max(initial=0))):
            self._step(e, s, acc)
        per = acc / torch.clamp(self._steps_dev, min=1)[:, None].to(
            torch.float32)
        self.host_copies += 1
        # the round's one host copy
        # torchlint: disable=J01
        self.last_metrics = per.cpu().numpy()
        return self.last_metrics

    def fit(self, epochs: int, log_every: int = 0, sample_hook=None,
            hook_epochs=None, health_cb=None) -> "MDGANTrainer":
        """Run ``epochs`` rounds; ``sample_hook(epoch, self)`` after each
        (or only the rounds in ``hook_epochs``); ``health_cb(round,
        metrics)`` gets each round's (1, N) losses before the hook."""
        e = self.completed_epochs
        end = e + epochs
        firing = (set() if sample_hook is None else set(range(e, end))
                  if hook_epochs is None else set(hook_epochs))
        while e < end:
            t0 = time.perf_counter()
            metrics = self.run_round(e)
            if not np.isfinite(metrics).all():
                print(f"WARNING: non-finite losses at round {e}: training "
                      "has diverged (lower the learning rate)")
            if health_cb is not None:
                health_cb(e, {name: metrics[None, :, j]
                              for j, name in enumerate(METRICS)})
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
                print(f"mdgan round {e}: loss_d={m[0]:.3f} "
                      f"loss_g={m[2]:.3f} ({self.epoch_times[-1]:.3f}s)")
            e += 1
        return self

    # ------------------------------------------------------------ sampling

    def _global_model(self) -> dict:
        """The shared generator as a ``Generator.state_dict()`` (copies):
        global by design (``mdgan.py:330-332``)."""
        return {k: v.clone() for k, v in self._stack.generator.flat_state(
            self.gen.params.detach()[0], self.gen.state,
            self.gen.batches).items()}

    def _sampler(self) -> SamplingEngine:
        """The engine over the shared generator (refreshed on every
        call)."""
        if self._engine is None:
            self._engine = SamplingEngine(LoadedModel(
                model_id="in-memory", synth=self.to_saved(),
                meta=self.init.global_meta,
                encoders=tuple(self.init.encoders), artifact=None))
        self._engine.model.synth.generator.load_state_dict(
            self._global_model())
        return self._engine

    def sample_encoded(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` activated rows of stream ``seed`` (encoded layout)."""
        return self._sampler().sample_encoded(n, seed=seed)

    # the federated trainer's, over this trainer's _sampler
    sample_parts = FederatedTrainer.sample_parts
    sample = FederatedTrainer.sample

    def to_saved(self) -> SavedSynthesizer:
        """The shared generator as a sampling artifact."""
        return SavedSynthesizer(
            self._stack.generator.module(self._global_model()),
            self.server_cond, self.columns, self.cfg, key_offset=KEY_OFFSET)

    def save_time_stamp(self, out_dir: str = ".") -> None:
        """``time_train_d.csv`` and ``time_loss_g.csv``: one wall-clock
        value per round (``mdgan.py:376-382``; the reference timed each
        client's per-batch RPC, which no longer exists)."""
        for name in ("time_train_d.csv", "time_loss_g.csv"):
            with open(os.path.join(out_dir, name), "w") as f:
                csv.writer(f).writerows([[t] for t in self.epoch_times])

    write_timing = FederatedTrainer.write_timing
