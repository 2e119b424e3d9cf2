"""Training configuration, the CTGAN train step and the sampling step
(counterpart of ``fed_tgan_tpu/train/steps.py:40-426``).

One train step is the reference's hot loop (Server/dtds/distributed.py:
328-417), in the JAX step's order:

- D step(s): z and a conditional vector; a permuted class-conditional real
  batch; the fake batch from the generator in train mode (no gradient, but
  its BatchNorm statistics move); the activation (K1); the WGAN critic
  loss plus the slerp gradient penalty; Adam on D.
- G step: fresh z and conditional vector; the generator in train mode from
  the BatchNorm state the D step left; the activation with a gradient (K1
  forward, K2 backward); ``-mean(D(fake)) + cond_loss``; Adam with L2 on G.

Every random tensor of a step is one :class:`StepDraws` value:
:func:`draw_step` fills it from a ``torch.Generator`` on the device, and
the tests fill it from the JAX package's key layout.

Mixed precision (``TrainConfig.precision``, :mod:`fed_tgan_torch.runtime.
precision`): the generator's inputs and the real batch are cast to the
compute dtype (bf16) at the start of each update, the models compute in
it, and the loss means are float32 islands.  The master parameters, the
BatchNorm state and every Adam moment stay float32: the gradients come back
float32 through the casts.  In f32 every cast is the tensor itself.

The federated round trains every client at once:
:func:`stacked_train_step` is :func:`train_step` over the clients of a
:class:`StackedModels` (stacked modules, :class:`StackedAdam` with a step
count per client), each step masked to the clients still inside their own
step count, as the JAX program's ``vmap`` over a fixed-trip ``lax.scan``
(``fed_tgan_tpu/train/federated.py:237-270``).  :func:`train_step` stays
the standalone trainer's step and the reference the stacked one is tested
against.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.models.ctgan import (
    DROPOUT_RATE,
    Discriminator,
    Generator,
    StackedDiscriminator,
    StackedGenerator,
)
from fed_tgan_torch.models.losses import gradient_penalty
from fed_tgan_torch.ops.activate_cuda import fused_apply_activate
from fed_tgan_torch.ops.segments import SegmentSpec, cond_loss
from fed_tgan_torch.runtime.precision import (
    as_dtype,
    f32_island,
    resolve_precision,
)
from fed_tgan_torch.train.sampler import (
    CondSampler,
    RowSampler,
    StackedCondSampler,
    StackedRowSampler,
)


@dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters, with the JAX package's field names and defaults
    (the reference's, Server/dtds/synthesizers/ctgan.py:309-334).  Only
    the standalone trainer's and the sampling fields are read by this
    package so far; the rest (EMA, the federated and robust-aggregation
    knobs) ride along so a JAX artifact's config converts without loss."""

    embedding_dim: int = 128
    gen_dims: tuple = (256, 256)
    dis_dims: tuple = (256, 256)
    batch_size: int = 500
    pac: int = 10
    l2scale: float = 1e-6
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.9
    ema_decay: float = 0.0
    lr_schedule: str = "constant"
    lr_decay_steps: int = 0
    lr_end_frac: float = 0.0
    d_steps: int = 1
    allow_zero_step_clients: bool = False
    aggregator: str = "weighted"
    update_gate: bool = True
    gate_norm_factor: float = 10.0
    update_clip: float = 3.0
    trim_ratio: float = 0.2
    precision: str = "f32"
    cohort: int = 0
    aggregation: str = "sync"
    staleness_discount: float = 0.5


# ------------------------------------------------------------- optimizers


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate after ``count`` earlier updates, by optax's
    formulas (``optax.cosine_decay_schedule`` / ``linear_schedule``):
    optax evaluates a schedule at the count of previous updates, so the
    first update uses ``lr * f(0)``."""
    lr, steps = cfg.lr, cfg.lr_decay_steps
    if cfg.lr_schedule == "constant":
        return lambda count: lr
    if steps <= 0:
        raise ValueError(f"lr_schedule={cfg.lr_schedule!r} needs "
                         "lr_decay_steps > 0 (total optimizer steps the "
                         "decay spans)")
    if cfg.lr_schedule == "cosine":
        alpha = cfg.lr_end_frac
        return lambda count: lr * (
            (1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(count, steps)
                                              / steps)) + alpha)
    if cfg.lr_schedule == "linear":
        end = lr * cfg.lr_end_frac
        return lambda count: (lr - end) * (
            1 - min(max(count, 0), steps) / steps) + end
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                     "(constant | cosine | linear)")


def lr_decay_horizon(lr_schedule: str, epochs: int, max_shard_rows: int,
                     batch_size: int) -> int:
    """A decaying schedule's horizon in optimizer steps: the largest
    client's step count at the last epoch (``steps.py:117``); 0 for the
    constant schedule."""
    if lr_schedule == "constant":
        return 0
    return epochs * max(1, max_shard_rows // batch_size)


def make_optimizers(cfg: TrainConfig, generator: Generator,
                    discriminator: Discriminator):
    """``(opt_g, opt_d, sched_g, sched_d)``: torch Adam, betas (beta1,
    beta2), eps 1e-8; on G ``weight_decay=l2scale``, which adds L2 to the
    gradient before the moments like ``optax.add_decayed_weights`` before
    ``scale_by_adam`` (not AdamW).  The schedulers set each update's
    learning rate from :func:`lr_schedule`."""
    betas = (cfg.beta1, cfg.beta2)
    opt_g = torch.optim.Adam(generator.parameters(), lr=cfg.lr, betas=betas,
                             eps=1e-8, weight_decay=cfg.l2scale)
    opt_d = torch.optim.Adam(discriminator.parameters(), lr=cfg.lr,
                             betas=betas, eps=1e-8)
    factor = lr_factor(cfg)
    return (opt_g, opt_d, torch.optim.lr_scheduler.LambdaLR(opt_g, factor),
            torch.optim.lr_scheduler.LambdaLR(opt_d, factor))


def lr_factor(cfg: TrainConfig) -> Callable[[int], float]:
    """The schedulers' multiplier of ``cfg.lr`` after ``count`` updates."""
    sched = lr_schedule(cfg)
    return lambda count: sched(count) / cfg.lr


@dataclass
class Models:
    """Everything that evolves during training."""

    generator: Generator
    discriminator: Discriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    sched_g: torch.optim.lr_scheduler.LambdaLR
    sched_d: torch.optim.lr_scheduler.LambdaLR
    spec: SegmentSpec
    cfg: TrainConfig

    @classmethod
    def build(cls, generator: Generator, discriminator: Discriminator,
              spec: SegmentSpec, cfg: TrainConfig) -> "Models":
        """Train-mode modules with fresh optimizers."""
        generator.train()
        discriminator.train()
        return cls(generator, discriminator,
                   *make_optimizers(cfg, generator, discriminator), spec, cfg)


def require_trainable(cfg: TrainConfig) -> None:
    """The training options this port runs: a known precision, an EMA
    decay in [0, 1) (the federated trainer's; the standalone one ignores
    it, as JAX's does), at least one critic update per generator step."""
    resolve_precision(cfg.precision)
    if not 0.0 <= cfg.ema_decay < 1.0:
        raise ValueError(f"ema_decay={cfg.ema_decay}: must be in [0, 1)")
    if cfg.d_steps < 1:
        raise ValueError(f"d_steps={cfg.d_steps}: need >= 1 critic update "
                         "per generator step")


def init_models(spec: SegmentSpec, cfg: TrainConfig, seed: int = 0,
                device="cuda") -> Models:
    """Default-initialised generator and discriminator, made on the CPU
    from ``seed`` (so the weights do not depend on ``device``) and moved
    to ``device``."""
    require_trainable(cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator = Generator(cfg.embedding_dim + spec.n_opt, cfg.gen_dims,
                              spec.dim)
        discriminator = Discriminator(spec.dim + spec.n_opt, cfg.dis_dims,
                                      cfg.pac)
    device = resolve_device(device)
    return Models.build(generator.to(device), discriminator.to(device), spec,
                        cfg)


# ------------------------------------------------------------------ draws


@dataclass
class DDraws:
    """The random tensors of one critic update."""

    z: torch.Tensor                # (B, embedding_dim) normal
    col: Optional[torch.Tensor]    # (B,) int64 conditional column
    r: Optional[torch.Tensor]      # (B, 1) uniform behind the option
    perm: Optional[torch.Tensor]   # (B,) int64 permutation of the real batch
    row_u: torch.Tensor            # (B,) uniform behind each real row
    u: torch.Tensor                # (B, dim) Gumbel uniforms
    keep_fake: list                # dropout keep masks per hidden layer
    keep_real: list
    keep_gp: list
    alpha: torch.Tensor            # (B, 1) slerp position per row


@dataclass
class GDraws:
    """The random tensors of one generator update."""

    z: torch.Tensor
    col: Optional[torch.Tensor]
    r: Optional[torch.Tensor]
    u: torch.Tensor
    keep: list


@dataclass
class StepDraws:
    """Every random tensor of one train step: ``d_steps`` critic blocks,
    then the generator's."""

    d: list
    g: GDraws

    def map(self, fn) -> "StepDraws":
        """A copy with ``fn`` applied to every tensor."""
        def one(v):
            if isinstance(v, list):
                return [one(x) for x in v]
            return None if v is None else fn(v)

        def block(b):
            return type(b)(**{f.name: one(getattr(b, f.name))
                              for f in dataclasses.fields(b)})

        return StepDraws(d=[block(b) for b in self.d], g=block(self.g))

    def to(self, device) -> "StepDraws":
        """A copy with every tensor on ``device``."""
        return self.map(lambda t: t.to(device))

    def tensors(self) -> list:
        """Every tensor, in field order."""
        out = []
        self.map(out.append)
        return out


def draw_step(gen: torch.Generator, models: Models,
              out: Optional[StepDraws] = None) -> StepDraws:
    """One step's draws from ``gen`` (on the models' device).  Columns
    are uniform over the conditional columns; dropout keeps with
    probability 0.5.  With ``out`` the draws are written into its tensors
    (which :func:`draw_into` describes) and ``out`` is returned."""
    D = models.discriminator
    return draw_into(gen, models.spec, models.cfg,
                     D.keep_shapes(models.cfg.batch_size), D.out.weight.device,
                     out)


def draw_into(gen: torch.Generator, spec: SegmentSpec, cfg: TrainConfig,
              keep_shapes: list, device, out: Optional[StepDraws] = None
              ) -> StepDraws:
    """:func:`draw_step` for a discriminator whose hidden layers' keep
    masks have ``keep_shapes``.  ``out`` (optional) receives every draw in
    place, in the order they are drawn, so one generator's stream is the
    same whether a client's draws land in tensors of their own or in its
    slice of the stacked clients' draws."""
    B = cfg.batch_size
    has_cond = spec.n_discrete > 0
    slots = out if out is not None else _no_slots(cfg, len(keep_shapes))

    def uniform(shape, dst=None):
        return torch.rand(shape, generator=gen, device=device, out=dst)

    def cond(block):
        if not has_cond:
            return None, None
        col = torch.randint(0, spec.n_discrete, (B,), generator=gen,
                            device=device, out=block.col)
        return col, uniform((B, 1), block.r)

    def normal(dst):
        return torch.randn((B, cfg.embedding_dim), generator=gen,
                           device=device, out=dst)

    def keep(dsts):
        return [torch.lt(uniform(shape), 1.0 - DROPOUT_RATE, out=dst)
                for shape, dst in zip(keep_shapes, dsts)]

    blocks = []
    for slot in slots.d:
        z = normal(slot.z)
        col, r = cond(slot)
        perm = (torch.randperm(B, generator=gen, device=device, out=slot.perm)
                if has_cond else None)
        blocks.append(DDraws(
            z=z, col=col, r=r, perm=perm, row_u=uniform((B,), slot.row_u),
            u=uniform((B, spec.dim), slot.u), keep_fake=keep(slot.keep_fake),
            keep_real=keep(slot.keep_real), keep_gp=keep(slot.keep_gp),
            alpha=uniform((B, 1), slot.alpha)))
    z = normal(slots.g.z)
    col, r = cond(slots.g)
    return StepDraws(d=blocks, g=GDraws(
        z=z, col=col, r=r, u=uniform((B, spec.dim), slots.g.u),
        keep=keep(slots.g.keep)))


def _no_slots(cfg: TrainConfig, n_keep: int) -> StepDraws:
    none = [None] * n_keep
    return StepDraws(d=[DDraws(None, None, None, None, None, None, none, none,
                               none, None) for _ in range(cfg.d_steps)],
                     g=GDraws(None, None, None, None, none))


def stacked_draws(spec: SegmentSpec, cfg: TrainConfig, n: int,
                  keep_shapes: list, device) -> StepDraws:
    """Buffers for N clients' draws of one step, each tensor with a
    leading client axis, filled with valid placeholders (a client that
    does not draw in a step keeps whatever its slice holds)."""
    B, has_cond = cfg.batch_size, spec.n_discrete > 0

    def full(shape, value, dtype=torch.float32):
        return torch.full((n, *shape), value, dtype=dtype, device=device)

    def keep():
        return [torch.ones((n, *shape), dtype=torch.bool, device=device)
                for shape in keep_shapes]

    def cond():
        if not has_cond:
            return None, None
        return full((B,), 0, torch.long), full((B, 1), 0.5)

    blocks = []
    for _ in range(cfg.d_steps):
        col, r = cond()
        perm = (torch.arange(B, device=device).repeat(n, 1) if has_cond
                else None)
        blocks.append(DDraws(
            z=full((B, cfg.embedding_dim), 0.0), col=col, r=r, perm=perm,
            row_u=full((B,), 0.0), u=full((B, spec.dim), 0.5),
            keep_fake=keep(), keep_real=keep(), keep_gp=keep(),
            alpha=full((B, 1), 0.5)))
    col, r = cond()
    return StepDraws(d=blocks, g=GDraws(
        z=full((B, cfg.embedding_dim), 0.0), col=col, r=r,
        u=full((B, spec.dim), 0.5), keep=keep()))


def client_draws(draws: StepDraws, i: int) -> StepDraws:
    """Client ``i``'s slice of stacked draws, as views."""
    return draws.map(lambda t: t[i])


# ------------------------------------------------------------- train step


def _grads(params: list, *losses: torch.Tensor) -> list:
    """The gradient of the sum of ``losses`` with respect to ``params``,
    each loss's gradient from its own backward pass, summed in argument
    order (None where no loss reaches a parameter).

    One backward pass over the critic's loss plus its gradient penalty
    would add several contributions into one weight's gradient in the
    autograd engine's order, which on the card depends on sequence
    numbers that the forward (main thread) and the penalty's double
    backward (the engine's device thread) draw from two counters: the
    order, and the last bits of the gradient, then change with how many
    nodes each thread made before.  Separate passes keep every step
    bit-reproducible, so a resumed run repeats the uninterrupted one."""
    total = None
    for loss in losses:
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        total = grads if total is None else [
            a if b is None else (b if a is None else a + b)
            for a, b in zip(total, grads)]
    return list(total)


def _set_grads(params: list, *losses: torch.Tensor) -> None:
    """``p.grad`` = :func:`_grads` (zeros where no loss reaches ``p``)."""
    for p, g in zip(params, _grads(params, *losses)):
        p.grad = torch.zeros_like(p) if g is None else g


def d_update(models: Models, data: torch.Tensor, cond: CondSampler,
             rows: RowSampler, d: DDraws):
    """One critic update; returns ``(loss_d, pen)``."""
    spec, pac = models.spec, models.cfg.pac
    pol = resolve_precision(models.cfg.precision)
    G, D = models.generator, models.discriminator
    if spec.n_discrete:
        c1, _, col, opt = cond.train_from_draws(d.col, d.r)
        row_idx = rows.sample_rows(col[d.perm], opt[d.perm], d.row_u)
        gen_in = torch.cat([d.z, c1], dim=1)
    else:
        row_idx = rows.sample_uniform(d.row_u)
        gen_in = d.z
    real = data[row_idx]
    with torch.no_grad():  # train-mode BN: the running statistics move
        fake = fused_apply_activate(G(pol.cast(gen_in)), spec, d.u)
    if spec.n_discrete:
        fake_cat = torch.cat([fake, pol.cast(c1)], dim=1)
        real_cat = pol.cast(torch.cat([real, c1[d.perm]], dim=1))
    else:
        fake_cat, real_cat = fake, pol.cast(real)
    y_fake = D(fake_cat, keep=d.keep_fake)
    y_real = D(real_cat, keep=d.keep_real)
    loss_d = f32_island(y_fake).mean() - f32_island(y_real).mean()
    pen = gradient_penalty(lambda x: D(x, keep=d.keep_gp), real_cat,
                           fake_cat, d.alpha, pac=pac)
    _set_grads(list(D.parameters()), loss_d, pen)
    models.opt_d.step()
    models.sched_d.step()
    return loss_d.detach(), pen.detach()


def g_loss(models: Models, cond: CondSampler, g: GDraws) -> torch.Tensor:
    """The generator's loss, with its graph: ``-mean(D(fake)) +
    cond_loss``, the generator in train mode."""
    spec = models.spec
    pol = resolve_precision(models.cfg.precision)
    G, D = models.generator, models.discriminator
    if spec.n_discrete:
        c1, m1, _, _ = cond.train_from_draws(g.col, g.r)
        gen_in = torch.cat([g.z, c1], dim=1)
    else:
        gen_in = g.z
    raw = G(pol.cast(gen_in))
    act = fused_apply_activate(raw, spec, g.u)  # K1 forward, K2 backward
    d_in = torch.cat([act, pol.cast(c1)], dim=1) if spec.n_discrete else act
    loss_g = -f32_island(D(d_in, keep=g.keep)).mean()
    if spec.n_discrete:
        loss_g = loss_g + cond_loss(raw, spec, c1, m1)
    return loss_g


def g_update(models: Models, cond: CondSampler, g: GDraws) -> torch.Tensor:
    """One generator update; returns ``loss_g``."""
    loss_g = g_loss(models, cond, g)
    _set_grads(list(models.generator.parameters()), loss_g)
    models.opt_g.step()
    models.sched_g.step()
    return loss_g.detach()


def train_step(models: Models, data: torch.Tensor, cond: CondSampler,
               rows: RowSampler, draws: StepDraws) -> dict:
    """One D+G update pair in place on ``models``; ``data`` is the encoded
    training matrix on the models' device.  Returns the last critic's
    ``loss_d`` and ``pen`` and the generator's ``loss_g`` as 0-d tensors
    (no host synchronisation).  After it, each parameter's ``.grad`` holds
    the gradient of its last update."""
    if len(draws.d) != models.cfg.d_steps:
        raise ValueError(f"{len(draws.d)} critic draw blocks for d_steps="
                         f"{models.cfg.d_steps}")
    for d in draws.d:
        loss_d, pen = d_update(models, data, cond, rows, d)
    loss_g = g_update(models, cond, draws.g)
    return {"loss_d": loss_d, "pen": pen, "loss_g": loss_g}


def epoch(models: Models, data: torch.Tensor, cond: CondSampler,
          rows: RowSampler, gen: torch.Generator,
          steps_per_epoch: int) -> dict:
    """``steps_per_epoch`` train steps with draws from ``gen``; returns
    the last step's metrics (``make_epoch_step``, ``steps.py:391``)."""
    metrics = {}
    for _ in range(steps_per_epoch):
        metrics = train_step(models, data, cond, rows, draw_step(gen, models))
    return metrics


# ------------------------------------------------------- stacked clients


def restore_optimizer(opt, sched, state: dict, lr: float, step: int) -> None:
    """Install Adam ``state`` (parameter index -> ``step``, ``exp_avg``,
    ``exp_avg_sq`` tensors) into ``opt``, and put its schedule after
    ``step`` updates at learning rate ``lr``."""
    opt.load_state_dict({"state": state,
                         "param_groups": opt.state_dict()["param_groups"]})
    opt.param_groups[0]["lr"] = lr
    sched.last_epoch, sched._step_count, sched._last_lr = step, step + 1, [lr]


class StackedAdam:
    """Adam over N clients' flat parameters ``params`` (N, P), with a step
    count per client: torch's Adam and ``LambdaLR`` (:func:`
    make_optimizers`) client by client, each client's bias correction and
    learning rate ``lr_schedule(cfg)`` at its own count, L2
    (``weight_decay``) added to the gradient before the moments.

    :meth:`step` updates only the clients of its ``active`` mask: the
    parameters, both moments, the kept gradient and the count of every
    other client stay as they were (``torch.where`` after the update, the
    JAX program's ``sel``).  The per-client step size and bias correction
    come from a table indexed by the count, built on the host with torch
    Adam's formulas; past its end neither changes."""

    def __init__(self, params: torch.Tensor, cfg: TrainConfig,
                 weight_decay: float = 0.0):
        self.params = params
        self.weight_decay = weight_decay
        self.exp_avg = torch.zeros_like(params)
        self.exp_avg_sq = torch.zeros_like(params)
        self.grad = torch.zeros_like(params)  # each client's last
        self.count = torch.zeros(params.shape[0], dtype=torch.long,
                                 device=params.device)
        self.set_config(cfg)

    def set_config(self, cfg: TrainConfig) -> None:
        """Take ``cfg``'s learning rate, schedule and betas from the next
        update on; the counts stay."""
        self.cfg = cfg
        b1, b2 = cfg.beta1, cfg.beta2
        end = 1
        while (1 - b1 ** end != 1.0 or 1 - b2 ** end != 1.0) and end < 1 << 20:
            end += 1
        end = max(end, cfg.lr_decay_steps + 1)
        rows = []
        for count in range(end):
            t = count + 1
            rows.append((-self.lr(count) / (1 - b1 ** t),
                         math.sqrt(1 - b2 ** t)))
        self._table = torch.tensor(rows, dtype=torch.float32,
                                   device=self.params.device)

    def lr(self, count: int) -> float:
        """The learning rate of the update after ``count`` updates, as
        ``LambdaLR`` computes it."""
        return self.cfg.lr * lr_factor(self.cfg)(count)

    @torch.no_grad()
    def step(self, grad: torch.Tensor, active: torch.Tensor) -> None:
        """One update of the ``active`` (N,) bool clients by ``grad``."""
        cfg = self.cfg
        idx = torch.clamp(self.count, max=self._table.shape[0] - 1)
        tab = self._table[idx]
        neg_step, bc2_sqrt = tab[:, :1], tab[:, 1:]
        g = (grad.add(self.params, alpha=self.weight_decay)
             if self.weight_decay else grad)
        m = self.exp_avg.lerp(g, 1 - cfg.beta1)
        v = self.exp_avg_sq.mul(cfg.beta2).addcmul_(g, g, value=1 - cfg.beta2)
        denom = (v.sqrt() / bc2_sqrt).add_(1e-8)
        keep = active[:, None]
        self.params.add_(torch.where(keep, neg_step * m / denom, 0.0))
        torch.where(keep, m, self.exp_avg, out=self.exp_avg)
        torch.where(keep, v, self.exp_avg_sq, out=self.exp_avg_sq)
        torch.where(keep, grad, self.grad, out=self.grad)
        self.count.add_(active)

    @torch.no_grad()
    def load(self, counts, exp_avg, exp_avg_sq) -> None:
        """Every client's count (N,) and moments (N, P), arrays or
        tensors."""
        for dst, src in ((self.count, counts), (self.exp_avg, exp_avg),
                         (self.exp_avg_sq, exp_avg_sq)):
            dst.copy_(torch.as_tensor(src))


@dataclass
class StackedModels:
    """Every client's models and optimizers, stacked: what evolves during
    a federated round."""

    generator: StackedGenerator
    discriminator: StackedDiscriminator
    opt_g: StackedAdam
    opt_d: StackedAdam
    spec: SegmentSpec
    cfg: TrainConfig

    @property
    def n(self) -> int:
        return self.generator.n

    def set_config(self, cfg: TrainConfig) -> None:
        self.cfg = cfg
        self.opt_g.set_config(cfg)
        self.opt_d.set_config(cfg)

    def empty_like(self, n: int) -> "StackedModels":
        """A stack of ``n`` zeroed slots of this stack's shapes, config and
        device (a cohort's working stack, filled by :meth:`gather`)."""
        G, D = self.generator, self.discriminator
        G = StackedGenerator(n, *G.dims, device=G.device)
        D = StackedDiscriminator(n, *D.dims, device=D.device)
        cfg = self.cfg
        return StackedModels(G, D, StackedAdam(G.params, cfg, cfg.l2scale),
                             StackedAdam(D.params, cfg), self.spec, cfg)

    @torch.no_grad()
    def gather(self, full: "StackedModels", idx: torch.Tensor) -> None:
        """Slots ``idx`` (this stack's n, on the device) of ``full`` into
        this stack: weights, BatchNorm state and batch counts, Adam
        moments, counts and kept gradients."""
        G, fG = self.generator, full.generator
        G.bn_state.copy_(fG.bn_state[fG.bn_index(idx)])
        G.num_batches.copy_(fG.num_batches[idx])
        for mine, theirs in ((G, fG), (self.discriminator,
                                        full.discriminator)):
            mine.params.copy_(theirs.params.index_select(0, idx))
        for mine, theirs in ((self.opt_g, full.opt_g),
                             (self.opt_d, full.opt_d)):
            for name in ("exp_avg", "exp_avg_sq", "grad", "count"):
                getattr(mine, name).copy_(
                    getattr(theirs, name).index_select(0, idx))

    @torch.no_grad()
    def scatter(self, full: "StackedModels", idx: torch.Tensor) -> None:
        """This stack's local state back into slots ``idx`` (unique) of
        ``full`` with ``index_copy_``: Adam moments, counts, kept gradients
        and BatchNorm batch counts.  The weights and running statistics
        are not copied: the aggregate overwrites them in every slot."""
        full.generator.num_batches.index_copy_(0, idx,
                                               self.generator.num_batches)
        for mine, theirs in ((self.opt_g, full.opt_g),
                             (self.opt_d, full.opt_d)):
            for name in ("exp_avg", "exp_avg_sq", "grad", "count"):
                getattr(theirs, name).index_copy_(0, idx,
                                                  getattr(mine, name))

    def unstack(self, i: int) -> tuple:
        """Client ``i``'s ``(Generator, Discriminator)``, copies."""
        return self.generator.unstack(i), self.discriminator.unstack(i)

    def to_models(self, i: int) -> Models:
        """Client ``i`` as the per-client :class:`Models` the standalone
        step trains: copies of its modules, its torch Adam states and
        schedules at its count, and each parameter's ``.grad`` its last
        update's gradient (None before its first update)."""
        models = Models.build(*self.unstack(i), self.spec, self.cfg)
        for opt, sched, stack, module in (
                (models.opt_g, models.sched_g, self.opt_g, models.generator),
                (models.opt_d, models.sched_d, self.opt_d,
                 models.discriminator)):
            count = int(stack.count[i])
            sizes = [p.numel() for p in module.parameters()]
            parts = [t[i].split(sizes)
                     for t in (stack.exp_avg, stack.exp_avg_sq, stack.grad)]
            state = {}
            for k, (p, m, v, g) in enumerate(zip(module.parameters(),
                                                 *parts)):
                if count:  # no gradient, no state before the first update
                    p.grad = g.view_as(p).clone()
                    state[k] = {"step": torch.tensor(float(count)),
                                "exp_avg": m.view_as(p).clone(),
                                "exp_avg_sq": v.view_as(p).clone()}
            restore_optimizer(opt, sched, state, stack.lr(count), count)
        return models


def stack_models(models: list) -> StackedModels:
    """N clients' :class:`Models` stacked (copies): weights, BatchNorm
    state, and the torch Adam states (count, moments) and last gradients
    where they have them (zeros where not)."""
    first = models[0]
    G = StackedGenerator.from_modules([m.generator for m in models])
    D = StackedDiscriminator.from_modules([m.discriminator for m in models])
    cfg = first.cfg
    out = StackedModels(G, D, StackedAdam(G.params, cfg, cfg.l2scale),
                        StackedAdam(D.params, cfg), first.spec, cfg)
    for stack, part, opt in ((out.opt_g, "generator", "opt_g"),
                             (out.opt_d, "discriminator", "opt_d")):
        counts, per_client = [], []
        for m in models:
            params = list(getattr(m, part).parameters())
            state = getattr(m, opt).state
            counts.append(int(state[params[0]]["step"]) if state else 0)
            per_client.append([torch.cat([
                (t if t is not None else torch.zeros_like(p)).reshape(-1)
                for p, t in zip(params, tensors)]) for tensors in (
                    [state.get(p, {}).get("exp_avg") for p in params],
                    [state.get(p, {}).get("exp_avg_sq") for p in params],
                    [p.grad for p in params])])
        mom, sq, grads = (torch.stack(t).detach() for t in zip(*per_client))
        stack.load(counts, mom, sq)
        with torch.no_grad():
            stack.grad.copy_(grads)
    return out


def stacked_train_step(stack: StackedModels, data: torch.Tensor,
                       cond: StackedCondSampler, rows: StackedRowSampler,
                       draws: StepDraws, active: torch.Tensor,
                       last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One D+G update pair for every client at once, in place on
    ``stack``: :func:`train_step` on each client's slice, the clients'
    rows stacked (K1 over N * batch rows, K2 in its backward).  ``data``
    (N * stride, dim) is the stacked encoded data; ``draws`` hold every
    client's draws (N leading).  Each client's losses are its own means;
    the loss each backward pass takes is their sum over clients, so a
    client's gradient is the one it would get alone.

    Clients outside ``active`` (N,) bool are computed but change nothing:
    their parameters, moments, counts, BatchNorm state and metrics keep
    their values (the JAX program's masked scan steps,
    ``fed_tgan_tpu/train/federated.py:254-266``).  Returns the (N, 3)
    metrics ``loss_d``, ``pen``, ``loss_g``: this step's for the active
    clients, ``last`` (default zeros) for the others."""
    cfg = stack.cfg
    if len(draws.d) != cfg.d_steps:
        raise ValueError(f"{len(draws.d)} critic draw blocks for d_steps="
                         f"{cfg.d_steps}")
    G = stack.generator
    bn_before = G.bn_state.clone()
    for d in draws.d:
        loss_d, pen = _stacked_d_update(stack, data, cond, rows, d, active)
    loss_g = _stacked_g_update(stack, cond, draws.g, active)
    with torch.no_grad():
        torch.where(active[G.bn_client], G.bn_state, bn_before,
                    out=G.bn_state)
        G.num_batches.add_(active, alpha=cfg.d_steps + 1)
        met = torch.stack([loss_d, pen, loss_g], dim=1)
        if last is None:
            last = torch.zeros_like(met)
        return torch.where(active[:, None], met, last)


def _stacked_d_update(stack: StackedModels, data: torch.Tensor,
                      cond: StackedCondSampler, rows: StackedRowSampler,
                      d: DDraws, active: torch.Tensor):
    """Every client's critic update (:func:`d_update`); returns its
    ``(loss_d, pen)`` (N,) each."""
    spec, cfg, n = stack.spec, stack.cfg, stack.n
    pol = resolve_precision(cfg.precision)
    G, D = stack.generator, stack.discriminator
    B = cfg.batch_size
    z = d.z.reshape(n * B, -1)
    if spec.n_discrete:
        c1, _, col, opt = cond.train_from_draws(d.col, d.r)
        row_idx = rows.sample_rows(col.gather(1, d.perm),
                                   opt.gather(1, d.perm), d.row_u)
        gen_in = torch.cat([z, c1], dim=1)
    else:
        row_idx = rows.sample_uniform(d.row_u)
        gen_in = z
    real = data[row_idx]
    with torch.no_grad():  # train-mode BN: the running statistics move
        raw = G(pol.cast(gen_in).view(n, B, -1)).reshape(n * B, -1)
        fake = fused_apply_activate(raw, spec, d.u.reshape(n * B, -1))
    if spec.n_discrete:
        c1_perm = c1.view(n, B, -1).gather(
            1, d.perm[:, :, None].expand(-1, -1, c1.shape[1]))
        fake_cat = torch.cat([fake, pol.cast(c1)], dim=1)
        real_cat = pol.cast(torch.cat([real, c1_perm.reshape(n * B, -1)],
                                      dim=1))
    else:
        fake_cat, real_cat = fake, pol.cast(real)
    y_fake = D(fake_cat, keep=d.keep_fake)
    y_real = D(real_cat, keep=d.keep_real)
    loss_d = (f32_island(y_fake).mean(dim=(1, 2))
              - f32_island(y_real).mean(dim=(1, 2)))
    pen = gradient_penalty(lambda x: D(x, keep=d.keep_gp), real_cat,
                           fake_cat, d.alpha.reshape(n * B, 1), pac=cfg.pac,
                           clients=n)
    (grad,) = _grads([D.params], loss_d.sum(), pen.sum())
    stack.opt_d.step(grad, active)
    return loss_d.detach(), pen.detach()


def _stacked_g_update(stack: StackedModels, cond: StackedCondSampler,
                      g: GDraws, active: torch.Tensor) -> torch.Tensor:
    """Every client's generator update (:func:`g_update`); returns its
    ``loss_g`` (N,)."""
    loss_g = stacked_g_loss(stack, cond, g)
    (grad,) = _grads([stack.generator.params], loss_g.sum())
    stack.opt_g.step(grad, active)
    return loss_g.detach()


def stacked_g_loss(stack: StackedModels, cond: StackedCondSampler,
                   g: GDraws) -> torch.Tensor:
    """Every client's generator loss (:func:`g_loss`), (N,) with its
    graph: the stacked generator in train mode from its BatchNorm state,
    K1 forward (K2 in the backward), each client's discriminator."""
    spec, cfg, n = stack.spec, stack.cfg, stack.n
    pol = resolve_precision(cfg.precision)
    G, D = stack.generator, stack.discriminator
    B = cfg.batch_size
    z = g.z.reshape(n * B, -1)
    if spec.n_discrete:
        c1, m1, _, _ = cond.train_from_draws(g.col, g.r)
        gen_in = torch.cat([z, c1], dim=1)
    else:
        gen_in = z
    raw = G(pol.cast(gen_in).view(n, B, -1)).reshape(n * B, -1)
    act = fused_apply_activate(raw, spec, g.u.reshape(n * B, -1))
    d_in = torch.cat([act, pol.cast(c1)], dim=1) if spec.n_discrete else act
    loss_g = -f32_island(D(d_in, keep=g.keep)).mean(dim=(1, 2))
    if spec.n_discrete:
        loss_g = loss_g + cond_loss(raw, spec, c1, m1, clients=n)
    return loss_g


# --------------------------------------------------------------- sampling


def sample_step(generator: Generator, spec: SegmentSpec, z: torch.Tensor,
                cond_vec: Optional[torch.Tensor], u: torch.Tensor,
                block_rows: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Activated generator output for explicit draws: noise ``z``
    (rows, embedding_dim), conditional vectors ``cond_vec`` (rows, n_opt;
    None when the table has no softmax segment) and Gumbel uniforms ``u``
    (rows, spec.dim).  ``generator`` must be in eval mode.

    The generator runs over fixed blocks of ``block_rows`` rows (``rows``
    must be a multiple): every block is then the same matrix-product shape
    whatever ``rows`` is, so a row's value never depends on how many rows
    were computed beside it.  The activation is row-wise and runs once
    over all rows.

    The generator and K1 compute in ``dtype`` (the model's compute dtype);
    the rows come back float32 (``make_sample_step``, ``steps.py:
    406-426``): decode is a float32 island, and a bf16 row cast to float32
    keeps its rounded values, ties included."""
    x = z if cond_vec is None else torch.cat([z, cond_vec], dim=1)
    x = as_dtype(x, dtype)
    with torch.no_grad():
        raw = torch.cat([generator(b) for b in x.split(block_rows)])
        return f32_island(fused_apply_activate(raw, spec, u.contiguous()))
