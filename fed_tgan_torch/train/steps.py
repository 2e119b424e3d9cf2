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
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.models.ctgan import Discriminator, Generator
from fed_tgan_torch.models.losses import gradient_penalty
from fed_tgan_torch.ops.activate_cuda import fused_apply_activate
from fed_tgan_torch.ops.segments import SegmentSpec, cond_loss
from fed_tgan_torch.train.sampler import CondSampler, RowSampler


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


def require_f32(cfg: TrainConfig) -> None:
    """The port runs in float32 only; bf16 is not ported yet."""
    if cfg.precision != "f32":
        raise NotImplementedError(
            f"precision={cfg.precision!r}: only f32 is ported")


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
    """The training options this port runs: float32, no EMA, at least one
    critic update per generator step."""
    require_f32(cfg)
    if cfg.ema_decay:
        raise NotImplementedError("ema_decay: EMA is not ported yet")
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

    def to(self, device) -> "StepDraws":
        """A copy with every tensor on ``device``."""
        def move(v):
            if isinstance(v, list):
                return [move(x) for x in v]
            return None if v is None else v.to(device)

        def block(b):
            return type(b)(**{f.name: move(getattr(b, f.name))
                              for f in dataclasses.fields(b)})

        return StepDraws(d=[block(b) for b in self.d], g=block(self.g))


def draw_step(gen: torch.Generator, models: Models) -> StepDraws:
    """One step's draws from ``gen`` (on the models' device).  Columns
    are uniform over the conditional columns; dropout keeps with
    probability 0.5."""
    spec, cfg, D = models.spec, models.cfg, models.discriminator
    B, device = cfg.batch_size, D.out.weight.device
    has_cond = spec.n_discrete > 0

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def cond():
        if not has_cond:
            return None, None
        col = torch.randint(0, spec.n_discrete, (B,), generator=gen,
                            device=device)
        return col, uniform(B, 1)

    def normal():
        return torch.randn((B, cfg.embedding_dim), generator=gen,
                           device=device)

    blocks = []
    for _ in range(cfg.d_steps):
        z = normal()
        col, r = cond()
        perm = (torch.randperm(B, generator=gen, device=device)
                if has_cond else None)
        blocks.append(DDraws(
            z=z, col=col, r=r, perm=perm, row_u=uniform(B),
            u=uniform(B, spec.dim), keep_fake=D.draw_keep(B, gen),
            keep_real=D.draw_keep(B, gen), keep_gp=D.draw_keep(B, gen),
            alpha=uniform(B, 1)))
    z = normal()
    col, r = cond()
    return StepDraws(d=blocks, g=GDraws(z=z, col=col, r=r,
                                        u=uniform(B, spec.dim),
                                        keep=D.draw_keep(B, gen)))


# ------------------------------------------------------------- train step


def _set_grads(params: list, *losses: torch.Tensor) -> None:
    """``p.grad`` = the gradient of the sum of ``losses``, each loss's
    gradient from its own backward pass, summed in argument order.

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
    for p, g in zip(params, total):
        p.grad = torch.zeros_like(p) if g is None else g


def d_update(models: Models, data: torch.Tensor, cond: CondSampler,
             rows: RowSampler, d: DDraws):
    """One critic update; returns ``(loss_d, pen)``."""
    spec, pac = models.spec, models.cfg.pac
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
        fake = fused_apply_activate(G(gen_in), spec, d.u)
    if spec.n_discrete:
        fake_cat = torch.cat([fake, c1], dim=1)
        real_cat = torch.cat([real, c1[d.perm]], dim=1)
    else:
        fake_cat, real_cat = fake, real
    y_fake = D(fake_cat, keep=d.keep_fake)
    y_real = D(real_cat, keep=d.keep_real)
    loss_d = y_fake.mean() - y_real.mean()
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
    G, D = models.generator, models.discriminator
    if spec.n_discrete:
        c1, m1, _, _ = cond.train_from_draws(g.col, g.r)
        gen_in = torch.cat([g.z, c1], dim=1)
    else:
        gen_in = g.z
    raw = G(gen_in)
    act = fused_apply_activate(raw, spec, g.u)  # K1 forward, K2 backward
    d_in = torch.cat([act, c1], dim=1) if spec.n_discrete else act
    loss_g = -D(d_in, keep=g.keep).mean()
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


# --------------------------------------------------------------- sampling


def sample_step(generator: Generator, spec: SegmentSpec, z: torch.Tensor,
                cond_vec: Optional[torch.Tensor], u: torch.Tensor,
                block_rows: int) -> torch.Tensor:
    """Activated generator output for explicit draws: noise ``z``
    (rows, embedding_dim), conditional vectors ``cond_vec`` (rows, n_opt;
    None when the table has no softmax segment) and Gumbel uniforms ``u``
    (rows, spec.dim).  ``generator`` must be in eval mode.

    The generator runs over fixed blocks of ``block_rows`` rows (``rows``
    must be a multiple): every block is then the same matrix-product shape
    whatever ``rows`` is, so a row's value never depends on how many rows
    were computed beside it.  The activation is row-wise and runs once
    over all rows."""
    x = z if cond_vec is None else torch.cat([z, cond_vec], dim=1)
    with torch.no_grad():
        raw = torch.cat([generator(b) for b in x.split(block_rows)])
        return fused_apply_activate(raw, spec, u.contiguous())
