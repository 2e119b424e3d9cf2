"""The CTGAN generator and discriminator
(counterpart of ``fed_tgan_tpu/models/ctgan.py:51-153``).

- Generator: a residual MLP.  Each block is Linear -> BatchNorm1d -> ReLU
  with the block input concatenated back on after the activation (so
  widths grow), then an output Linear to the encoded width.  Training runs
  it in train mode: ``nn.BatchNorm1d`` normalises with the biased batch
  variance and moves its running statistics (unbiased variance, momentum
  0.1), as ``generator_apply(train=True)`` does.  Sampling runs it in eval
  mode, on the running statistics (the reference samples under
  ``generator.eval()``).
- Discriminator: the "pac" trick (``pac`` rows concatenated into one
  sample), then Linear -> LeakyReLU(0.2) -> dropout 0.5 per hidden layer
  and a final Linear to one score.  Dropout takes explicit keep masks
  (``draw_keep`` draws them from a passed ``torch.Generator``), so a test
  can inject the JAX package's masks.

The matrix products are plain ``F.linear``: the JAX package leaves them
to XLA too, outside any hand-written kernel.  Every layer initialises as
torch's default, U(+-1/sqrt(fan_in)) for weights and biases, which is the
JAX package's ``_linear_init``.

Mixed precision (:mod:`fed_tgan_torch.runtime.precision`): every model
computes in the dtype of its input.  Given bf16 rows it runs its linear
layers on its float32 parameters cast to bf16 (autograd returns float32
gradients through the cast), and BatchNorm is a float32 island: its input
is cast to float32, normalised by the same float32 ``batch_norm`` the f32
path runs (running statistics float32; weight and bias the bf16-rounded
parameters, as JAX casts every parameter), the ReLU taken, and the result
cast back.  The stacked models cast their flat ``(N, P)`` parameters once
per forward and take views of the cast.  Given float32 rows every cast is
the tensor itself: the f32 path runs what it ran before.

The federated round trains every client at once, as the JAX program's
``vmap`` over clients does (``fed_tgan_tpu/train/federated.py:237-270``):
:class:`StackedGenerator` and :class:`StackedDiscriminator` hold N
clients' weights in one flat ``(N, P)`` tensor, each weight a view
``(N, *shape)`` of it in the modules' parameter order.  Linear layers are
``baddbmm`` over ``(N, rows, in)``; BatchNorm takes each client's batch
statistics and moves each client's running statistics
(:func:`stacked_batch_norm`); the pac discriminator packs each client's
rows on its own.  ``from_modules`` / ``unstack`` convert to and from the
per-client modules.

The serving fleet samples several models at once:
:class:`StackedEvalGenerator` runs L eval-mode generators over their
lanes' rows with one BatchNorm over (lane, feature) channels.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.runtime.precision import as_dtype, f32_island

BN_EPS = 1e-5  # torch BatchNorm1d defaults, as in the reference
BN_MOMENTUM = 0.1
LEAKY_SLOPE = 0.2
DROPOUT_RATE = 0.5


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in ``x``'s dtype: its parameters cast to it (the
    parameters themselves when the dtypes agree)."""
    return F.linear(x, as_dtype(layer.weight, x.dtype),
                    as_dtype(layer.bias, x.dtype))


def batch_norm_island(bn: nn.BatchNorm1d, h: torch.Tensor) -> torch.Tensor:
    """``bn`` on ``h`` in the parameters' dtype (``bn(h)`` itself when
    ``h`` has it); for a lower-precision ``h`` the affine weight and bias
    are first rounded to ``h``'s dtype, as JAX casts every parameter, and
    the module's running statistics and batch count move as ``bn(h)``
    moves them."""
    if h.dtype == bn.weight.dtype:
        return bn(h)
    if bn.training:
        bn.num_batches_tracked.add_(1)
    dt = bn.weight.dtype
    return F.batch_norm(h.to(dt), bn.running_mean, bn.running_var,
                        bn.weight.to(h.dtype).to(dt),
                        bn.bias.to(h.dtype).to(dt), bn.training,
                        bn.momentum, bn.eps)


class Residual(nn.Module):
    """Linear(in->out) + BatchNorm + ReLU, input concatenated after it."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, out_dim)
        self.bn = nn.BatchNorm1d(out_dim, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = batch_norm_island(self.bn, linear(self.fc, x))
        return torch.cat([as_dtype(torch.relu(h), x.dtype), x], dim=1)


class Generator(nn.Module):
    """Residual-MLP generator: (rows, input_dim) -> (rows, data_dim) raw
    output, before the activation."""

    def __init__(self, input_dim: int, gen_dims: Sequence[int], data_dim: int):
        super().__init__()
        blocks, dim = [], input_dim
        for h in gen_dims:
            blocks.append(Residual(dim, h))
            dim += h
        self.blocks = nn.ModuleList(blocks)
        self.out = nn.Linear(dim, data_dim)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            z = block(z)
        return linear(self.out, z)


class Discriminator(nn.Module):
    """Pac discriminator: (batch, input_dim) -> (batch / pac, 1) scores."""

    def __init__(self, input_dim: int, dis_dims: Sequence[int], pac: int):
        super().__init__()
        self.pac = pac
        layers, dim = [], input_dim * pac
        for h in dis_dims:
            layers.append(nn.Linear(dim, h))
            dim = h
        self.layers = nn.ModuleList(layers)
        self.out = nn.Linear(dim, 1)

    def keep_shapes(self, batch: int) -> list[tuple[int, int]]:
        """The shape of each hidden layer's dropout keep mask."""
        return [(batch // self.pac, layer.out_features)
                for layer in self.layers]

    def draw_keep(self, batch: int, generator: torch.Generator) -> list:
        """Bernoulli(1 - DROPOUT_RATE) keep masks, one per hidden layer."""
        device = self.out.weight.device
        return [torch.rand(shape, generator=generator, device=device)
                < 1.0 - DROPOUT_RATE for shape in self.keep_shapes(batch)]

    def forward(self, x: torch.Tensor,
                keep: Optional[Sequence] = None) -> torch.Tensor:
        """Scores of ``x`` (batch divisible by pac).  Dropout uses the keep
        masks ``keep`` (one bool tensor per hidden layer, from
        :meth:`draw_keep` or injected); without them it is off.  Built from
        differentiable ops only (``where`` on the masks), so the gradient
        penalty can differentiate it twice."""
        if x.shape[0] % self.pac:
            raise ValueError(f"batch {x.shape[0]} not divisible by pac "
                             f"{self.pac}")
        h = x.reshape(x.shape[0] // self.pac, -1)
        for i, layer in enumerate(self.layers):
            h = F.leaky_relu(linear(layer, h), LEAKY_SLOPE)
            if keep is not None:
                h = torch.where(keep[i], h / (1.0 - DROPOUT_RATE), 0.0)
        return linear(self.out, h)


# ------------------------------------------------------------ stacked clients


def stacked_linear(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight[i].T + bias[i]`` for every client ``i``: ``x`` (N, rows,
    in), ``weight`` (N, out, in), ``bias`` (N, out)."""
    return torch.baddbmm(bias.unsqueeze(1), x, weight.transpose(1, 2))


def stacked_batch_norm(h: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, running_mean: torch.Tensor,
                       running_var: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm of N clients at once: ``h`` (N, rows, F) is
    normalised with each client's own batch mean and biased variance, and
    each client's running statistics (``running_*`` (N * F,), contiguous,
    updated in place) move with the unbiased variance and momentum 0.1, as
    ``nn.BatchNorm1d`` moves them.  Every (client, feature) pair is one
    channel of one ``batch_norm`` over the rows."""
    n, rows, feat = h.shape
    y = F.batch_norm(h.transpose(0, 1).reshape(rows, n * feat), running_mean,
                     running_var, weight.reshape(n * feat),
                     bias.reshape(n * feat), training=True,
                     momentum=BN_MOMENTUM, eps=BN_EPS)
    return y.view(rows, n, feat).transpose(0, 1)


class _Stacked:
    """N clients' parameters in one flat (N, P) leaf tensor, laid out in
    the per-client module's ``parameters()`` order (``shapes``)."""

    def _init_params(self, n: int, shapes: list, device) -> None:
        device = resolve_device(device)
        self.n = n
        self.shapes = shapes
        self.sizes = [math.prod(shape) for _, shape in shapes]
        self.params = torch.zeros((n, sum(self.sizes)), device=device,
                                  requires_grad=True)

    @property
    def device(self) -> torch.device:
        return self.params.device

    def leaves(self, dtype: torch.dtype = torch.float32) -> dict:
        """``{name: (N, *shape) view of params}`` (one split, so the
        gradient of ``params`` is one concatenation); for another
        ``dtype``, views of one cast of ``params``."""
        parts = as_dtype(self.params, dtype).split(self.sizes, dim=1)
        return {name: p.view(self.n, *shape)
                for (name, shape), p in zip(self.shapes, parts)}

    def client_state(self, i: int) -> dict:
        """Client ``i``'s ``state_dict`` as views into the stack."""
        return {name: v[i] for name, v in self.leaves().items()}

    @torch.no_grad()
    def load_state_dicts(self, states: list) -> None:
        """Every client's weights from one ``state_dict`` (tensors on any
        device, or arrays; the per-client module's keys) per client."""
        self.params.copy_(torch.stack([
            _joined([sd[name] for name, _ in self.shapes], self.device)
            for sd in states]))

    def state_dicts(self) -> list:
        """One ``state_dict`` of numpy copies per client (one copy of the
        stack to the host)."""
        host = self.params.detach().cpu().numpy()
        out = []
        for i in range(self.n):
            parts = np.split(host[i], np.cumsum(self.sizes)[:-1])
            out.append({name: p.reshape(shape).copy()
                        for (name, shape), p in zip(self.shapes, parts)})
        return out


class StackedGenerator(_Stacked):
    """N residual-MLP generators in train mode: (N, rows, input_dim) ->
    (N, rows, data_dim).  ``bn_state`` holds each block's running mean
    then running variance, each (N * width,) contiguous; ``num_batches``
    (N,) counts each client's train-mode forwards (the caller advances
    it, so a masked step can leave it)."""

    def __init__(self, n: int, input_dim: int, gen_dims: Sequence[int],
                 data_dim: int, device="cuda"):
        shapes, dim = [], input_dim
        for j, h in enumerate(gen_dims):
            shapes += [(f"blocks.{j}.fc.weight", (h, dim)),
                       (f"blocks.{j}.fc.bias", (h,)),
                       (f"blocks.{j}.bn.weight", (h,)),
                       (f"blocks.{j}.bn.bias", (h,))]
            dim += h
        shapes += [("out.weight", (data_dim, dim)), ("out.bias", (data_dim,))]
        self._init_params(n, shapes, device)
        device = self.device
        self.dims = (input_dim, tuple(gen_dims), data_dim)
        self.widths = list(gen_dims)
        self.bn_state = torch.zeros(2 * n * sum(gen_dims), device=device)
        self.num_batches = torch.zeros(n, dtype=torch.long, device=device)
        # the client each entry of bn_state belongs to
        self.bn_client = torch.cat([
            torch.arange(n, device=device).repeat_interleave(h).repeat(2)
            for h in gen_dims])

    def running(self, j: int, bn_state: Optional[torch.Tensor] = None):
        """Block ``j``'s (running mean, running var), each (N * width,),
        views into ``bn_state`` (default: this stack's)."""
        bn = self.bn_state if bn_state is None else bn_state
        start = 2 * self.n * sum(self.widths[:j])
        size = self.n * self.widths[j]
        return bn[start:start + size], bn[start + size:start + 2 * size]

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        lv = self.leaves(z.dtype)
        for j in range(len(self.widths)):
            pre = f"blocks.{j}"
            h = stacked_linear(z, lv[f"{pre}.fc.weight"], lv[f"{pre}.fc.bias"])
            # a float32 island (each cast the tensor itself in f32)
            h = stacked_batch_norm(f32_island(h),
                                   f32_island(lv[f"{pre}.bn.weight"]),
                                   f32_island(lv[f"{pre}.bn.bias"]),
                                   *self.running(j))
            z = torch.cat([as_dtype(torch.relu(h), z.dtype), z], dim=2)
        return stacked_linear(z, lv["out.weight"], lv["out.bias"])

    def _buffers(self, i: int, bn_state: torch.Tensor,
                 num_batches: torch.Tensor) -> dict:
        out = {}
        for j, h in enumerate(self.widths):
            mean, var = self.running(j, bn_state)
            out[f"blocks.{j}.bn.running_mean"] = mean.view(self.n, h)[i]
            out[f"blocks.{j}.bn.running_var"] = var.view(self.n, h)[i]
            out[f"blocks.{j}.bn.num_batches_tracked"] = num_batches[i]
        return out

    def client_state(self, i: int) -> dict:
        """Client ``i``'s ``Generator.state_dict()`` as views into the
        stack."""
        return {**super().client_state(i),
                **self._buffers(i, self.bn_state, self.num_batches)}

    def unstack(self, i: int) -> Generator:
        """Client ``i``'s generator as a module of its own (a copy), in
        train mode."""
        return self.module(self.client_state(i))

    def flat_state(self, params: torch.Tensor, bn: torch.Tensor,
                   num_batches: torch.Tensor) -> dict:
        """A ``Generator.state_dict()`` from one client's flat weights
        ``params`` (P,), running statistics ``bn`` (2 * sum(widths),
        block by block: mean, then variance) and batch count (views)."""
        state = {name: p.view(shape) for (name, shape), p in
                 zip(self.shapes, params.split(self.sizes))}
        start = 0
        for j, h in enumerate(self.widths):
            for key in ("running_mean", "running_var"):
                state[f"blocks.{j}.bn.{key}"] = bn[start:start + h]
                start += h
            state[f"blocks.{j}.bn.num_batches_tracked"] = num_batches
        return state

    def module(self, state: dict) -> Generator:
        """A train-mode generator of this stack's shape holding ``state``
        (a ``Generator.state_dict()``), a copy."""
        return _module(Generator, self.dims, self.device, state)

    def bn_index(self, idx: torch.Tensor) -> torch.Tensor:
        """Where clients ``idx`` (C,) sit in :attr:`bn_state`: the (2 * C *
        sum(widths),) positions of their running statistics, in the layout
        of a stack of those C clients (``bn_state[bn_index(idx)]`` is that
        stack's ``bn_state``)."""
        parts, start = [], 0
        for h in self.widths:
            cols = (idx[:, None] * h + torch.arange(h, device=idx.device)
                    ).reshape(-1)
            parts += [start + cols, start + self.n * h + cols]
            start += 2 * self.n * h
        return torch.cat(parts)

    @torch.no_grad()
    def load_state_dicts(self, states: list) -> None:
        super().load_state_dicts(states)
        self.bn_state.copy_(_joined(
            [sd[f"blocks.{j}.bn.{key}"] for j in range(len(self.widths))
             for key in ("running_mean", "running_var") for sd in states],
            self.device))
        self.num_batches.copy_(torch.as_tensor(
            [int(sd["blocks.0.bn.num_batches_tracked"]) for sd in states]))

    def state_dicts(self) -> list:
        bn, nb = self.bn_state.cpu(), self.num_batches.cpu()
        return [{**sd, **{k: v.numpy().copy() for k, v in
                          self._buffers(i, bn, nb).items()}}
                for i, sd in enumerate(super().state_dicts())]

    @classmethod
    def from_modules(cls, gens: Sequence[Generator]) -> "StackedGenerator":
        g = gens[0]
        stack = cls(len(gens), g.blocks[0].fc.in_features,
                    [b.fc.out_features for b in g.blocks], g.out.out_features,
                    g.out.weight.device)
        stack.load_state_dicts([m.state_dict() for m in gens])
        return stack


class StackedDiscriminator(_Stacked):
    """N pac discriminators: (N * batch, input_dim), client-major rows ->
    (N, batch / pac, 1) scores; each client packs its own rows."""

    def __init__(self, n: int, input_dim: int, dis_dims: Sequence[int],
                 pac: int, device="cuda"):
        shapes, dim = [], input_dim * pac
        for j, h in enumerate(dis_dims):
            shapes += [(f"layers.{j}.weight", (h, dim)),
                       (f"layers.{j}.bias", (h,))]
            dim = h
        shapes += [("out.weight", (1, dim)), ("out.bias", (1,))]
        self._init_params(n, shapes, device)
        self.dims = (input_dim, tuple(dis_dims), pac)
        self.pac = pac
        self.widths = list(dis_dims)

    def keep_shapes(self, batch: int) -> list[tuple[int, int, int]]:
        """The shape of each hidden layer's stacked dropout keep mask."""
        return [(self.n, batch // self.pac, h) for h in self.widths]

    def __call__(self, x: torch.Tensor,
                 keep: Optional[Sequence] = None) -> torch.Tensor:
        """Scores of ``x``; ``keep`` as :meth:`Discriminator.forward`'s,
        each mask stacked (N, batch / pac, width)."""
        if x.shape[0] % (self.n * self.pac):
            raise ValueError(f"{x.shape[0]} rows are not {self.n} clients' "
                             f"batches divisible by pac {self.pac}")
        h = x.reshape(self.n, x.shape[0] // (self.n * self.pac), -1)
        lv = self.leaves(x.dtype)
        for j in range(len(self.widths)):
            h = F.leaky_relu(stacked_linear(h, lv[f"layers.{j}.weight"],
                                            lv[f"layers.{j}.bias"]),
                             LEAKY_SLOPE)
            if keep is not None:
                h = torch.where(keep[j], h / (1.0 - DROPOUT_RATE), 0.0)
        return stacked_linear(h, lv["out.weight"], lv["out.bias"])

    def unstack(self, i: int) -> Discriminator:
        """Client ``i``'s discriminator as a module of its own (a copy),
        in train mode."""
        return _module(Discriminator, self.dims, self.device,
                       self.client_state(i))

    @classmethod
    def from_modules(cls, diss: Sequence[Discriminator]
                     ) -> "StackedDiscriminator":
        d = diss[0]
        stack = cls(len(diss), d.layers[0].in_features // d.pac,
                    [l.out_features for l in d.layers], d.pac,
                    d.out.weight.device)
        stack.load_state_dicts([m.state_dict() for m in diss])
        return stack


class StackedEvalGenerator:
    """L eval-mode generators side by side (the serving fleet's lanes):
    (L, rows, input_dim) -> (L, rows, data_dim), bit for bit what each
    lane's :class:`Generator` gives its own rows through ``sample_step``.

    The rows run in blocks of ``block_rows``, as the single-model path
    runs them, and each lane's linear layers are that path's own ``addmm``
    at that path's shape, so the card picks the same GEMM and every row
    keeps its bits.  (One ``baddbmm`` over the lanes is faster, but cuBLAS
    may pick it another kernel with another accumulation order: on the
    H100 it kept the bits at the Intrusion layout's shapes for 2 to 8
    lanes, not for one lane and not at the Adult layout's.)  BatchNorm
    normalises with each lane's running statistics through one
    ``batch_norm(training=False)`` over (lane, feature) channels, and the
    ReLU and the residual concatenation run once for every lane.

    ``dtype`` is the lanes' compute dtype: the linear layers' weights are
    cast to it once, here, and BatchNorm is the float32 island of
    :class:`Generator` (weight and bias rounded to ``dtype``)."""

    def __init__(self, gens: Sequence[Generator],
                 dtype: torch.dtype = torch.float32):
        def stack(get, dt=dtype):
            return as_dtype(torch.stack([get(g).detach() for g in gens]), dt)

        self.n = len(gens)
        self.dtype = dtype
        self.fc = [(stack(lambda g: g.blocks[j].fc.weight),
                    stack(lambda g: g.blocks[j].fc.bias))
                   for j in range(len(gens[0].blocks))]
        # (L * width,) per block: one channel per (lane, feature)
        self.bn = [tuple(f32_island(stack(lambda g: getattr(g.blocks[j].bn,
                                                            k))).reshape(-1)
                         for k in ("weight", "bias"))
                   + tuple(stack(lambda g: getattr(g.blocks[j].bn, k),
                                 torch.float32).reshape(-1)
                           for k in ("running_mean", "running_var"))
                   for j in range(len(gens[0].blocks))]
        self.out = (stack(lambda g: g.out.weight), stack(lambda g: g.out.bias))

    def _linear(self, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        return torch.stack([F.linear(x[i], weight[i], bias[i])
                            for i in range(self.n)])

    def _block(self, z: torch.Tensor) -> torch.Tensor:
        for (w, b), (bn_w, bn_b, mean, var) in zip(self.fc, self.bn):
            h = f32_island(self._linear(z, w, b))
            lanes, rows, feat = h.shape
            y = F.batch_norm(h.transpose(0, 1).reshape(rows, lanes * feat),
                             mean, var, bn_w, bn_b, training=False,
                             momentum=BN_MOMENTUM, eps=BN_EPS)
            h = y.view(rows, lanes, feat).transpose(0, 1)
            z = torch.cat([as_dtype(torch.relu(h), z.dtype), z], dim=2)
        return self._linear(z, *self.out)

    def __call__(self, x: torch.Tensor, block_rows: int) -> torch.Tensor:
        """Raw outputs in the compute dtype of the lanes' ``(L, rows,
        input_dim)`` inputs ``x`` (cast to it here)."""
        x = as_dtype(x, self.dtype)
        with torch.no_grad():
            return torch.cat([self._block(b)
                              for b in x.split(block_rows, dim=1)], dim=1)


def _joined(values: list, device) -> torch.Tensor:
    """``values`` (tensors on any device, or arrays) flattened and joined
    into one float32 tensor on ``device``."""
    if all(isinstance(v, torch.Tensor) for v in values):
        return torch.cat([v.detach().reshape(-1).to(device, torch.float32)
                          for v in values])
    return torch.as_tensor(np.concatenate(
        [np.asarray(v, dtype=np.float32).reshape(-1) for v in values]),
        device=device)


def _module(cls, dims: tuple, device, state: dict) -> nn.Module:
    """A train-mode ``cls(*dims)`` on ``device`` holding ``state``; built
    on the meta device first, so no initialisation draws from torch's
    global generator."""
    with torch.device("meta"):
        module = cls(*dims)
    module = module.to_empty(device=device)
    module.load_state_dict(state)
    return module.train()
