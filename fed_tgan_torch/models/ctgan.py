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

The matrix products are plain ``nn.Linear``: the JAX package leaves them
to XLA too, outside any hand-written kernel.  Every layer initialises as
torch's default, U(+-1/sqrt(fan_in)) for weights and biases, which is the
JAX package's ``_linear_init``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # torch BatchNorm1d defaults, as in the reference
BN_MOMENTUM = 0.1
LEAKY_SLOPE = 0.2
DROPOUT_RATE = 0.5


class Residual(nn.Module):
    """Linear(in->out) + BatchNorm + ReLU, input concatenated after it."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, out_dim)
        self.bn = nn.BatchNorm1d(out_dim, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.relu(self.bn(self.fc(x))), x], dim=1)


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
        return self.out(z)


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
            h = F.leaky_relu(layer(h), LEAKY_SLOPE)
            if keep is not None:
                h = torch.where(keep[i], h / (1.0 - DROPOUT_RATE), 0.0)
        return self.out(h)
