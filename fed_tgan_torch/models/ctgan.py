"""The CTGAN generator (counterpart of ``fed_tgan_tpu/models/ctgan.py:51-115``).

A residual MLP: each block is Linear -> BatchNorm1d -> ReLU with the block
input concatenated back on after the activation (so widths grow), then an
output Linear to the encoded width.  Sampling runs the module in eval mode,
where BatchNorm uses its running statistics (the reference samples under
``generator.eval()``).  The matrix products are plain ``nn.Linear``: the
JAX package leaves them to XLA too, outside any hand-written kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BN_EPS = 1e-5  # torch BatchNorm1d defaults, as in the reference
BN_MOMENTUM = 0.1


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
