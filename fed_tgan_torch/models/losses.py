"""WGAN-GP losses with the reference's slerp interpolation
(counterpart of ``fed_tgan_tpu/models/losses.py:22-66``).

The gradient penalty interpolates real/fake pairs *spherically*, not
linearly (reference Server/dtds/synthesizers/ctgan.py:231-258).  Its
second-order gradient is ``torch.autograd.grad(..., create_graph=True)``
through a discriminator made of differentiable ops only.
"""

from __future__ import annotations

from typing import Callable

import torch

GP_LAMBDA = 10.0


def slerp(val: torch.Tensor, low: torch.Tensor,
          high: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between rows of ``low`` and ``high``;
    ``val`` is (batch, 1).  Where the rows are parallel (``|sin omega| <
    1e-7``) it falls back to linear interpolation."""
    low_norm = low / torch.linalg.vector_norm(low, dim=1, keepdim=True)
    high_norm = high / torch.linalg.vector_norm(high, dim=1, keepdim=True)
    cos = (low_norm * high_norm).sum(dim=1, keepdim=True)
    omega = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    so = torch.sin(omega)
    parallel = so.abs() < 1e-7
    safe_so = torch.where(parallel, 1.0, so)
    sl = ((torch.sin((1.0 - val) * omega) / safe_so) * low
          + (torch.sin(val * omega) / safe_so) * high)
    lin = (1.0 - val) * low + val * high
    return torch.where(parallel, lin, sl)


def gradient_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     alpha: torch.Tensor, pac: int = 10) -> torch.Tensor:
    """``((||dD/dx at slerp(real, fake)|| per pac group - 1)^2).mean() *
    GP_LAMBDA``.  ``alpha`` (batch, 1) holds one uniform per row; ``d_fn``
    closes over the discriminator and its dropout masks.  The result is
    differentiable with respect to what ``d_fn`` closes over."""
    interp = slerp(alpha, real.detach(), fake.detach()).requires_grad_(True)
    (grads,) = torch.autograd.grad(d_fn(interp).sum(), interp,
                                   create_graph=True)
    norms = torch.linalg.vector_norm(
        grads.reshape(-1, pac * real.shape[1]), dim=1)
    return ((norms - 1.0) ** 2).mean() * GP_LAMBDA
