"""WGAN-GP losses with the reference's slerp interpolation
(counterpart of ``fed_tgan_tpu/models/losses.py:22-66``).

The gradient penalty interpolates real/fake pairs *spherically*, not
linearly (reference Server/dtds/synthesizers/ctgan.py:231-258).  Its
second-order gradient is ``torch.autograd.grad(..., create_graph=True)``
through a discriminator made of differentiable ops only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fed_tgan_torch.runtime.precision import as_dtype, f32_island

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
                     alpha: torch.Tensor, pac: int = 10,
                     clients: Optional[int] = None) -> torch.Tensor:
    """``((||dD/dx at slerp(real, fake)|| per pac group - 1)^2).mean() *
    GP_LAMBDA``.  ``alpha`` (batch, 1) holds one uniform per row; ``d_fn``
    closes over the discriminator and its dropout masks.  The result is
    differentiable with respect to what ``d_fn`` closes over.

    With ``clients`` = N the rows are N clients' batches, client-major,
    and the result is (N,): each client's mean over its own groups.

    Under bf16 compute (``real``, ``fake`` bf16) the slerp and the
    gradient's norm are float32 islands (``fed_tgan_tpu/models/losses.py:
    53-65``): the interpolation is computed in float32 and cast to the
    inputs' dtype, the critic and its double backward run in that dtype,
    and the gradient is cast to float32 before its norm.  In f32 every
    cast is the tensor itself."""
    interp = as_dtype(slerp(alpha, f32_island(real.detach()),
                            f32_island(fake.detach())),
                      real.dtype).requires_grad_(True)
    (grads,) = torch.autograd.grad(d_fn(interp).sum(), interp,
                                   create_graph=True)
    norms = torch.linalg.vector_norm(
        f32_island(grads).reshape(-1, pac * real.shape[1]), dim=1)
    sq = (norms - 1.0) ** 2
    if clients is not None:
        return sq.reshape(clients, -1).mean(dim=1) * GP_LAMBDA
    return sq.mean() * GP_LAMBDA
