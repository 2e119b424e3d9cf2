"""The mixture-CDF Wasserstein scorer (counterpart of the scoring part of
``fed_tgan_tpu/federation/sketch.py``: ``GRID_POINTS`` ``:34``,
``_wd_impl`` ``:93-112``, ``column_grids`` ``:121-138``).

A column's fitted mixture has CDF ``F_i(x) = sum_k w_ik Phi((x - mu_ik) /
s_ik)``; the pooled reference is ``F_bar = sum_i omega_i F_i``, and
``W1(F_i, F_bar) = integral |F_i(x) - F_bar(x)| dx``, evaluated on a
shared per-column grid for every (mixture, column) at once.  The canary
(:mod:`fed_tgan_torch.serve.canary`) scores a shadow sample with it.

:func:`wd_scores` runs in plain PyTorch on the tensors' device: the JAX
package computes this outside any Pallas kernel too.  JAX accumulates
the K components in a ``lax.scan``; here the components are one axis of
a ``(N, C, K, G)`` tensor summed at once, one pass of a few elementwise
kernels instead of K small ones.  At the canary's ``(2, C, 256)`` and
512 grid points that tensor is ``C`` MB (float32), which the card holds
without effort.

The rest of the JAX module (``stack_client_gmms``, ``live_omega``,
``wd_sketch`` and the pooled refit draw) belongs to ``--similarity
sketch`` and is not ported yet (ROADMAP A.16).
"""

from __future__ import annotations

import numpy as np
import torch

GRID_POINTS = 512
_TAIL_SIGMAS = 4.5


def column_grids(means: np.ndarray, stds: np.ndarray, weights: np.ndarray,
                 grid_points: int = GRID_POINTS) -> np.ndarray:
    """Shared (C, G) integration grid spanning every active component's
    mean +- 4.5 sigma (host numpy: the bounds are data-dependent)."""
    valid = weights > 0.0
    lo_all = np.where(valid, means - _TAIL_SIGMAS * stds, np.inf)
    hi_all = np.where(valid, means + _TAIL_SIGMAS * stds, -np.inf)
    lo = lo_all.min(axis=(0, 2))
    hi = hi_all.max(axis=(0, 2))
    bad = ~np.isfinite(lo) | ~np.isfinite(hi) | (hi <= lo)
    lo = np.where(bad, np.where(np.isfinite(lo), lo, 0.0) - 0.5, lo)
    hi = np.where(bad, lo + 1.0, hi)
    steps = np.arange(grid_points, dtype=np.float64) / (grid_points - 1)
    return lo[:, None] + (hi - lo)[:, None] * steps[None, :]


def wd_scores(means: torch.Tensor, stds: torch.Tensor,
              weights: torch.Tensor, omega: torch.Tensor,
              grid: torch.Tensor) -> torch.Tensor:
    """(N, C, K) mixtures + (N,) pool weights + (C, G) grid -> (N, C) W1,
    on the tensors' device."""
    g = grid.shape[1]
    z = (grid[None, :, None, :] - means[..., None]) / stds[..., None]
    cdf = (weights[..., None] * torch.special.ndtr(z)).sum(dim=2)
    pooled = torch.einsum("ncg,n->cg", cdf, omega)
    dx = (grid[:, -1] - grid[:, 0]) / (g - 1)
    return (cdf - pooled[None]).abs().sum(dim=-1) * dx[None, :]
