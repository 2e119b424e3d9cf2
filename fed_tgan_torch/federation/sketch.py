"""Device-computed similarity sketches (counterpart of
``fed_tgan_tpu/federation/sketch.py``).

A column's fitted mixture has CDF ``F_i(x) = sum_k w_ik Phi((x - mu_ik) /
s_ik)``; the pooled reference is ``F_bar = sum_i omega_i F_i``, and
``W1(F_i, F_bar) = integral |F_i(x) - F_bar(x)| dx``, evaluated on a
shared per-column grid for every (mixture, column) at once.  The canary
(:mod:`fed_tgan_torch.serve.canary`) scores a shadow sample with it, and
``--similarity sketch`` scores every client of an init with it
(:func:`wd_sketch`) instead of N Monte-Carlo host passes.  The pooled
refit draws a fixed budget from the pooled mixture
(:func:`pooled_mixture_sample`), so its cost does not grow with N.

:func:`wd_scores` runs in plain PyTorch on the tensors' device: the JAX
package computes this outside any Pallas kernel too.  JAX accumulates
the K components in a ``lax.scan``; here the components are one axis of
a ``(N, C, K, G)`` tensor summed at once, one pass of a few elementwise
kernels instead of K small ones.  At the canary's ``(2, C, 256)`` and
512 grid points that tensor is ``C`` MB (float32), which the card holds
without effort.

The stacks and the pool's draw are host numpy; the draw makes the JAX
package's ``default_rng`` calls, so its samples equal JAX's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.obs.trace import span as _span

GRID_POINTS = 512
POOL_BUDGET = 65536
_TAIL_SIGMAS = 4.5


def stack_client_gmms(client_gmms: Sequence[Sequence], cont_cols:
                      Sequence[int], n_components: Optional[int] = None
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-client per-column mixtures as (N, C, K) float64 means, stds and
    weights; a client with fewer components (the clamp of a tiny shard)
    pads with zero-weight components of std 1."""
    n_clients = len(client_gmms)
    if n_components is None:
        n_components = max(client_gmms[i][j].n_components
                           for i in range(n_clients) for j in cont_cols)
    shape = (n_clients, len(cont_cols), n_components)
    means = np.zeros(shape, dtype=np.float64)
    stds = np.ones(shape, dtype=np.float64)
    weights = np.zeros(shape, dtype=np.float64)
    for i in range(n_clients):
        for cursor, j in enumerate(cont_cols):
            g = client_gmms[i][j]
            k = g.n_components
            means[i, cursor, :k] = g.means
            stds[i, cursor, :k] = np.maximum(g.stds, 1e-9)
            w = np.maximum(g.weights, 0.0)
            weights[i, cursor, :k] = w / max(w.sum(), 1e-300)
    return means, stds, weights


def live_omega(rows_per_client: Sequence[int],
               alive: Optional[np.ndarray] = None) -> np.ndarray:
    """Rows-proportional pool weights over the live clients only (a
    departed client keeps its stack row, at weight 0)."""
    omega = np.asarray(rows_per_client, dtype=np.float64)
    if alive is not None:
        omega = omega * np.asarray(alive, dtype=bool)
    total = omega.sum()
    if total <= 0.0:
        raise ValueError("no live residents: pooled reference is empty")
    return omega / total


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
    pooled = (cdf * omega[:, None, None]).sum(dim=0)
    dx = (grid[:, -1] - grid[:, 0]) / (g - 1)
    return (cdf - pooled[None]).abs().sum(dim=-1) * dx[None, :]


def wd_sketch(client_gmms: Optional[Sequence[Sequence]],
              rows_per_client: Optional[Sequence[int]],
              cont_cols: Sequence[int], grid_points: int = GRID_POINTS,
              omega: Optional[np.ndarray] = None,
              stacks: Optional[tuple] = None, device="cuda") -> np.ndarray:
    """Raw per-client per-column W1 against the pooled reference, (N, C)
    float64, scored by :func:`wd_scores` in float32 on ``device``.
    ``omega`` overrides the rows-proportional pool weights (streaming
    registration gives newcomers 0: scored, not shaping the pool)."""
    means, stds, weights = (stacks if stacks is not None
                            else stack_client_gmms(client_gmms, cont_cols))
    n_clients = means.shape[0]
    if not len(cont_cols):
        return np.zeros((n_clients, 0), dtype=np.float64)
    if omega is None:
        omega = np.asarray(rows_per_client, dtype=np.float64)
        omega = omega / omega.sum()
    grid = column_grids(means, stds, weights, grid_points)
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                     device=dev)
    with _span("init.wd_sketch", clients=n_clients, columns=len(cont_cols)):
        wd = wd_scores(as_t(means), as_t(stds), as_t(weights), as_t(omega),
                       as_t(grid)).cpu().numpy()
    return wd.astype(np.float64)


def pooled_mixture_sample(client_gmms: Optional[Sequence[Sequence]],
                          rows_per_client: Sequence[int],
                          cont_cols: Sequence[int],
                          budget: int = POOL_BUDGET, seed: int = 0,
                          stacks: Optional[tuple] = None) -> list:
    """One budgeted draw per column from the pooled mixture (components
    ``omega_i * w_ik``): the refit's input, whose size does not grow with
    the population."""
    means, stds, weights = (stacks if stacks is not None
                            else stack_client_gmms(client_gmms, cont_cols))
    omega = np.asarray(rows_per_client, dtype=np.float64)
    omega = omega / omega.sum()
    rng = np.random.default_rng(seed)
    out = []
    for cursor in range(len(cont_cols)):
        flat_w = (omega[:, None] * weights[:, cursor, :]).reshape(-1)
        flat_w = flat_w / flat_w.sum()
        comp = rng.choice(flat_w.size, size=budget, p=flat_w)
        out.append(rng.normal(means[:, cursor, :].reshape(-1)[comp],
                              stds[:, cursor, :].reshape(-1)[comp]))
    return out
