"""Per-column variational Gaussian mixtures for mode-specific normalization
(counterpart of ``fed_tgan_tpu/features/bgm.py:28-129`` and the batched fit
of ``fed_tgan_tpu/features/bgm_jax.py:55-238``).

The reference fits one sklearn ``BayesianGaussianMixture(n_components=10,
weight_concentration_prior_type="dirichlet_process",
weight_concentration_prior=0.001)`` per continuous column.  sklearn is not
part of the port: :func:`fit_columns` runs the same model, a truncated
Dirichlet-process mixture of 1-D Gaussians with sklearn's update equations
and default priors, as one masked batch over all columns in torch float32
on the device, as the JAX package's ``bgm_jax`` does:

- k-means initialisation from quantile seeds with 20 Lloyd sweeps (not
  sklearn's seeded k-means++);
- 100 fixed variational sweeps (no lower-bound early stop; sklearn mostly
  hits its 100-iteration cap on real columns anyway);
- stick-breaking expected weights; a mode is active when its weight
  exceeds 0.005.

One deviation from the JAX package: a column shorter than ``n_components``
is fitted with ``n_components = len(column)`` by the same batched fit,
where the JAX package hands it to sklearn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device

N_CLUSTERS = 10
WEIGHT_EPS = 0.005
WEIGHT_CONCENTRATION_PRIOR = 0.001
N_KMEANS_ITERS = 20
MAX_ITER = 100
REG_COVAR = 1e-6


def _digamma(a: np.ndarray) -> np.ndarray:
    return torch.special.digamma(torch.as_tensor(a, dtype=torch.float64)).numpy()


@dataclass
class ColumnGMM:
    """A fitted 1-D mixture as float64 arrays of shape (n_components,):
    the posterior means and stds, the expected weights, ``active =
    weights > eps``, and the variational posterior parameters that
    :meth:`predict_proba` needs."""

    means: np.ndarray
    stds: np.ndarray
    weights: np.ndarray
    active: np.ndarray
    mean_precision: np.ndarray
    dof: np.ndarray
    stick_a: np.ndarray
    stick_b: np.ndarray

    @property
    def n_components(self) -> int:
        return len(self.means)

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """Posterior responsibilities p(k | x), (len(x), n_components):
        sklearn's variational E-step for a 1-D mixture, the formula the fit
        iterates (``fed_tgan_tpu/features/bgm.py:72-94``), in float64."""
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        prec = 1.0 / self.stds ** 2
        log_gauss = -0.5 * (
            np.log(2.0 * np.pi) - np.log(prec)[None, :]
            + (x[:, None] - self.means[None, :]) ** 2 * prec[None, :]
        ) - 0.5 * np.log(self.dof)[None, :]
        log_lambda = np.log(2.0) + _digamma(0.5 * self.dof)
        log_prob = log_gauss + 0.5 * (log_lambda - 1.0 / self.mean_precision)[None, :]
        a, b = self.stick_a, self.stick_b
        dsum = _digamma(a + b)
        log_w = _digamma(a) - dsum + np.concatenate(
            [[0.0], np.cumsum(_digamma(b) - dsum)[:-1]])
        wlp = log_prob + log_w[None, :]
        wlp -= wlp.max(axis=1, keepdims=True)
        p = np.exp(wlp)
        return p / p.sum(axis=1, keepdims=True)


def _fit_batch(x: torch.Tensor, mask: torch.Tensor, n_components: int,
               max_iter: int, reg_covar: float, wc_prior: float):
    """Variational DP-GMM of every row of ``x`` (C, N) float32, where
    ``mask`` (C, N) marks the valid entries (``bgm_jax._fit_batch``).
    Returns (means, stds, weights, mean_precision, dof, stick_a, stick_b),
    each (C, n_components)."""
    K, (C, N) = n_components, x.shape
    dev, f32 = x.device, torch.float32
    ks = torch.arange(K, device=dev)
    n_valid = mask.sum(1).clamp_min(1.0)
    mean0 = (x * mask).sum(1) / n_valid
    # sklearn's default covariance prior is the (ddof=1) sample variance
    var0 = (((x - mean0[:, None]) ** 2 * mask).sum(1)
            / (n_valid - 1.0).clamp_min(1.0)).clamp_min(reg_covar)
    xk3, mask3 = x[:, :, None], mask[:, :, None]

    # k-means initialisation: quantile seeds from the valid entries (the
    # padding sorts to +inf, past every quantile index), Lloyd sweeps
    srt = torch.where(mask > 0, x, torch.inf).sort(dim=1).values
    qidx = ((ks.to(f32) + 0.5) / K * n_valid[:, None]).to(torch.int32)
    centers = srt.gather(1, qidx.clamp(0, N - 1).long())
    centers = torch.where(torch.isfinite(centers), centers, mean0[:, None])

    def nearest_onehot(centers):
        assign = ((xk3 - centers[:, None, :]) ** 2).argmin(dim=2)
        return (assign[:, :, None] == ks).to(f32) * mask3

    for _ in range(N_KMEANS_ITERS):
        onehot = nearest_onehot(centers)
        cnt = onehot.sum(1)
        new = (onehot * xk3).sum(1) / cnt.clamp_min(1e-12)
        centers = torch.where(cnt > 0, new, centers)
    resp = nearest_onehot(centers)

    tiny = 10.0 * torch.finfo(f32).eps
    zero_col = torch.zeros((C, 1), device=dev)

    def m_step(resp):
        nk = resp.sum(1) + tiny
        xk = (resp * xk3).sum(1) / nk
        sk = (resp * (xk3 - xk[:, None, :]) ** 2).sum(1) / nk + reg_covar
        a = 1.0 + nk  # stick-breaking Beta posteriors
        rev = nk.flip(1).cumsum(1).flip(1)  # rev[k] = sum_{j >= k} n_j
        b = wc_prior + torch.cat([rev[:, 1:], zero_col], dim=1)
        mean_prec = 1.0 + nk  # mean_precision_prior 1
        means = (mean0[:, None] + nk * xk) / mean_prec
        dof = 1.0 + nk  # degrees_of_freedom_prior 1
        cov = (var0[:, None] + nk * sk
               + (nk / mean_prec) * (xk - mean0[:, None]) ** 2) / dof
        return a, b, mean_prec, means, dof, cov

    def e_step(a, b, mean_prec, means, dof, cov):
        prec = 1.0 / cov
        log_gauss = -0.5 * (
            math.log(2.0 * math.pi) - torch.log(prec)[:, None, :]
            + (xk3 - means[:, None, :]) ** 2 * prec[:, None, :]
        ) - 0.5 * torch.log(dof)[:, None, :]
        log_lambda = math.log(2.0) + torch.special.digamma(0.5 * dof)
        log_prob = log_gauss + 0.5 * (log_lambda - 1.0 / mean_prec)[:, None, :]
        dsum = torch.special.digamma(a + b)
        log_w = torch.special.digamma(a) - dsum + torch.cat(
            [zero_col, torch.cumsum(torch.special.digamma(b) - dsum, 1)[:, :-1]],
            dim=1)
        wlp = log_prob + log_w[:, None, :]
        return torch.exp(wlp - torch.logsumexp(wlp, 2, keepdim=True)) * mask3

    for _ in range(max_iter):
        resp = e_step(*m_step(resp))
    a, b, mean_prec, means, dof, cov = m_step(resp)

    sticks = torch.cat([torch.ones((C, 1), device=dev),
                        torch.cumprod(b / (a + b), 1)[:, :-1]], dim=1)
    weights = a / (a + b) * sticks
    weights = weights / weights.sum(1, keepdim=True)
    return means, torch.sqrt(cov), weights, mean_prec, dof, a, b


def fit_columns(columns: Sequence[np.ndarray], n_components: int = N_CLUSTERS,
                eps: float = WEIGHT_EPS, max_iter: int = MAX_ITER,
                reg_covar: float = REG_COVAR,
                wc_prior: float = WEIGHT_CONCENTRATION_PRIOR,
                device="cuda") -> list[ColumnGMM]:
    """Fit one mixture per 1-D column on ``device``: one masked batch per
    component count (columns shorter than ``n_components`` use their
    length)."""
    device = resolve_device(device)
    cols = [np.asarray(c, dtype=np.float32).reshape(-1) for c in columns]
    groups: dict[int, list[int]] = {}
    for i, c in enumerate(cols):
        groups.setdefault(max(1, min(n_components, len(c))), []).append(i)
    out: list = [None] * len(cols)
    for k, idxs in groups.items():
        n = max(len(cols[i]) for i in idxs)
        xs = np.zeros((len(idxs), n), dtype=np.float32)
        masks = np.zeros((len(idxs), n), dtype=np.float32)
        for row, i in enumerate(idxs):
            xs[row, :len(cols[i])] = cols[i]
            masks[row, :len(cols[i])] = 1.0
        fitted = _fit_batch(torch.as_tensor(xs, device=device),
                            torch.as_tensor(masks, device=device), k,
                            max_iter, reg_covar, wc_prior)
        # one copy to the host for all seven results
        means, stds, weights, mean_prec, dof, a, b = torch.stack(
            fitted).cpu().double().numpy()
        for row, i in enumerate(idxs):
            out[i] = ColumnGMM(
                means=means[row], stds=np.maximum(stds[row], 1e-9),
                weights=weights[row], active=weights[row] > eps,
                mean_precision=mean_prec[row], dof=dof[row],
                stick_a=a[row], stick_b=b[row])
    return out
