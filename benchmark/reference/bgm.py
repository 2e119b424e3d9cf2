"""A frozen copy of the variational mixture fit the program's init runs.

The reference's mixture fits: sklearn's truncated Dirichlet-process
Gaussian mixture (10 components, weight concentration prior 0.001) for
1-D columns, as one masked batch in float32 on the device: k-means from
quantile seeds, 20 Lloyd sweeps, 100 fixed variational sweeps, every sum
in a fixed order so a column's fit does not depend on its batch.  Copied
from the program's fit when the benchmark was defined, so a later change
to the program's fit is judged against this one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

N_CLUSTERS = 10
WEIGHT_EPS = 0.005
WEIGHT_CONCENTRATION_PRIOR = 0.001
N_KMEANS_ITERS = 20
MAX_ITER = 100
REG_COVAR = 1e-6
ROWS_FLOOR = 64
BATCH_FLOOR = 8
MAX_BATCH_ELEMENTS = 1 << 25


def _digamma(a: np.ndarray) -> np.ndarray:
    return torch.special.digamma(torch.as_tensor(
        a, dtype=torch.float64)).numpy()


@dataclass
class Mixture:
    """A fitted 1-D mixture: float64 arrays over the components."""

    means: np.ndarray
    stds: np.ndarray
    weights: np.ndarray
    active: np.ndarray
    mean_precision: np.ndarray
    dof: np.ndarray
    stick_a: np.ndarray
    stick_b: np.ndarray

    def posterior(self, x: np.ndarray) -> np.ndarray:
        """p(k | x) by the variational E-step, (len(x), components)."""
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        prec = 1.0 / self.stds ** 2
        log_gauss = -0.5 * (
            np.log(2.0 * np.pi) - np.log(prec)[None, :]
            + (x[:, None] - self.means[None, :]) ** 2 * prec[None, :]
        ) - 0.5 * np.log(self.dof)[None, :]
        log_lambda = np.log(2.0) + _digamma(0.5 * self.dof)
        log_prob = log_gauss + 0.5 * (log_lambda
                                      - 1.0 / self.mean_precision)[None, :]
        a, b = self.stick_a, self.stick_b
        dsum = _digamma(a + b)
        log_w = _digamma(a) - dsum + np.concatenate(
            [[0.0], np.cumsum(_digamma(b) - dsum)[:-1]])
        wlp = log_prob + log_w[None, :]
        wlp -= wlp.max(axis=1, keepdims=True)
        p = np.exp(wlp)
        return p / p.sum(axis=1, keepdims=True)

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """``n`` draws: a component by weight, then a normal."""
        comp = rng.choice(len(self.means), size=n,
                          p=self.weights / self.weights.sum())
        return rng.normal(self.means[comp], self.stds[comp])


def _pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    n = t.shape[1]
    while n > 1:
        n //= 2
        t = t[:, :n] + t[:, n:2 * n]
    return t[:, 0]


def _k_sum(t: torch.Tensor) -> torch.Tensor:
    acc = t[..., 0]
    for k in range(1, t.shape[-1]):
        acc = acc + t[..., k]
    return acc


def _k_scan(t: torch.Tensor, op) -> torch.Tensor:
    out = [t[..., 0]]
    for k in range(1, t.shape[-1]):
        out.append(op(out[-1], t[..., k]))
    return torch.stack(out, dim=-1)


def _fit_batch(x, mask, K):
    C, N = x.shape
    dev, f32 = x.device, torch.float32
    ks = torch.arange(K, device=dev)
    n_valid = _row_sum(mask).clamp_min(1.0)
    mean0 = _row_sum(x * mask) / n_valid
    var0 = (_row_sum((x - mean0[:, None]) ** 2 * mask)
            / (n_valid - 1.0).clamp_min(1.0)).clamp_min(REG_COVAR)
    xk3, mask3 = x[:, :, None], mask[:, :, None]
    srt = torch.where(mask > 0, x, torch.inf).sort(dim=1).values
    qidx = ((ks.to(f32) + 0.5) / K * n_valid[:, None]).to(torch.int32)
    centers = srt.gather(1, qidx.clamp(0, N - 1).long())
    centers = torch.where(torch.isfinite(centers), centers, mean0[:, None])

    def nearest(centers):
        assign = ((xk3 - centers[:, None, :]) ** 2).argmin(dim=2)
        return (assign[:, :, None] == ks).to(f32) * mask3

    for _ in range(N_KMEANS_ITERS):
        onehot = nearest(centers)
        cnt = _row_sum(onehot)
        new = _row_sum(onehot * xk3) / cnt.clamp_min(1e-12)
        centers = torch.where(cnt > 0, new, centers)
    resp = nearest(centers)
    tiny = 10.0 * torch.finfo(f32).eps
    zero_col = torch.zeros((C, 1), device=dev)

    def m_step(resp):
        nk = _row_sum(resp) + tiny
        xk = _row_sum(resp * xk3) / nk
        sk = _row_sum(resp * (xk3 - xk[:, None, :]) ** 2) / nk + REG_COVAR
        a = 1.0 + nk
        rev = _k_scan(nk.flip(1), torch.add).flip(1)
        b = WEIGHT_CONCENTRATION_PRIOR + torch.cat([rev[:, 1:], zero_col],
                                                   dim=1)
        mean_prec = 1.0 + nk
        means = (mean0[:, None] + nk * xk) / mean_prec
        dof = 1.0 + nk
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
            [zero_col,
             _k_scan(torch.special.digamma(b) - dsum, torch.add)[:, :-1]],
            dim=1)
        wlp = log_prob + log_w[:, None, :]
        top = wlp.amax(dim=2, keepdim=True)
        lse = top + torch.log(_k_sum(torch.exp(wlp - top)))[:, :, None]
        return torch.exp(wlp - lse) * mask3

    for _ in range(MAX_ITER):
        resp = e_step(*m_step(resp))
    a, b, mean_prec, means, dof, cov = m_step(resp)
    sticks = torch.cat([torch.ones((C, 1), device=dev),
                        _k_scan(b / (a + b), torch.mul)[:, :-1]], dim=1)
    weights = a / (a + b) * sticks
    weights = weights / _k_sum(weights)[:, None]
    return means, torch.sqrt(cov), weights, mean_prec, dof, a, b


def fit(columns, device) -> list:
    """One :class:`Mixture` per 1-D column, fitted in row-length buckets
    (rows padded to a power of two, at least 64; batches to a power of
    two, at least 8; at most ``1 << 25`` elements a batch)."""
    cols = [np.asarray(c, dtype=np.float32).reshape(-1) for c in columns]
    buckets: dict = {}
    for i, c in enumerate(cols):
        k = max(1, min(N_CLUSTERS, len(c)))
        buckets.setdefault((k, _pow2(len(c), ROWS_FLOOR)), []).append(i)
    out: list = [None] * len(cols)
    for (k, rows), idxs in sorted(buckets.items()):
        max_chunk = max(BATCH_FLOOR, MAX_BATCH_ELEMENTS // rows)
        for lo in range(0, len(idxs), max_chunk):
            chunk = idxs[lo:lo + max_chunk]
            padded = min(_pow2(len(chunk), BATCH_FLOOR), max_chunk)
            xs = np.zeros((padded, rows), dtype=np.float32)
            masks = np.zeros((padded, rows), dtype=np.float32)
            for row, i in enumerate(chunk):
                xs[row, :len(cols[i])] = cols[i]
                masks[row, :len(cols[i])] = 1.0
            res = _fit_batch(torch.as_tensor(xs, device=device),
                             torch.as_tensor(masks, device=device), k)
            means, stds, weights, mp, dof, a, b = torch.stack(
                res).cpu().double().numpy()
            for row, i in enumerate(chunk):
                out[i] = Mixture(means=means[row],
                                 stds=np.maximum(stds[row], 1e-9),
                                 weights=weights[row],
                                 active=weights[row] > WEIGHT_EPS,
                                 mean_precision=mp[row], dof=dof[row],
                                 stick_a=a[row], stick_b=b[row])
    return out
