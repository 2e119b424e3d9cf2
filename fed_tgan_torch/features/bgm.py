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

Columns are fitted in shape buckets as ``bgm_jax._fit_flat`` does (rows
and batch padded to powers of two, a cap on one dispatch's elements), and
every sum runs in a fixed order, so a column's fit is bit for bit the same
whatever it is batched with: the init cache (:mod:`fed_tgan_torch.
federation.init_cache`) relies on that.  :func:`fit_shards` fits a whole
cohort's ragged client x column structure at once.

One deviation from the JAX package: a column shorter than ``n_components``
is fitted with ``n_components = len(column)`` by the same batched fit,
where the JAX package hands it to sklearn.

The reference-exact host fit (``--bgm-backend sklearn``,
``fed_tgan_tpu/features/bgm.py:147-251``) is :func:`fit_column_gmm`: one
sklearn ``BayesianGaussianMixture`` a column on the host, with sklearn
imported only there.  Its posterior fills a :class:`ColumnGMM` (the
estimator is not kept), whose :meth:`ColumnGMM.predict_proba` is then
sklearn's own E-step, so the encode path, the checkpoints and the init
cache take either fit.  :func:`fit_backend` picks the fit by the
backend's name: ``"jax"`` (the batched fit above, the JAX CLI's default)
or ``"sklearn"``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device

N_CLUSTERS = 10
WEIGHT_EPS = 0.005
WEIGHT_CONCENTRATION_PRIOR = 0.001
N_KMEANS_ITERS = 20
MAX_ITER = 100
REG_COVAR = 1e-6
# shape buckets of the batched fit (``bgm_jax.py:41-47``): rows pad to a
# power of two, the batch to a power of two, and one dispatch holds at
# most this many (batch x rows) float32 elements
_ROWS_FLOOR = 64
_BATCH_FLOOR = 8
_MAX_BATCH_ELEMENTS = 1 << 25


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

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """``n`` draws from the mixture: a component by its weight, then
        a normal.  The same ``rng`` calls as the JAX package's
        ``ColumnGMM.sample`` (``fed_tgan_tpu/features/bgm.py:96``), so a
        generator in the same state gives the same draws."""
        comp = rng.choice(self.n_components, size=n,
                          p=self.weights / self.weights.sum())
        return rng.normal(self.means[comp], self.stds[comp])

    def to_dict(self) -> dict:
        """JSON-able lists, the JAX package's ``ColumnGMM.to_dict``
        layout."""
        return {name: np.asarray(getattr(self, name)).tolist()
                for name in _FIELDS}

    @classmethod
    def from_dict(cls, d: dict) -> "ColumnGMM":
        return cls(**{name: np.asarray(d[name], dtype=bool if name ==
                                       "active" else np.float64)
                      for name in _FIELDS})


_FIELDS = ("means", "stds", "weights", "active", "mean_precision", "dof",
           "stick_a", "stick_b")


def _pow2_at_least(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 of ``t`` (C, N, ...), N a power of two, as a fixed
    pairwise tree of elementwise adds: each column's bits depend on its
    own entries only, whatever the batch around it (a library reduction
    may pick another strategy, and another order, when C changes)."""
    n = t.shape[1]
    if n & (n - 1):
        raise ValueError(f"row axis {n} is not a power of two")
    while n > 1:
        n //= 2
        t = t[:, :n] + t[:, n:2 * n]
    return t[:, 0]


def _k_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last (components) axis, left to right."""
    acc = t[..., 0]
    for k in range(1, t.shape[-1]):
        acc = acc + t[..., k]
    return acc


def _k_scan(t: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan over the last axis with ``op``, left to right."""
    out = [t[..., 0]]
    for k in range(1, t.shape[-1]):
        out.append(op(out[-1], t[..., k]))
    return torch.stack(out, dim=-1)


def _fit_batch(x: torch.Tensor, mask: torch.Tensor, n_components: int,
               max_iter: int, reg_covar: float, wc_prior: float):
    """Variational DP-GMM of every row of ``x`` (C, N) float32, where
    ``mask`` (C, N) marks the valid entries and N is a power of two
    (``bgm_jax._fit_batch``).  Every sum runs in a fixed order
    (:func:`_row_sum`, :func:`_k_sum`, :func:`_k_scan`), so a column's fit
    is bit for bit the same alone and among any batch of its row bucket.
    Returns (means, stds, weights, mean_precision, dof, stick_a, stick_b),
    each (C, n_components)."""
    K, (C, N) = n_components, x.shape
    dev, f32 = x.device, torch.float32
    ks = torch.arange(K, device=dev)
    n_valid = _row_sum(mask).clamp_min(1.0)
    mean0 = _row_sum(x * mask) / n_valid
    # sklearn's default covariance prior is the (ddof=1) sample variance
    var0 = (_row_sum((x - mean0[:, None]) ** 2 * mask)
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
        cnt = _row_sum(onehot)
        new = _row_sum(onehot * xk3) / cnt.clamp_min(1e-12)
        centers = torch.where(cnt > 0, new, centers)
    resp = nearest_onehot(centers)

    tiny = 10.0 * torch.finfo(f32).eps
    zero_col = torch.zeros((C, 1), device=dev)

    def m_step(resp):
        nk = _row_sum(resp) + tiny
        xk = _row_sum(resp * xk3) / nk
        sk = _row_sum(resp * (xk3 - xk[:, None, :]) ** 2) / nk + reg_covar
        a = 1.0 + nk  # stick-breaking Beta posteriors
        # rev[k] = sum_{j >= k} n_j
        rev = _k_scan(nk.flip(1), torch.add).flip(1)
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
            [zero_col,
             _k_scan(torch.special.digamma(b) - dsum, torch.add)[:, :-1]],
            dim=1)
        wlp = log_prob + log_w[:, None, :]
        # logsumexp over the components: max, then a fixed-order sum
        top = wlp.amax(dim=2, keepdim=True)
        lse = top + torch.log(_k_sum(torch.exp(wlp - top)))[:, :, None]
        return torch.exp(wlp - lse) * mask3

    for _ in range(max_iter):
        resp = e_step(*m_step(resp))
    a, b, mean_prec, means, dof, cov = m_step(resp)

    sticks = torch.cat([torch.ones((C, 1), device=dev),
                        _k_scan(b / (a + b), torch.mul)[:, :-1]], dim=1)
    weights = a / (a + b) * sticks
    weights = weights / _k_sum(weights)[:, None]
    return means, torch.sqrt(cov), weights, mean_prec, dof, a, b


def fit_columns(columns: Sequence[np.ndarray], n_components: int = N_CLUSTERS,
                eps: float = WEIGHT_EPS, max_iter: int = MAX_ITER,
                reg_covar: float = REG_COVAR,
                wc_prior: float = WEIGHT_CONCENTRATION_PRIOR,
                device="cuda") -> list[ColumnGMM]:
    """Fit one mixture per 1-D column on ``device``, in shape-bucketed
    batches (``bgm_jax._fit_flat``): rows pad to the next power of two
    (floor 64), a batch pads to a power of two (floor 8) with fully
    masked columns, and one dispatch holds at most ``1 << 25`` (batch x
    rows) elements.  A column's fit does not depend on the columns it is
    batched with (:func:`_fit_batch`).  A column shorter than
    ``n_components`` is fitted with one component per row."""
    device = resolve_device(device)
    cols = [np.asarray(c, dtype=np.float32).reshape(-1) for c in columns]
    buckets: dict[tuple, list[int]] = {}
    for i, c in enumerate(cols):
        k = max(1, min(n_components, len(c)))
        buckets.setdefault((k, _pow2_at_least(len(c), _ROWS_FLOOR)),
                           []).append(i)
    out: list = [None] * len(cols)
    for (k, rows), idxs in sorted(buckets.items()):
        max_chunk = max(_BATCH_FLOOR, _MAX_BATCH_ELEMENTS // rows)
        for lo in range(0, len(idxs), max_chunk):
            chunk = idxs[lo:lo + max_chunk]
            padded = min(_pow2_at_least(len(chunk), _BATCH_FLOOR), max_chunk)
            xs = np.zeros((padded, rows), dtype=np.float32)
            masks = np.zeros((padded, rows), dtype=np.float32)
            for row, i in enumerate(chunk):
                xs[row, :len(cols[i])] = cols[i]
                masks[row, :len(cols[i])] = 1.0
            fitted = _fit_batch(torch.as_tensor(xs, device=device),
                                torch.as_tensor(masks, device=device), k,
                                max_iter, reg_covar, wc_prior)
            # one copy to the host for all seven results of a dispatch
            # torchlint: disable=J01
            means, stds, weights, mean_prec, dof, a, b = torch.stack(
                fitted).cpu().double().numpy()
            for row, i in enumerate(chunk):
                out[i] = ColumnGMM(
                    means=means[row], stds=np.maximum(stds[row], 1e-9),
                    weights=weights[row], active=weights[row] > eps,
                    mean_precision=mean_prec[row], dof=dof[row],
                    stick_a=a[row], stick_b=b[row])
    return out


def fit_shards(shard_columns: Sequence[Sequence[np.ndarray]],
               n_components: int = N_CLUSTERS, eps: float = WEIGHT_EPS,
               max_iter: int = MAX_ITER, reg_covar: float = REG_COVAR,
               wc_prior: float = WEIGHT_CONCENTRATION_PRIOR,
               device="cuda") -> list[list[ColumnGMM]]:
    """Every continuous column of every client shard in one bucketed
    :func:`fit_columns` (``bgm_jax.fit_shards_jax``): ``shard_columns[i]``
    is client i's list of 1-D columns, and the result has the same ragged
    structure."""
    flat: list[np.ndarray] = []
    offsets = [0]
    for shard in shard_columns:
        flat.extend(np.asarray(c, dtype=np.float32).reshape(-1)
                    for c in shard)
        offsets.append(len(flat))
    fitted = fit_columns(flat, n_components, eps, max_iter, reg_covar,
                         wc_prior, device=device) if flat else []
    return [fitted[offsets[i]:offsets[i + 1]]
            for i in range(len(shard_columns))]


BACKENDS = ("jax", "sklearn")


def _host_fit_settings() -> tuple[int, float]:
    """``max_iter`` and ``tol`` of the host fit: sklearn's defaults, which
    the reference fits at, unless ``FED_TGAN_TORCH_BGM_MAX_ITER`` /
    ``FED_TGAN_TORCH_BGM_TOL`` override them (the JAX package's
    ``FED_TGAN_TPU_BGM_*`` levers); an unparsable value keeps both."""
    try:
        return (int(os.environ.get("FED_TGAN_TORCH_BGM_MAX_ITER", 100)),
                float(os.environ.get("FED_TGAN_TORCH_BGM_TOL", 1e-3)))
    except ValueError:
        return 100, 1e-3


def fit_column_gmm(x: np.ndarray, n_components: int = N_CLUSTERS,
                   eps: float = WEIGHT_EPS,
                   seed: Optional[int] = None) -> ColumnGMM:
    """The reference-exact fit of one column on the host: sklearn's
    ``BayesianGaussianMixture`` with a Dirichlet-process prior of 0.001,
    one initialisation, ``random_state=seed`` and at most one component a
    row.  The ``ConvergenceWarning`` of a fit that stops at ``max_iter``
    is silenced: the reference's fits routinely do.  The column is
    fitted from a contiguous copy: sklearn's sums over a strided column
    round differently, and the JAX package's columns are contiguous (its
    encoded matrices are column-major)."""
    try:
        from sklearn.exceptions import ConvergenceWarning
        from sklearn.mixture import BayesianGaussianMixture
    except ImportError as exc:
        raise ImportError("the host BGM fit (--bgm-backend sklearn) needs "
                          "sklearn, which does not import here") from exc
    import warnings

    x = np.ascontiguousarray(x, dtype=np.float64).reshape(-1, 1)
    max_iter, tol = _host_fit_settings()
    gm = BayesianGaussianMixture(
        n_components=max(1, min(n_components, len(x))),
        weight_concentration_prior_type="dirichlet_process",
        weight_concentration_prior=WEIGHT_CONCENTRATION_PRIOR,
        n_init=1, max_iter=max_iter, tol=tol, random_state=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ConvergenceWarning)
        gm.fit(x)
    weights = np.asarray(gm.weights_, dtype=np.float64).reshape(-1)
    stick_a, stick_b = gm.weight_concentration_
    return ColumnGMM(
        means=np.asarray(gm.means_, dtype=np.float64).reshape(-1),
        stds=np.sqrt(np.asarray(gm.covariances_,
                                dtype=np.float64)).reshape(-1),
        weights=weights, active=weights > eps,
        mean_precision=np.asarray(gm.mean_precision_, dtype=np.float64),
        dof=np.asarray(gm.degrees_of_freedom_, dtype=np.float64),
        stick_a=np.asarray(stick_a, dtype=np.float64),
        stick_b=np.asarray(stick_b, dtype=np.float64))


def fit_column_gmms(columns: Sequence[np.ndarray],
                    n_components: int = N_CLUSTERS, eps: float = WEIGHT_EPS,
                    seed: Optional[int] = None) -> list[ColumnGMM]:
    """:func:`fit_column_gmm` of every column, one after the other, each
    with the same ``seed`` (``fed_tgan_tpu/features/bgm.py:216``)."""
    return [fit_column_gmm(c, n_components, eps, seed) for c in columns]


def fit_backend(columns: Sequence[np.ndarray], backend: str = "jax",
                n_components: int = N_CLUSTERS, eps: float = WEIGHT_EPS,
                seed: Optional[int] = None, device="cuda") -> list[ColumnGMM]:
    """One mixture per column by ``backend``: ``"jax"`` is
    :func:`fit_columns` on ``device``, ``"sklearn"`` the host fit
    (``seed`` its ``random_state``)."""
    if backend == "jax":
        return fit_columns(columns, n_components, eps, device=device)
    if backend == "sklearn":
        return fit_column_gmms(columns, n_components, eps, seed)
    raise ValueError(f"unknown BGM backend {backend!r} (expected one of "
                     f"{BACKENDS})")
