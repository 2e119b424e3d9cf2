"""The reference's alternative table encoders (counterpart of
``fed_tgan_tpu/features/zoo.py``), without pandas.

Five encoders beside the federation's :class:`~fed_tgan_torch.features.
transformer.ModeNormalizer`, one metadata scheme (:func:`infer_zoo_meta`):

- :class:`BinningTransformer`: uniform-width bins of each continuous
  column (integer codes; the reference's ``DiscretizeTransformer``);
- :class:`MinMaxTransformer`: continuous and ordinal columns scaled to
  [0, 1] (``sigmoid``) or [-1, 1] (``tanh``), categorical ones one-hot
  (``GeneralTransformer``);
- :class:`GMMTransformer`: sklearn's ``GaussianMixture`` a continuous
  column, the mode-specific scalar at the argmax mode plus the posterior;
- :class:`BGMTransformer`: the host BGM fit
  (:func:`~fed_tgan_torch.features.bgm.fit_column_gmm`) a column, the
  mode drawn from the posterior (the standalone CTGAN's encoder);
- :class:`GridTransformer`: every column min-max scaled to [-1, 1], a row
  padded into a ``(1, side, side)`` image (``TableganTransformer``).

Each encoder takes ``device`` (the card unless the caller asks for the
CPU) and keeps its fitted numbers as tensors there; ``transform`` returns
a tensor on it, computed in float64 and cast as the JAX package casts,
so the card's tensor equals the CPU's bit for bit.  The category lookup,
and for the two mixtures the posterior and the seeded mode draws
(``np.random.default_rng(seed)``, the JAX package's stream), run on the
host and are moved to the device.  ``inverse_transform`` takes a tensor
or an array and returns the JAX package's numpy object array, and
``output_info`` is the JAX package's.  sklearn is imported by the two
mixtures' ``fit`` only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from fed_tgan_torch.data.constants import CATEGORICAL, CONTINUOUS, ORDINAL
from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.features.bgm import ColumnGMM, fit_column_gmm

F64 = torch.float64


@dataclass
class ZooColumnMeta:
    """One column: categorical and ordinal columns map values to ``i2s``
    in descending frequency; continuous ones keep their min and max."""

    name: object
    kind: str
    i2s: list = field(default_factory=list)
    min: float = 0.0
    max: float = 0.0

    @property
    def size(self) -> int:
        return len(self.i2s)


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _by_frequency(values: list) -> list:
    """``pandas.Series.value_counts().index``: the distinct values by
    descending count, ties in order of first appearance, missing values
    left out."""
    counts: dict = {}
    for v in values:
        if not _missing(v):
            counts[v] = counts.get(v, 0) + 1
    return sorted(counts, key=lambda v: -counts[v])


def infer_zoo_meta(data: np.ndarray, categorical_columns: Sequence[int] = (),
                   ordinal_columns: Sequence[int] = ()) -> list[ZooColumnMeta]:
    """Column metadata of a raw 2-D array, columns named by index."""
    data = np.asarray(data)
    meta = []
    for index in range(data.shape[1]):
        values = data[:, index].tolist()
        if index in categorical_columns or index in ordinal_columns:
            kind = CATEGORICAL if index in categorical_columns else ORDINAL
            meta.append(ZooColumnMeta(name=index, kind=kind,
                                      i2s=_by_frequency(values)))
        else:
            present = [v for v in values if not _missing(v)]
            meta.append(ZooColumnMeta(name=index, kind=CONTINUOUS,
                                      min=float(min(present)),
                                      max=float(max(present))))
    return meta


def _codes(col: np.ndarray, i2s: list) -> np.ndarray:
    """value -> its index in ``i2s`` (a host lookup)."""
    lut = {v: i for i, v in enumerate(i2s)}
    return np.fromiter((lut[v] for v in col.tolist()), dtype=np.int64,
                       count=len(col))


def _host(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _decode(onehot: np.ndarray, i2s: list) -> np.ndarray:
    return np.asarray(i2s, dtype=object)[np.argmax(onehot, axis=1)]


class _Encoder:
    """The device and the fitted metadata every encoder shares."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.meta: Optional[list[ZooColumnMeta]] = None

    def _tensor(self, values, dtype=F64) -> torch.Tensor:
        # float64 on the device by design: the zoo's encoders match the
        # JAX package's float64 numpy bit for bit
        # torchlint: disable=J06
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    def _column(self, data: np.ndarray, i: int) -> torch.Tensor:
        """Column ``i`` of the raw table as float64 on the device."""
        return self._tensor(data[:, i].astype(np.float64))

    def _onehot(self, codes: np.ndarray, size: int) -> torch.Tensor:
        return torch.nn.functional.one_hot(
            self._tensor(codes, torch.int64), size).to(torch.float32)


class BinningTransformer(_Encoder):
    """Uniform-width bins of each continuous column, categorical and
    ordinal columns as their ``i2s`` index; the inverse maps a bin to its
    centre."""

    def __init__(self, n_bins: int, device="cuda"):
        super().__init__(device)
        self.n_bins = n_bins

    def fit(self, data, categorical_columns=(), ordinal_columns=()):
        self.meta = infer_zoo_meta(data, categorical_columns, ordinal_columns)
        self.continuous_idx = [i for i, m in enumerate(self.meta)
                               if m.kind == CONTINUOUS]
        self.edges = {
            i: (self.meta[i].min,
                max(self.meta[i].max - self.meta[i].min, 1e-12))
            for i in self.continuous_idx}
        # per continuous column (lo, span), on the device
        self.bins = {i: self._tensor(e) for i, e in self.edges.items()}

    def transform(self, data) -> torch.Tensor:
        """(rows, columns) int64 codes."""
        data = np.asarray(data)
        cols = []
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                lo, span = self.bins[i]
                codes = torch.floor((self._column(data, i) - lo) / span
                                    * self.n_bins)
                cols.append(codes.clamp(0, self.n_bins - 1).to(torch.int64))
            else:
                cols.append(self._tensor(_codes(data[:, i], m.i2s),
                                         torch.int64))
        return torch.stack(cols, dim=1)

    def inverse_transform(self, data) -> np.ndarray:
        data = _host(data)
        out = np.empty((len(data), len(self.meta)), dtype=object)
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                lo, span = self.edges[i]
                codes = data[:, i].astype(np.float64)
                out[:, i] = lo + (codes + 0.5) / self.n_bins * span
            else:
                idx = data[:, i].astype(np.int64).clip(0, m.size - 1)
                out[:, i] = np.asarray(m.i2s, dtype=object)[idx]
        return out


class MinMaxTransformer(_Encoder):
    """Continuous and ordinal columns scaled to [0, 1] (``act="sigmoid"``)
    or [-1, 1] (``"tanh"``), categorical columns one-hot."""

    def __init__(self, act: str = "sigmoid", device="cuda"):
        if act not in ("sigmoid", "tanh"):
            raise ValueError(f"act {act!r}: expected sigmoid or tanh")
        super().__init__(device)
        self.act = act

    def fit(self, data, categorical_columns=(), ordinal_columns=()):
        self.meta = infer_zoo_meta(data, categorical_columns, ordinal_columns)
        self.output_info = [
            (1, self.act) if m.kind in (CONTINUOUS, ORDINAL)
            else (m.size, "softmax") for m in self.meta]
        self.output_dim = sum(s for s, _ in self.output_info)
        # per column (min, span) of a continuous column, on the device
        self.scale = {i: self._tensor([m.min, max(m.max - m.min, 1e-12)])
                      for i, m in enumerate(self.meta)
                      if m.kind == CONTINUOUS}

    def transform(self, data) -> torch.Tensor:
        """(rows, output_dim) float32."""
        data = np.asarray(data)
        parts = []
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                lo, span = self.scale[i]
                x = (self._column(data, i) - lo) / span
            elif m.kind == ORDINAL:
                x = self._tensor(_codes(data[:, i], m.i2s)) / m.size
            else:
                parts.append(self._onehot(_codes(data[:, i], m.i2s), m.size))
                continue
            if self.act == "tanh":
                x = x * 2.0 - 1.0
            parts.append(x.reshape(-1, 1).to(torch.float32))
        return torch.cat(parts, dim=1)

    def inverse_transform(self, data) -> np.ndarray:
        data = _host(data)
        out = np.empty((len(data), len(self.meta)), dtype=object)
        st = 0
        for i, m in enumerate(self.meta):
            if m.kind in (CONTINUOUS, ORDINAL):
                x = data[:, st].astype(np.float64)
                st += 1
                if self.act == "tanh":
                    x = (x + 1.0) / 2.0
                x = np.clip(x, 0.0, 1.0)
                if m.kind == CONTINUOUS:
                    out[:, i] = x * (m.max - m.min) + m.min
                else:
                    idx = np.round(x * m.size).clip(0, m.size - 1).astype(
                        np.int64)
                    out[:, i] = np.asarray(m.i2s, dtype=object)[idx]
            else:
                out[:, i] = _decode(data[:, st:st + m.size], m.i2s)
                st += m.size
        return out


class _Mixtures(_Encoder):
    """A mixture a continuous column: its means and stds on the device,
    the :class:`ColumnGMM` on the host."""

    def _install(self, models: list) -> None:
        self.models = models
        self.means = {i: self._tensor(g.means) for i, g in enumerate(models)
                      if g is not None}
        self.stds = {i: self._tensor(g.stds) for i, g in enumerate(models)
                     if g is not None}

    def _scalar(self, data, i, pick: np.ndarray, scale: float,
                keep=None) -> torch.Tensor:
        """``(x - mu_k) / (scale sigma_k)`` at mode ``pick`` of each row,
        clipped to +-0.99, as a float32 column."""
        means, stds = self.means[i], self.stds[i]
        if keep is not None:
            means, stds = means[keep], stds[keep]
        feats = (self._column(data, i)[:, None] - means[None, :]) / (
            scale * stds[None, :])
        rows = torch.arange(len(pick), device=self.device)
        scalar = feats[rows, self._tensor(pick, torch.int64)]
        return scalar.clamp(-0.99, 0.99).reshape(-1, 1).to(torch.float32)


class GMMTransformer(_Mixtures):
    """A plain EM Gaussian mixture (sklearn's ``GaussianMixture``) a
    continuous column: the scalar ``(x - mu_k) / (2 sigma_k)`` at the
    argmax-posterior mode, then the posterior; categorical and ordinal
    columns one-hot."""

    def __init__(self, n_clusters: int = 5, device="cuda"):
        super().__init__(device)
        self.n_clusters = n_clusters

    def fit(self, data, categorical_columns=(), ordinal_columns=(),
            seed: int = 0):
        try:
            from sklearn.mixture import GaussianMixture
        except ImportError as exc:
            raise ImportError("GMMTransformer needs sklearn, which does not "
                              "import here") from exc
        data = np.asarray(data)
        self.meta = infer_zoo_meta(data, categorical_columns, ordinal_columns)
        models, self._posterior = [], {}
        self.output_info = []
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                gm = GaussianMixture(self.n_clusters, random_state=seed)
                gm.fit(data[:, i].astype(np.float64).reshape(-1, 1))
                weights = np.asarray(gm.weights_).reshape(-1)
                models.append(ColumnGMM(
                    means=np.asarray(gm.means_).reshape(-1),
                    stds=np.sqrt(np.asarray(gm.covariances_)).reshape(-1),
                    weights=weights, active=np.ones(len(weights), bool),
                    mean_precision=None, dof=None, stick_a=None,
                    stick_b=None))
                # the posterior is sklearn's own (the JAX package keeps
                # the estimator for it too)
                self._posterior[i] = gm.predict_proba
                self.output_info += [(1, "tanh"), (self.n_clusters, "softmax")]
            else:
                models.append(None)
                self.output_info += [(m.size, "softmax")]
        self._install(models)
        self.output_dim = sum(s for s, _ in self.output_info)

    def transform(self, data) -> torch.Tensor:
        """(rows, output_dim) float32."""
        data = np.asarray(data)
        parts = []
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                probs = self._posterior[i](
                    data[:, i].astype(np.float64).reshape(-1, 1))
                parts += [self._scalar(data, i, np.argmax(probs, axis=1),
                                       2.0),
                          self._tensor(probs.astype(np.float32),
                                       torch.float32)]
            else:
                parts.append(self._onehot(_codes(data[:, i], m.i2s), m.size))
        return torch.cat(parts, dim=1)

    def inverse_transform(self, data) -> np.ndarray:
        data = _host(data)
        out = np.empty((len(data), len(self.meta)), dtype=object)
        st = 0
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                gm = self.models[i]
                u = np.clip(data[:, st], -1.0, 1.0)
                v = data[:, st + 1:st + 1 + self.n_clusters]
                st += 1 + self.n_clusters
                pick = np.argmax(v, axis=1)
                out[:, i] = u * 2.0 * gm.stds[pick] + gm.means[pick]
            else:
                out[:, i] = _decode(data[:, st:st + m.size], m.i2s)
                st += m.size
        return out


class BGMTransformer(_Mixtures):
    """A Bayesian GMM a continuous column (the host fit), the scalar
    ``(x - mu_k) / (4 sigma_k)`` at an active mode k drawn from the
    posterior plus 1e-6, and a one-hot of k; categorical and ordinal
    columns one-hot.  Each column keeps its own local mixture."""

    def __init__(self, n_clusters: int = 10, eps: float = 0.005,
                 device="cuda"):
        super().__init__(device)
        self.n_clusters = n_clusters
        self.eps = eps

    def fit(self, data, categorical_columns=(), ordinal_columns=(),
            seed: int = 0):
        data = np.asarray(data)
        self.meta = infer_zoo_meta(data, categorical_columns, ordinal_columns)
        models = []
        self.output_info = []
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                gm = fit_column_gmm(data[:, i].astype(np.float64),
                                    n_components=self.n_clusters,
                                    eps=self.eps, seed=seed)
                models.append(gm)
                self.output_info += [(1, "tanh"), (gm.n_active, "softmax")]
            else:
                models.append(None)
                self.output_info += [(m.size, "softmax")]
        self._install(models)
        self.output_dim = sum(s for s, _ in self.output_info)

    def transform(self, data, seed: int = 0) -> torch.Tensor:
        """(rows, output_dim) float32; ``seed`` seeds the mode draws."""
        data = np.asarray(data)
        rng = np.random.default_rng(seed)
        parts = []
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                gm = self.models[i]
                active = gm.active
                x = data[:, i].astype(np.float64)
                probs = gm.predict_proba(x)[:, active]
                probs = probs + 1e-6
                probs /= probs.sum(axis=1, keepdims=True)
                cum = np.cumsum(probs, axis=1)
                # the clip guards a draw past a cumulative sum 1 ulp short
                # of 1, which would pick one past the last mode
                pick = (rng.random((len(x), 1)) > cum).sum(axis=1)
                pick = pick.clip(0, int(active.sum()) - 1)
                keep = self._tensor(np.nonzero(active)[0], torch.int64)
                parts += [self._scalar(data, i, pick, 4.0, keep),
                          self._onehot(pick, int(active.sum()))]
            else:
                parts.append(self._onehot(_codes(data[:, i], m.i2s), m.size))
        return torch.cat(parts, dim=1)

    def inverse_transform(self, data) -> np.ndarray:
        data = _host(data)
        out = np.empty((len(data), len(self.meta)), dtype=object)
        st = 0
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                gm = self.models[i]
                active_idx = np.nonzero(gm.active)[0]
                n_active = len(active_idx)
                u = np.clip(data[:, st], -1.0, 1.0)
                v = data[:, st + 1:st + 1 + n_active]
                st += 1 + n_active
                pick = active_idx[np.argmax(v, axis=1)]
                out[:, i] = u * 4.0 * gm.stds[pick] + gm.means[pick]
            else:
                out[:, i] = _decode(data[:, st:st + m.size], m.i2s)
                st += m.size
        return out


class GridTransformer(_Encoder):
    """Every column min-max scaled to [-1, 1] (a categorical one as its
    ``i2s`` index), each row zero-padded into a ``(1, side, side)``
    image; the inverse rounds a categorical index."""

    def __init__(self, side: int, device="cuda"):
        super().__init__(device)
        self.side = side

    def fit(self, data, categorical_columns=(), ordinal_columns=()):
        self.meta = infer_zoo_meta(data, categorical_columns, ordinal_columns)
        lo, hi = [], []
        for m in self.meta:
            if m.kind == CONTINUOUS:
                lo.append(m.min - 1e-3)
                hi.append(m.max + 1e-3)
            else:
                lo.append(-1e-3)
                hi.append(m.size - 1 + 1e-3)
        self.lo = self._tensor(lo)
        self.hi = self._tensor(hi)

    def transform(self, data) -> torch.Tensor:
        """(rows, 1, side, side) float32."""
        data = np.asarray(data)
        cols = [self._column(data, i) if m.kind == CONTINUOUS
                else self._tensor(_codes(data[:, i], m.i2s))
                for i, m in enumerate(self.meta)]
        x = torch.stack(cols, dim=1)
        x = (x - self.lo) / (self.hi - self.lo) * 2.0 - 1.0
        pad = self.side * self.side - x.shape[1]
        if pad > 0:
            x = torch.cat([x, x.new_zeros((len(x), pad))], dim=1)
        return x.reshape(-1, 1, self.side, self.side).to(torch.float32)

    def inverse_transform(self, data) -> np.ndarray:
        data = _host(data)
        flat = data.reshape(len(data), -1)[:, :len(self.meta)]
        lo, hi = self.lo.cpu().numpy(), self.hi.cpu().numpy()
        x = (flat.astype(np.float64) + 1.0) / 2.0 * (hi - lo) + lo
        out = np.empty((len(flat), len(self.meta)), dtype=object)
        for i, m in enumerate(self.meta):
            if m.kind == CONTINUOUS:
                out[:, i] = x[:, i]
            else:
                idx = np.round(x[:, i]).clip(0, m.size - 1).astype(np.int64)
                out[:, i] = np.asarray(m.i2s, dtype=object)[idx]
        return out
