"""The CTGAN mode-specific normalization
(counterpart of ``fed_tgan_tpu/features/transformer.py:34-228``).

- A continuous column becomes the scalar ``(x - mu_k) / (4 sigma_k)`` for
  an active mixture mode k drawn from its posterior (clipped to +-0.99, a
  ``tanh`` segment) plus a one-hot over the active modes (a ``softmax``
  segment).
- A categorical or ordinal column becomes a one-hot over its categories in
  frequency order.

The decode side keeps only what maps a generated row back to values: a
continuous column the means and stds of its *active* modes (in active
order), a discrete column its slot -> code table.  :class:`ModeNormalizer`
fits the mixtures (:mod:`fed_tgan_torch.features.bgm`) and produces those
decode columns, so the saved artifact and the serving path read a trained
model exactly as they read a converted one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from fed_tgan_torch.features.bgm import N_CLUSTERS, WEIGHT_EPS, fit_columns

SCALE = 4.0  # the reference's (x - mu) / (4 sigma)
CLIP = 0.99


@dataclass
class ContinuousColumn:
    name: str
    means: np.ndarray  # (n_active,) float64, one per active mode
    stds: np.ndarray   # (n_active,) float64

    @property
    def n_active(self) -> int:
        return len(self.means)


@dataclass
class DiscreteColumn:
    name: str
    codes: np.ndarray  # slot -> integer code, in frequency order

    @property
    def size(self) -> int:
        return len(self.codes)


def output_info(columns: Sequence) -> list[tuple[int, str]]:
    """The encoded layout: a continuous column is a 1-wide ``tanh`` segment
    (the scalar) then an ``n_active``-wide ``softmax`` segment (its mode);
    a discrete column is one ``softmax`` segment over its slots."""
    info: list[tuple[int, str]] = []
    for col in columns:
        if isinstance(col, ContinuousColumn):
            info += [(1, "tanh"), (col.n_active, "softmax")]
        else:
            info.append((col.size, "softmax"))
    return info


class ModeNormalizer:
    """fit / transform / inverse_transform for one table.  The mixtures
    are fitted on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, n_components: int = N_CLUSTERS, eps: float = WEIGHT_EPS,
                 device="cuda"):
        self.n_components = n_components
        self.eps = eps
        self.device = device
        self.columns: list = []  # decode columns
        self.gmms: list = []     # ColumnGMM per continuous column, else None
        self.output_info: list[tuple[int, str]] = []
        self.output_dim = 0

    def fit(self, data: np.ndarray, categorical_idx: Sequence[int] = (),
            ordinal_idx: Sequence[int] = (),
            column_names: Optional[Sequence[str]] = None,
            column_gmms: Optional[dict] = None) -> "ModeNormalizer":
        """Fit per-column models on a (rows, cols) numeric matrix.
        Discrete slot order is frequency order (ties by code); every
        continuous column's mixture is fitted in one batch unless
        ``column_gmms`` (column index -> ColumnGMM) supplies it."""
        data = np.asarray(data, dtype=np.float64)
        discrete = set(categorical_idx) | set(ordinal_idx)
        cont_idx = [j for j in range(data.shape[1]) if j not in discrete]
        if column_gmms is not None:
            missing = [j for j in cont_idx if j not in column_gmms]
            if missing:
                raise ValueError(f"column_gmms missing continuous columns "
                                 f"{missing}")
            gmms = {j: column_gmms[j] for j in cont_idx}
        elif cont_idx:
            gmms = dict(zip(cont_idx, fit_columns(
                [data[:, j] for j in cont_idx], self.n_components, self.eps,
                device=self.device)))
        else:
            gmms = {}
        self.columns, self.gmms = [], []
        for j in range(data.shape[1]):
            name = column_names[j] if column_names is not None else str(j)
            gmm = gmms.get(j)
            self.gmms.append(gmm)
            if gmm is None:
                values, counts = np.unique(data[:, j].astype(np.int64),
                                           return_counts=True)
                order = np.argsort(-counts, kind="stable")
                self.columns.append(DiscreteColumn(name, values[order]))
            else:
                self.columns.append(ContinuousColumn(
                    name, gmm.means[gmm.active], gmm.stds[gmm.active]))
        self.output_info = output_info(self.columns)
        self.output_dim = sum(size for size, _ in self.output_info)
        return self

    def transform(self, data: np.ndarray,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """The encoded (rows, output_dim) float32 matrix.  Each continuous
        column draws one uniform per row from ``rng`` (in column order) and
        picks its mode by inverse CDF over the posterior plus 1e-6."""
        data = np.asarray(data, dtype=np.float64)
        rng = rng or np.random.default_rng()
        n = len(data)
        rows = np.arange(n)
        parts: list[np.ndarray] = []
        for j, (col, gmm) in enumerate(zip(self.columns, self.gmms)):
            x = data[:, j]
            if gmm is not None:
                z = (x[:, None] - gmm.means[None, :]) / (SCALE * gmm.stds[None, :])
                z = z[:, gmm.active]
                pp = gmm.predict_proba(x)[:, gmm.active] + 1e-6
                pp = pp / pp.sum(axis=1, keepdims=True)
                r = rng.random((n, 1))
                sel = (np.cumsum(pp, axis=1) > r).argmax(axis=1)
                onehot = np.zeros((n, gmm.n_active))
                onehot[rows, sel] = 1.0
                parts += [np.clip(z[rows, sel], -CLIP, CLIP)[:, None], onehot]
                continue
            codes = x.astype(np.int64)
            if codes.size and (codes.min() < 0
                               or codes.max() > col.codes.max()):
                raise ValueError(f"column {col.name!r}: category code out "
                                 "of fitted range")
            lookup = np.full(int(col.codes.max()) + 1, -1, dtype=np.int64)
            lookup[col.codes] = np.arange(col.size)
            slots = lookup[codes]
            if (slots < 0).any():
                raise ValueError(
                    f"column {col.name!r}: unseen category codes "
                    f"{sorted(set(codes[slots < 0].tolist()))[:10]}")
            onehot = np.zeros((n, col.size))
            onehot[rows, slots] = 1.0
            parts.append(onehot)
        return np.concatenate(parts, axis=1).astype(np.float32)

    def inverse_transform(self, data: np.ndarray) -> np.ndarray:
        """An encoded or generated matrix back to numeric column values:
        ``u * 4 sigma_k + mu_k`` for the argmax active mode k, the code of
        the argmax slot."""
        data = np.asarray(data, dtype=np.float64)
        out = np.zeros((len(data), len(self.columns)))
        st = 0
        for j, col in enumerate(self.columns):
            if isinstance(col, ContinuousColumn):
                u = np.clip(data[:, st], -1.0, 1.0)
                k = np.argmax(data[:, st + 1:st + 1 + col.n_active], axis=1)
                out[:, j] = u * SCALE * col.stds[k] + col.means[k]
                st += 1 + col.n_active
            else:
                out[:, j] = col.codes[np.argmax(data[:, st:st + col.size],
                                                axis=1)]
                st += col.size
        return out
