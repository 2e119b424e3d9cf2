"""Decode side of the CTGAN mode-specific normalization.

Counterpart of ``fed_tgan_tpu/features/transformer.py:34-51``.  Serving
needs only what maps a generated row back to column values, so a
continuous column keeps the means and stds of its *active* mixture modes
(in active order) and a discrete column its slot -> code table.  Fitting
the mixtures is training-side work and is not part of this package yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

SCALE = 4.0  # the reference's (x - mu) / (4 sigma)


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
