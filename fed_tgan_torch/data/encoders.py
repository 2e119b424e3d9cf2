"""Categorical label encoding (copy of ``fed_tgan_tpu/data/encoders.py``).

sklearn-``LabelEncoder``-compatible: classes are the sorted unique values,
codes are positions in that order.  The port persists encoders as JSON
(``to_dict``/``from_dict``), never as pickles.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CategoryEncoder:
    """Maps category values <-> integer codes."""

    classes_: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=object))

    @classmethod
    def fit(cls, values) -> "CategoryEncoder":
        return cls(classes_=np.unique(np.asarray(list(values), dtype=object)))

    def transform(self, values) -> np.ndarray:
        arr = np.asarray(list(values), dtype=object)
        codes = np.clip(np.searchsorted(self.classes_, arr), 0,
                        len(self.classes_) - 1)
        if not np.array_equal(self.classes_[codes], arr):
            known = set(self.classes_.tolist())
            unknown = sorted({v for v in arr.tolist() if v not in known})
            raise ValueError(f"unknown categories: {unknown[:10]}")
        return codes.astype(np.int64)

    def validate_codes(self, codes) -> np.ndarray:
        """Range-checked int64 codes (checked before any narrowing cast)."""
        codes = np.asarray(codes, dtype=np.int64)
        if codes.size and (codes.min() < 0 or codes.max() >= len(self.classes_)):
            raise ValueError("category code out of range")
        return codes

    def inverse_transform(self, codes) -> np.ndarray:
        return self.classes_[self.validate_codes(codes)]

    def to_dict(self) -> dict:
        return {"classes": self.classes_.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "CategoryEncoder":
        return cls(classes_=np.asarray(d["classes"], dtype=object))
