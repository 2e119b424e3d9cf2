"""Numeric matrix -> raw column values (counterpart of
``fed_tgan_tpu/data/decode.py:135-211``, without pandas).

- categorical codes -> the original category values through the encoders;
- non-negative columns: ``exp(x) - 1`` (ceil when negative), and a decoded
  ``-1`` (the missing sentinel) -> ``' '``;
- continuous missing sentinel -> ``' '``; the missing category -> ``' '``.

Date part-columns are not ported yet: a meta with ``date_info`` raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from fed_tgan_torch.data.constants import MISSING_CONTINUOUS, MISSING_TOKEN
from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import TableMeta


def decode_columns(data: np.ndarray, meta: TableMeta,
                   encoders: Sequence[CategoryEncoder]) -> dict:
    """``{column name: values}`` in meta column order; values are float64
    arrays, or object arrays where categories or blanks appear."""
    if meta.date_info:
        raise NotImplementedError("date columns are not ported yet")
    data = np.asarray(data)
    cat_names = meta.categorical_columns
    if len(cat_names) != len(encoders):
        raise ValueError(f"{len(cat_names)} categorical columns but "
                         f"{len(encoders)} encoders")
    enc_by_name = dict(zip(cat_names, encoders))
    cont_names = set(meta.continuous_columns)
    nonneg = set(meta.non_negative_columns)

    cols: dict[str, np.ndarray] = {}
    for i, name in enumerate(meta.column_names):
        x = data[:, i]
        if name in enc_by_name:
            vals = enc_by_name[name].inverse_transform(x.astype(int))
            if (vals == MISSING_TOKEN).any():
                vals = vals.copy()
                vals[vals == MISSING_TOKEN] = " "
            cols[name] = vals
            continue
        if name in nonneg:
            y = np.exp(x.astype(float)) - 1.0
            y = np.where(y < 0, np.ceil(y), y)
            missing = y == -1
        elif name in cont_names:
            y = x.astype(float)
            missing = y == MISSING_CONTINUOUS
        else:
            cols[name] = x
            continue
        if missing.any():
            y = y.astype(object)
            y[missing] = " "
        cols[name] = y
    return cols
