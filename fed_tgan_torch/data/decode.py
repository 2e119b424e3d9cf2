"""Numeric matrix -> raw column values (counterpart of
``fed_tgan_tpu/data/decode.py:135-211``, without pandas).

- categorical codes -> the original category values through the encoders;
- non-negative columns: ``exp(x) - 1`` (ceil when negative), and a decoded
  ``-1`` (the missing sentinel) -> ``' '``;
- continuous missing sentinel -> ``' '``; the missing category -> ``' '``.

:func:`decode_cells` gives the same columns without object arrays (float64
values and blank masks, category codes), which the compiled CSV formatter
(:mod:`fed_tgan_torch.data.fastcsv`) takes directly; :func:`decode_columns`
gives the values themselves, for evaluation.

Date columns (``meta.date_info``) are rejoined from their part-columns
(``fed_tgan_tpu/data/decode.py:157-202``): the parts keep the missing
token until the join, a date with a missing part becomes ``' '``, and
each date column comes after every other column
(:func:`output_columns`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from fed_tgan_torch.data.constants import MISSING_CONTINUOUS, MISSING_TOKEN
from fed_tgan_torch.data.dates import join_date_columns, part_columns
from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import TableMeta


class Cells(NamedTuple):
    """One decoded column.  Categorical (``encoder`` set): ``values`` are
    int64 codes.  Otherwise ``values`` are numbers (float64 for continuous
    and non-negative columns) and ``blank`` marks the cells written blank
    (None when there are none); a rejoined date column's ``values`` are
    objects (``datetime``, int, or ``' '``)."""

    values: np.ndarray
    blank: Optional[np.ndarray] = None
    encoder: Optional[CategoryEncoder] = None


def date_parts(meta: TableMeta) -> set:
    """The names of the meta's date part-columns."""
    return {p for column, fmt in meta.date_info.items()
            for p in part_columns(column, fmt)}


def output_columns(meta: TableMeta) -> list:
    """The decoded table's column names: the meta's columns but the date
    parts, then each date column (the join appends it)."""
    parts = date_parts(meta)
    return ([c for c in meta.column_names if c not in parts]
            + [c for c in meta.date_info if c not in meta.column_names])


def decode_cells(data: np.ndarray, meta: TableMeta,
                 encoders: Sequence[CategoryEncoder]) -> dict:
    """``{column name: Cells}`` in :func:`output_columns` order."""
    data = np.asarray(data)
    cat_names = meta.categorical_columns
    if len(cat_names) != len(encoders):
        raise ValueError(f"{len(cat_names)} categorical columns but "
                         f"{len(encoders)} encoders")
    enc_by_name = dict(zip(cat_names, encoders))
    cont_names = set(meta.continuous_columns)
    nonneg = set(meta.non_negative_columns)

    cols: dict[str, Cells] = {}
    for i, name in enumerate(meta.column_names):
        x = data[:, i]
        if name in enc_by_name:
            enc = enc_by_name[name]
            cols[name] = Cells(enc.validate_codes(x.astype(int)), encoder=enc)
            continue
        if name in nonneg:
            y = np.exp(x.astype(float)) - 1.0
            y = np.where(y < 0, np.ceil(y), y)
            missing = y == -1
        elif name in cont_names:
            y = x.astype(float)
            missing = y == MISSING_CONTINUOUS
        else:
            cols[name] = Cells(x)
            continue
        cols[name] = Cells(y, missing if missing.any() else None)
    if meta.date_info:
        parts = date_parts(meta)
        pieces = {}
        for p in [n for n in meta.column_names if n in parts]:
            c = cols.pop(p)  # category strings, the missing token kept
            pieces[p] = c.encoder.inverse_transform(c.values)
        joined = join_date_columns(pieces, meta.date_info)
        for name, vals in joined.items():
            vals[np.asarray([v == MISSING_TOKEN for v in vals.tolist()],
                            dtype=bool)] = " "
            cols[name] = Cells(vals)
    return cols


def category_values(encoder: CategoryEncoder, codes) -> np.ndarray:
    """The categories of ``codes``, the missing token as ``' '``."""
    vals = encoder.inverse_transform(codes)
    if (vals == MISSING_TOKEN).any():
        vals = vals.copy()
        vals[vals == MISSING_TOKEN] = " "
    return vals


def decode_columns(data: np.ndarray, meta: TableMeta,
                   encoders: Sequence[CategoryEncoder]) -> dict:
    """``{column name: values}`` in meta column order; values are float64
    arrays, or object arrays where categories or blanks appear."""
    cols = {}
    for name, c in decode_cells(data, meta, encoders).items():
        if c.encoder is not None:
            cols[name] = category_values(c.encoder, c.values)
        elif c.blank is None:
            cols[name] = c.values
        else:
            y = c.values.astype(object)
            y[c.blank] = " "
            cols[name] = y
    return cols
