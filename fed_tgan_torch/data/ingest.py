"""Per-client preprocessing of a raw table, without pandas
(counterpart of ``fed_tgan_tpu/data/ingest.py:29-161``).

A table is ``{column name: typed array}`` as :func:`~fed_tgan_torch.data.
csvio.read_csv` returns it (``pandas.read_csv``'s typing).  The pipeline
follows the JAX package's order and pandas' semantics cell by cell:

1. integer-column inference on the raw table (int dtype, or float whose
   non-missing values equal their int cast);
2. a cell that is exactly ``" "`` becomes missing, then every missing cell
   the ``'empty'`` token (``df.replace(r" ", nan).fillna('empty')``);
3. a continuous column with a missing cell, and every non-negative one,
   is parsed to numbers, ``log(x + 1)`` on the non-negative columns, and
   its missing cells become the sentinel -999999;
4. categorical values are compared as their pandas string form
   (``csvio.cell_strings``): ``"1"`` for an integer column, ``"1.0"`` for
   a float one;
5. a date column (``date_formats``, exempt from step 3) is replaced by
   its categorical part-columns, appended after every other column
   (:mod:`fed_tgan_torch.data.dates`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from fed_tgan_torch.data.constants import MISSING_CONTINUOUS, MISSING_TOKEN
from fed_tgan_torch.data.csvio import cell_strings, read_csv
from fed_tgan_torch.data.dates import split_date_columns
from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import TableMeta


def infer_integer_columns(table: dict) -> list[str]:
    """Columns whose non-missing values are all integral."""
    out = []
    for name, col in table.items():
        if col.dtype.kind in "iu":
            out.append(name)
        elif col.dtype.kind == "f":
            v = col[~np.isnan(col)]
            if np.array_equal(v, v.astype(int)):
                out.append(name)
    return out


def _fill_missing(col: np.ndarray) -> np.ndarray:
    """``replace(" ", nan).fillna('empty')`` of one column."""
    if col.dtype.kind == "f":
        nan = np.isnan(col)
        if not nan.any():
            return col
        out = col.astype(object)
        out[nan] = MISSING_TOKEN
        return out
    if col.dtype.kind != "O":
        return col
    out = col.copy()
    out[[v is None or v == " " for v in col.tolist()]] = MISSING_TOKEN
    return out


def _to_float(col: np.ndarray) -> np.ndarray:
    """``to_numpy(dtype=float)``: numbers as they are, numeric strings
    parsed (anything else raises, as pandas does)."""
    if col.dtype.kind != "O":
        return col.astype(np.float64)
    return np.array([np.nan if v is None else float(v) for v in col.tolist()])


@dataclass
class TablePreprocessor:
    """One participant's preprocessed table."""

    table: dict
    name: str = "table"
    categorical_columns: list = field(default_factory=list)
    non_negative_columns: list = field(default_factory=list)
    date_formats: dict = field(default_factory=dict)
    target_column: str = ""
    problem_type: str = ""
    selected_columns: Optional[Sequence[str]] = None

    def __post_init__(self):
        names = (list(self.selected_columns)
                 if self.selected_columns is not None else list(self.table))
        missing = [c for c in names if c not in self.table]
        if missing:
            raise KeyError(f"columns not in the table: {missing}")
        cols = {c: np.asarray(self.table[c]) for c in names}
        self.categorical_columns = list(self.categorical_columns)
        self.integer_columns = infer_integer_columns(cols)
        cols = {c: _fill_missing(v) for c, v in cols.items()}
        nonneg = set(self.non_negative_columns)
        exempt = set(self.categorical_columns) | set(self.date_formats)
        for c, v in cols.items():
            if c in exempt:
                continue
            missing = cell_strings(v) == MISSING_TOKEN
            if not missing.any() and c not in nonneg:
                continue
            vals = v.astype(object)
            vals[missing] = None
            vals = _to_float(vals)
            if c in nonneg:
                with np.errstate(invalid="ignore", divide="ignore"):
                    vals = np.log(vals + 1.0)
            cols[c] = np.where(np.isnan(vals), MISSING_CONTINUOUS, vals)
        if self.date_formats:
            self.date_formats = dict(self.date_formats)
            self.categorical_columns.extend(self.date_formats)
            cols = split_date_columns(cols, self.date_formats,
                                      self.categorical_columns)
        self.columns = cols

    @classmethod
    def from_csv(cls, path: str, **kwargs) -> "TablePreprocessor":
        name = os.path.basename(str(path)).rsplit(".", 1)[0]
        return cls(table=read_csv(path), name=kwargs.pop("name", name),
                   **kwargs)

    @property
    def n_rows(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def local_meta(self) -> dict:
        """Per-client meta with categorical frequency dicts (count order,
        ties in order of first appearance, as ``value_counts``)."""
        columns = []
        for idx, (col, v) in enumerate(self.columns.items()):
            entry: dict = {"column_name": col, "column no": idx}
            if col in self.categorical_columns:
                counts: dict = {}
                for s in cell_strings(v).tolist():
                    counts[s] = counts.get(s, 0) + 1
                ordered = sorted(counts.items(), key=lambda kv: -kv[1])
                entry["type"] = "categorical"
                entry["size"] = len(ordered)
                entry["i2s"] = {k: int(n) for k, n in ordered}
            else:
                entry["type"] = "continous"  # reference spelling
                vals = _to_float(v)
                present = vals[vals != MISSING_CONTINUOUS]
                if present.size == 0:
                    present = vals
                entry["min"] = float(np.min(present))
                entry["max"] = float(np.max(present))
            columns.append(entry)
        meta = {
            "columns": columns,
            "problem_type": self.problem_type,
            "name": self.name,
            "date_info": dict(self.date_formats),
            "integer_info": list(self.integer_columns),
            "non_negative_cols": list(self.non_negative_columns),
        }
        if self.target_column:
            meta["target"] = self.target_column
        return meta

    def encode(self, encoders: Sequence[CategoryEncoder]
               ) -> tuple[np.ndarray, list[int], list[int]]:
        """``(matrix, categorical_idx, ordinal_idx)``: the categorical
        columns label-encoded with the global ``encoders``, everything as
        float64."""
        out, cat_idx, cursor = [], [], 0
        for idx, (col, v) in enumerate(self.columns.items()):
            if col in self.categorical_columns:
                out.append(encoders[cursor].transform(cell_strings(v))
                           .astype(np.float64))
                cursor += 1
                cat_idx.append(idx)
            else:
                out.append(_to_float(v))
        return np.stack(out, axis=1), cat_idx, []

    def global_table_meta(self, harmonized_meta: dict) -> TableMeta:
        return TableMeta.from_json_dict(harmonized_meta)
