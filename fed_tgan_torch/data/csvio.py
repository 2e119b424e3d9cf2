"""CSV in and out.

Writing: floats as Python's shortest round-trip ``repr``, categories as
their string form, blanks as ``' '``; ``\\n`` ends every line.  Parsed back,
the cells equal the JAX package's CSV output for the same matrix
(``fed_tgan_tpu/data/csvio.py:95``), which goes through pandas or pyarrow.
:func:`csv_bytes` and :func:`write_csv` write through the compiled
formatter (:mod:`fed_tgan_torch.data.fastcsv`); :func:`plain_csv_bytes`,
the stdlib ``csv`` writer, is its plain version, which the tests hold it
against byte for byte.

Reading (:func:`read_csv`) types each column as ``pandas.read_csv`` does
with its defaults, which is what the JAX package's ingest and similarity
code see:

- a cell in :data:`NA_VALUES` (the empty cell among them) is missing;
- a column whose other cells all parse as integers is ``int64``, or
  ``float64`` when a cell is missing; one whose other cells all parse as
  numbers is ``float64`` (missing -> NaN); one of ``True``/``False`` cells
  only is ``bool``; any other column holds strings (missing -> None), and
  a column with no value at all is ``float64`` NaN.

:func:`cell_strings` is ``Series.astype(str)`` of such a column.
"""

from __future__ import annotations

import csv
import io
import re

import numpy as np

# pandas' default na_values
NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")
_BOOL = {"True": True, "TRUE": True, "true": True,
         "False": False, "FALSE": False, "false": False}


def _cells(values: np.ndarray) -> list[str]:
    if values.dtype.kind == "f":
        return [repr(v) for v in values.astype(np.float64).tolist()]
    return [repr(v) if isinstance(v, float) else str(v)
            for v in values.tolist()]


def plain_csv_bytes(columns: dict, header: bool = True) -> bytes:
    """``{name: values}`` (equal lengths) -> CSV bytes, with the stdlib
    ``csv`` writer."""
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    if header:
        writer.writerow(list(columns))
    writer.writerows(zip(*(_cells(np.asarray(v)) for v in columns.values())))
    return buf.getvalue().encode()


def csv_bytes(columns: dict, header: bool = True) -> bytes:
    """``{name: values}`` (equal lengths) -> CSV bytes, through the compiled
    formatter; byte-equal to :func:`plain_csv_bytes`."""
    # imported here: fastcsv imports this module's _cells
    from fed_tgan_torch.data.fastcsv import format_rows, header_line, to_cells

    alone = len(columns) == 1
    return format_rows([to_cells(v, alone) for v in columns.values()],
                       header_line(list(columns)) if header else b"")


def write_csv(columns: dict, path: str) -> None:
    """``{name: values}`` -> a CSV file at ``path``."""
    with open(path, "wb") as f:
        f.write(csv_bytes(columns))


def _typed(cells: list) -> np.ndarray:
    """One column's cells -> a typed array (see the module docstring)."""
    present = [c for c in cells if c not in NA_VALUES]
    n_missing = len(cells) - len(present)
    if not present:
        return np.full(len(cells), np.nan)
    if all(_INT.fullmatch(c) for c in present):
        if not n_missing:
            return np.array([int(c) for c in cells], dtype=np.int64)
        return np.array([np.nan if c in NA_VALUES else float(int(c))
                         for c in cells])
    if all(_FLOAT.fullmatch(c) for c in present):
        return np.array([np.nan if c in NA_VALUES else float(c)
                         for c in cells])
    if not n_missing and all(c in _BOOL for c in present):
        return np.array([_BOOL[c] for c in cells], dtype=bool)
    return np.array([None if c in NA_VALUES else c for c in cells],
                    dtype=object)


def read_csv(path: str) -> dict:
    """A CSV file with a header line -> ``{name: typed column}`` in file
    order.  Blank lines are skipped."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) != len(header):
            raise ValueError(f"{path}: line {i + 2} has {len(r)} fields, "
                             f"the header {len(header)}")
    cols = list(zip(*body)) if body else [()] * len(header)
    return {name: _typed(list(c)) for name, c in zip(header, cols)}


def cell_strings(values: np.ndarray) -> np.ndarray:
    """``pandas.Series.astype(str)`` of a :func:`read_csv` column, as an
    object array: integers as ``"1"``, floats as ``"1.0"``, booleans as
    ``"True"``; a missing cell (NaN or None) stays None."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        out = [None if v != v else str(v) for v in values.tolist()]
    else:
        out = [None if v is None or (isinstance(v, float) and v != v)
               else str(v) for v in values.tolist()]
    return np.array(out, dtype=object)
