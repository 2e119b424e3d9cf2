"""CSV bytes from decoded columns, with the stdlib ``csv`` module.

Floats are written as Python's shortest round-trip ``repr``, categories as
their string form, blanks as ``' '``; ``\\n`` ends every line.  Parsed back,
the cells equal the JAX package's CSV output for the same matrix
(``fed_tgan_tpu/data/csvio.py:95``), which goes through pandas or pyarrow.
"""

from __future__ import annotations

import csv
import io

import numpy as np


def _cells(values: np.ndarray) -> list[str]:
    if values.dtype.kind == "f":
        return [repr(v) for v in values.astype(np.float64).tolist()]
    return [repr(v) if isinstance(v, float) else str(v)
            for v in values.tolist()]


def csv_bytes(columns: dict, header: bool = True) -> bytes:
    """``{name: values}`` (equal lengths) -> CSV bytes."""
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    if header:
        writer.writerow(list(columns))
    writer.writerows(zip(*(_cells(np.asarray(v)) for v in columns.values())))
    return buf.getvalue().encode()
