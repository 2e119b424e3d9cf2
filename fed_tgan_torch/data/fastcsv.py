"""CSV bytes through the compiled row formatter (``csrc/csvfmt.c``), and
the packed8 snapshot's lookup tables (counterpart of
``fed_tgan_tpu/data/fastcsv.py``, without pyarrow).

The formatter takes columns of two kinds and writes the rows with several
threads, outside the GIL (``ctypes`` releases it for the call):

- :class:`FloatCells`: float64 values, each written as Python's
  ``repr(float)``, and an optional blank mask (a blank cell writes
  ``' '``);
- :class:`TableCells`: int32 codes into a :class:`CellTable` of cell
  strings quoted once, in Python, by the ``csv`` module.

Its output is byte-equal to :func:`fed_tgan_torch.data.csvio.
plain_csv_bytes`, the stdlib writer, which the tests hold it against.

:class:`ColumnPlan` formats the columns of
:func:`fed_tgan_torch.data.decode.decode_cells` (numeric columns as floats,
categorical ones as their encoder's classes); the serving engine builds
one per model.  :class:`PackedSnapshotFormatter` turns a packed8 snapshot
into table columns alone: a continuous column's decoded value depends only
on (mode k, level u), so each of its at most ``n_modes * 255`` values is
formatted once per run, and a snapshot is index arithmetic.

The formatter is compiled with the system C compiler (``cc -O2 -shared
-fPIC -pthread``) at first use into ``fed_tgan_torch/_build/``, under a
name keyed on the source and the flags.  A failed build or load raises.
"""

from __future__ import annotations

import csv
import ctypes
import hashlib
import io
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np

from fed_tgan_torch.analysis.sanitizers import note_build
from fed_tgan_torch.runtime.cache import built_once
from fed_tgan_torch.data.csvio import _cells
from fed_tgan_torch.data.decode import (
    category_values,
    decode_cells,
    output_columns,
)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "csvfmt.c"
BUILD_DIR = _PKG / "_build"
CC_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")
MAX_THREADS = 16
ROWS_PER_THREAD = 256  # fewer rows than this share a thread
# largest level count (2 * u_scale + 1) the snapshot tables take: packed8's
# 255; packed16's 65,535 would make a table larger than the snapshot
_MAX_LEVELS = 1024
_KIND_FLOAT, _KIND_TABLE = 0, 1


# ------------------------------------------------------------ the binding

def _cc() -> str:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError(f"no C compiler (cc) found: needed to build "
                           f"{SOURCE.name}")
    return cc


@built_once()
def build() -> str:
    """Compile the formatter (once per source content and flags) and
    return the library's path."""
    note_build("library[csvfmt.c]")
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(CC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libfed_tgan_csvfmt_{tag}.so"
    if lib.exists():
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temp name, then an atomic rename: processes and threads
    # building at the same moment do not collide
    fd, tmp = tempfile.mkstemp(prefix=lib.stem + ".", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_cc(), *CC_FLAGS, "-o", tmp, str(SOURCE),
                               "-lm"], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"cc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(lib)


class _Column(ctypes.Structure):
    """``fed_tgan_csv_column`` in csvfmt.c."""

    _fields_ = [("kind", ctypes.c_int32), ("table_size", ctypes.c_int32),
                ("values", ctypes.c_void_p), ("blank", ctypes.c_void_p),
                ("codes", ctypes.c_void_p), ("table", ctypes.c_void_p),
                ("offsets", ctypes.c_void_p)]


@built_once()
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    cols = ctypes.POINTER(_Column)
    lib.fed_tgan_csv_row_bound.argtypes = [cols, ctypes.c_int32]
    lib.fed_tgan_csv_row_bound.restype = ctypes.c_int64
    lib.fed_tgan_csv_format.argtypes = [cols, ctypes.c_int32, ctypes.c_int64,
                                        ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_int32]
    lib.fed_tgan_csv_format.restype = ctypes.c_int64
    return lib


# ---------------------------------------------------------------- columns

def _quoted(cells: list, alone: bool) -> list:
    """Each cell as the ``csv`` module writes it in a row (QUOTE_MINIMAL);
    ``alone``: the row has no other field, where an empty cell is written
    ``""``."""
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    if cells and all(cells):
        # quoting only adds characters: if one row of every cell is as long
        # as the cells, commas and newline, no cell needs quoting
        writer.writerow(cells)
        if len(buf.getvalue()) == sum(map(len, cells)) + len(cells):
            return cells
    out = []
    for cell in cells:
        buf.seek(0)
        buf.truncate()
        writer.writerow([cell] if alone else [cell, ""])
        out.append(buf.getvalue()[:-1 if alone else -2])
    return out


class CellTable:
    """Cell strings of one column, quoted and packed once."""

    def __init__(self, cells: Sequence[str], alone: bool = False):
        encoded = [c.encode() for c in _quoted(list(cells), alone)]
        self.size = len(encoded)
        self.blob = np.frombuffer(b"".join(encoded) or b"\0", dtype=np.uint8)
        self.offsets = np.zeros(self.size + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=self.offsets[1:])


class FloatCells(NamedTuple):
    values: np.ndarray  # float64
    blank: Optional[np.ndarray] = None  # bool, True = write ' '


class TableCells(NamedTuple):
    codes: np.ndarray  # int32 indices into table
    table: CellTable


def default_threads(n: int) -> int:
    """``min(cpu count, 16)`` threads, one per ``ROWS_PER_THREAD`` rows."""
    return max(1, min(os.cpu_count() or 1, MAX_THREADS,
                      n // ROWS_PER_THREAD))


def header_line(names: Sequence[str]) -> bytes:
    buf = io.StringIO()
    csv.writer(buf, lineterminator="\n").writerow(list(names))
    return buf.getvalue().encode()


def format_rows(columns: Sequence, head: bytes = b"",
                threads: Optional[int] = None) -> bytes:
    """``head`` then the rows of ``columns`` (:class:`FloatCells` /
    :class:`TableCells` of one length) as CSV bytes."""
    if not columns:
        raise ValueError("no columns to format")
    # keep: the arrays the structs point into, alive until the call ends
    keep, structs = [], (_Column * len(columns))()
    n = None
    for s, col in zip(structs, columns):
        if isinstance(col, FloatCells):
            v = np.ascontiguousarray(col.values, dtype=np.float64)
            keep.append(v)
            s.kind, s.values = _KIND_FLOAT, v.ctypes.data
            if col.blank is not None:
                b = np.ascontiguousarray(col.blank, dtype=np.bool_)
                if b.shape != v.shape:
                    raise ValueError(f"blank mask {b.shape} != values "
                                     f"{v.shape}")
                keep.append(b)
                s.blank = b.ctypes.data
        else:
            v = np.ascontiguousarray(col.codes, dtype=np.int32)
            keep.append(v)
            s.kind, s.codes = _KIND_TABLE, v.ctypes.data
            s.table_size = col.table.size
            s.table = col.table.blob.ctypes.data
            s.offsets = col.table.offsets.ctypes.data
        if v.ndim != 1 or (n is not None and len(v) != n):
            raise ValueError("columns must be 1-D and of one length")
        n = len(v)
    lib = _library()
    bound = lib.fed_tgan_csv_row_bound(structs, len(columns))
    out = np.empty(len(head) + n * bound, dtype=np.uint8)
    out[:len(head)] = np.frombuffer(head, dtype=np.uint8)
    written = lib.fed_tgan_csv_format(
        structs, len(columns), n, out.ctypes.data + len(head),
        n * bound, threads or default_threads(n))
    if written == -2:
        raise ValueError("category code out of range")
    if written < 0:
        raise RuntimeError(f"csvfmt failed ({written})")
    return out[:len(head) + written].tobytes()


def to_cells(values, alone: bool = False):
    """Any column ``csvio.plain_csv_bytes`` takes -> formatter cells: float
    arrays, and object arrays of Python floats and ``' '`` blanks (what
    ``decode_columns`` gives), as :class:`FloatCells`; any other column as
    a table of its distinct cells, formatted by ``csvio._cells``."""
    values = np.asarray(values).reshape(-1)
    if values.dtype.kind == "f":
        return FloatCells(values)
    if values.dtype.kind == "O":
        items = values.tolist()
        blank = np.fromiter((type(v) is str and v == " " for v in items),
                            dtype=bool, count=len(items))
        if all(type(v) is float for v, b in zip(items, blank) if not b):
            floats = [0.0 if b else v for v, b in zip(items, blank)]
            return FloatCells(np.asarray(floats, dtype=np.float64),
                              blank if blank.any() else None)
        # objects that compare equal may print apart (0.0 and -0.0): key
        # them by their cell strings
        keys: dict = {}
        codes = [keys.setdefault(c, len(keys)) for c in _cells(values)]
        return TableCells(np.asarray(codes, dtype=np.int32),
                          CellTable(list(keys), alone))
    uniq, codes = np.unique(values, return_inverse=True)
    return TableCells(np.asarray(codes, dtype=np.int32),
                      CellTable(_cells(uniq), alone))


# ------------------------------------------------------------ table plans

def _category_table(encoder, alone: bool) -> CellTable:
    """The encoder's classes as cells, the missing token as ``' '``."""
    return CellTable(_cells(category_values(
        encoder, np.arange(len(encoder.classes_)))), alone)


class ColumnPlan:
    """How the columns of ``decode_cells(data, meta, encoders)`` are
    written: numeric ones as floats, categorical ones through a table of
    their encoder's classes (the missing token as ``' '``), a rejoined
    date column through a table of its distinct cells.  Built once per
    model; the bytes equal ``plain_csv_bytes(decode_columns(...))``."""

    def __init__(self, meta, encoders):
        self.names = output_columns(meta)
        self._alone = len(self.names) == 1
        self.dates = set(meta.date_info)
        self.tables = {
            name: _category_table(enc, self._alone)
            for name, enc in zip(meta.categorical_columns, encoders)
            if name in self.names}
        self.header = header_line(self.names)

    def _column(self, name: str, cells):
        if name in self.tables:
            return TableCells(cells.values, self.tables[name])
        if name in self.dates:
            return to_cells(cells.values, self._alone)
        return FloatCells(cells.values, cells.blank)

    def _columns(self, cells: dict) -> list:
        return [self._column(name, cells[name]) for name in self.names]

    def csv_bytes(self, cells: dict, header: bool = True) -> bytes:
        return format_rows(self._columns(cells),
                           self.header if header else b"")

    def csv_segments(self, cells: dict) -> tuple:
        """:meth:`csv_bytes` as ``(header_line, [row_line, ...])``, each
        line with its ``\\n``: joined they are the bytes of
        ``csv_bytes(cells)`` (counterpart of
        ``fed_tgan_tpu/data/csvio.py:76``).  Raises ``ValueError`` when a
        quoted cell holds a line break."""
        cols = self._columns(cells)
        blob = format_rows(cols)
        n = len(cols[0].values if isinstance(cols[0], FloatCells)
                else cols[0].codes)
        ends = np.flatnonzero(np.frombuffer(blob, dtype=np.uint8) == 10) + 1
        if len(ends) != n:
            raise ValueError(f"rows are not line-sliceable: {n} rows in "
                             f"{len(ends)} CSV lines (a line break in a "
                             "cell?)")
        starts = np.concatenate([[0], ends[:-1]]).tolist()
        return self.header, [blob[a:b] for a, b in zip(starts,
                                                       ends.tolist())]


class PackedSnapshotFormatter:
    """packed8 parts ``{u, k, disc}`` -> the snapshot's CSV bytes, equal to
    ``plain_csv_bytes(decode_columns(decode.assemble(parts), meta,
    encoders))``, with no float formatted per row."""

    def __init__(self, plan: list, levels: int, header: bytes):
        self._plan = plan  # per column: ("cont", j, table) | ("disc", j, encoder, table)
        self._levels = levels
        self._header = header

    @classmethod
    def build(cls, decode, meta, encoders
              ) -> Optional["PackedSnapshotFormatter"]:
        """None when the snapshot is not eligible: its decode is not
        quantized to at most ``_MAX_LEVELS`` levels, the meta has date
        columns, or a column other than the decode's continuous ones is
        not categorical with an encoder."""
        from fed_tgan_torch.ops.decode import U_SCALE

        if decode.mode not in U_SCALE or meta.date_info:
            return None
        scale = U_SCALE[decode.mode]
        levels = 2 * scale + 1
        names = list(meta.column_names)
        cats = dict(zip(meta.categorical_columns, encoders))
        cont = {int(i): j for j, i in enumerate(decode.cont_idx)}
        disc = {int(i): j for j, i in enumerate(decode.disc_idx)}
        if levels > _MAX_LEVELS or len(names) != decode.n_cols or any(
                (i in cont) == (name in cats) for i, name in enumerate(names)):
            return None
        # every (mode, level) as one row through the exact decode:
        # row k * levels + (u + scale)
        modes = decode.mu.shape[1]
        grid = np.arange(modes * levels)
        u = np.repeat((grid % levels - scale)[:, None], len(cont), 1)
        k = np.repeat((grid // levels)[:, None], len(cont), 1)
        parts = {"u": u.astype(np.int16), "k": k.astype(np.int16),
                 "disc": np.zeros((len(grid), len(disc)), dtype=np.int64)}
        cells = decode_cells(decode.assemble(parts), meta, encoders)
        alone = len(names) == 1
        plan = []
        for i, name in enumerate(names):
            if i in cont:
                c = cells[name]
                text = _cells(c.values)
                if c.blank is not None:
                    for r in np.flatnonzero(c.blank):
                        text[r] = " "
                plan.append(("cont", cont[i], CellTable(text, alone)))
            else:
                plan.append(("disc", disc[i], cats[name],
                              _category_table(cats[name], alone)))
        return cls(plan, levels, header_line(names))

    def csv_bytes(self, parts: dict, header: bool = True) -> bytes:
        scale = (self._levels - 1) // 2
        # (columns, rows): each column's indices contiguous
        idx = np.ascontiguousarray(
            np.asarray(parts["k"], dtype=np.int32).T * self._levels
            + np.asarray(parts["u"], dtype=np.int32).T + scale)
        disc = np.asarray(parts["disc"])
        cols = []
        for step in self._plan:
            if step[0] == "cont":
                cols.append(TableCells(idx[step[1]], step[2]))
            else:
                _, j, enc, table = step
                cols.append(TableCells(enc.validate_codes(disc[:, j]),
                                       table))
        return format_rows(cols, self._header if header else b"")
