"""Per-round snapshot CSVs written off the training thread
(counterpart of ``fed_tgan_tpu/train/snapshots.py:136-312``).

The reference server samples 40,000 rows and writes their CSV inside every
round.  Here the training thread only dispatches a snapshot: the generator,
K1 and the snapshot decode on the device, then copies of the decoded parts
into pinned host buffers with ``non_blocking=True`` on the current stream
(whose order keeps the source tensors alive until the copies are done),
and a CUDA event after them.  One background thread waits on the event
and does the host work, so it overlaps the next round:

- a packed8 snapshot goes through the lookup tables of
  :class:`fed_tgan_torch.data.fastcsv.PackedSnapshotFormatter` (built once
  by the writer thread), so no float is formatted per row;
- any other snapshot is assembled, decoded (``decode_cells``) and written
  through the compiled formatter's float columns.

Either way the file is byte-equal to the stdlib writer's
(``plain_csv_bytes(decode_columns(decode.assemble(parts), ...))``), and
the compiled formatter runs without the GIL.  On CPU tensors the same code
runs with a plain copy and no event.  A bf16 trainer's snapshot samples
in bf16 (the generator and K1 in the model's compute dtype) and its rows
are float32 before the decode, as ``make_sample_many`` decodes in f32.

``fmt="feather"`` or ``"parquet"`` (``--snapshot-format``,
``fed_tgan_tpu/train/snapshots.py:99-135``) writes the snapshot as an Arrow
table instead, at ``<name>.feather`` or ``<name>.parquet``
(:func:`columnar_table`, :func:`write_columnar`); pyarrow is imported
only then.

At most :data:`MAX_PENDING` snapshots are in flight, each with its own set
of host buffers, reused by later snapshots: a new one waits for the oldest.
A worker's error is re-raised at the next submit, at ``drain`` or when the
``with`` block exits.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from typing import Callable

import numpy as np
import torch

from fed_tgan_torch.analysis.sanitizers import sanctioned_sync
from fed_tgan_torch.data.constants import MISSING_TOKEN
from fed_tgan_torch.data.decode import (
    category_values,
    decode_cells,
    decode_columns,
)
from fed_tgan_torch.data.fastcsv import ColumnPlan, PackedSnapshotFormatter
from fed_tgan_torch.obs.trace import span as _span

MAX_PENDING = 2  # snapshots in flight, each with its own host buffers
FORMATS = ("csv", "feather", "parquet")


def _pyarrow():
    try:
        import pyarrow
    except ImportError as exc:
        raise ImportError("--snapshot-format feather|parquet needs pyarrow, "
                          "which does not import here") from exc
    return pyarrow


def columnar_table(data: np.ndarray, meta, encoders):
    """A decoded snapshot as the ``pyarrow.Table`` the JAX package writes
    (``_write_columnar``), column for column and type for type:

    - with no date column and no missing value, a categorical column is
      a dictionary array (int32 codes into every category of its
      encoder, the missing token spelled ``' '``) and any other column
      the decoded numbers;
    - otherwise (the JAX package's pandas path) a categorical column is
      ``large_string``, a date column holds its datetimes (or ``yymmdd``
      ints), and every cell the CSV spells ``' '`` is a null."""
    pa = _pyarrow()
    cells = decode_cells(data, meta, encoders)
    typed = not meta.date_info and all(
        c.encoder is not None or c.blank is None for c in cells.values())
    arrays = {}
    for name, c in cells.items():
        if c.encoder is not None:
            if typed:
                dictionary = [" " if v == MISSING_TOKEN else str(v)
                              for v in c.encoder.classes_.tolist()]
                arrays[name] = pa.DictionaryArray.from_arrays(
                    pa.array(c.values.astype(np.int32)),
                    pa.array(dictionary, type=pa.string()))
                continue
            vals = category_values(c.encoder, c.values).tolist()
            arrays[name] = pa.array([None if v == " " else v for v in vals],
                                    type=pa.large_string())
        elif c.values.dtype.kind == "O":  # a rejoined date column
            arrays[name] = pa.array([None if isinstance(v, str) and v == " "
                                     else v for v in c.values.tolist()])
        else:
            arrays[name] = pa.array(c.values, mask=c.blank)
    return pa.table(arrays)


def write_columnar(data: np.ndarray, meta, encoders, path: str,
                   fmt: str) -> None:
    """:func:`columnar_table` of ``data`` to ``path``: ``"feather"`` as
    the Arrow IPC file format (feather V2), ``"parquet"`` with
    ``pyarrow.parquet.write_table``."""
    pa = _pyarrow()
    table = columnar_table(data, meta, encoders)
    if fmt == "feather":
        with pa.OSFile(path, "wb") as sink, \
                pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
    elif fmt == "parquet":
        import pyarrow.parquet as pq

        pq.write_table(table, path)
    else:
        raise ValueError(f"columnar snapshot format {fmt!r}: expected "
                         "feather or parquet")


def snapshot_file(path: str, fmt: str) -> str:
    """``path`` (a ``.csv`` name) with the format's extension."""
    return path if fmt == "csv" else os.path.splitext(path)[0] + "." + fmt


class SnapshotWriter:
    """``sample_hook``-compatible: ``writer(epoch, trainer)`` samples
    ``rows`` rows of stream ``seed + epoch`` from ``trainer`` and writes
    them to ``path_fn(epoch)`` (its extension swapped for a columnar
    ``fmt``).  ``drain()`` waits for every write and returns the last
    snapshot's decoded columns, missing cells spelled ``' '`` whatever
    the format."""

    def __init__(self, meta, encoders, path_fn: Callable[[int], str],
                 rows: int = 40000, seed: int = 0, fmt: str = "csv"):
        if fmt not in FORMATS:
            raise ValueError(f"snapshot format {fmt!r}: expected csv, "
                             "feather or parquet")
        if fmt != "csv":
            _pyarrow()  # fail before the first round, not on the writer
        self.fmt = fmt
        self.meta = meta
        self.encoders = encoders
        self.path_fn = path_fn
        self.rows = rows
        self.seed = seed
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: list[tuple[cf.Future, dict]] = []  # (write, buffers)
        self._free: list[dict] = []  # host buffer sets no write is using
        self._last = None  # (parts, decode) of the last finished write
        # the writer thread's formatters: (decode, packed formatter or
        # None) and the exact path's plan, each built at first use
        self._packed = None
        self._plan = None
        self.write_s: list[float] = []  # worker seconds per snapshot

    def _settle_oldest(self) -> None:
        future, buffers = self._pending.pop(0)
        try:
            self._last = future.result()
        finally:
            self._free.append(buffers)

    def _buffers(self, parts: dict) -> dict:
        """A free host buffer set shaped like ``parts`` (pinned for
        device tensors), or a new one."""
        def fits(bufs):
            return bufs.keys() == parts.keys() and all(
                bufs[k].shape == v.shape and bufs[k].dtype == v.dtype
                for k, v in parts.items())

        while self._free:
            bufs = self._free.pop()
            if fits(bufs):
                return bufs
        return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
                for k, v in parts.items()}

    def __call__(self, epoch: int, trainer) -> None:
        while len(self._pending) >= MAX_PENDING:
            self._settle_oldest()
        with _span("train.snapshot.predispatch", round=epoch):
            parts = trainer.sample_parts(self.rows, seed=self.seed + epoch,
                                         to_host=False)
            buffers = self._buffers(parts)
            event = None
            for k, v in parts.items():
                buffers[k].copy_(v, non_blocking=True)
                if v.is_cuda and event is None:
                    event = torch.cuda.Event()
            if event is not None:
                event.record(torch.cuda.current_stream(next(
                    v.device for v in parts.values() if v.is_cuda)))
        self._pending.append((self._pool.submit(
            self._write, self.path_fn(epoch), buffers, event,
            trainer.decode), buffers))

    def write_parts(self, epoch: int, parts: dict, decode) -> None:
        """Write host ``parts`` (numpy arrays of ``decode``'s layout) to
        ``path_fn(epoch)`` on the writer thread: a multi-process world's
        rank 0, which receives them from rank 1."""
        while len(self._pending) >= MAX_PENDING:
            self._settle_oldest()
        buffers = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in parts.items()}
        self._pending.append((self._pool.submit(
            self._write, self.path_fn(epoch), buffers, None, decode), {}))

    def _formatter(self, decode):
        if self._packed is None or self._packed[0] is not decode:
            self._packed = (decode, PackedSnapshotFormatter.build(
                decode, self.meta, self.encoders))
        return self._packed[1]

    def _write(self, path: str, buffers: dict, event, decode):
        if event is not None:
            with sanctioned_sync():  # the pinned copies' one wait
                event.synchronize()
        t0 = time.perf_counter()
        # the writer thread's decode, CSV bytes and file write: one range
        # on the profiler's timeline
        with _span("train.snapshot.write"):
            parts = {k: v.numpy() for k, v in buffers.items()}
            if self.fmt != "csv":
                write_columnar(decode.assemble(parts), self.meta,
                               self.encoders, snapshot_file(path, self.fmt),
                               self.fmt)
                self.write_s.append(time.perf_counter() - t0)
                return {k: v.copy() for k, v in parts.items()}, decode
            packed = self._formatter(decode)
            if packed is not None:
                blob = packed.csv_bytes(parts)
            else:
                if self._plan is None:
                    self._plan = ColumnPlan(self.meta, self.encoders)
                blob = self._plan.csv_bytes(decode_cells(
                    decode.assemble(parts), self.meta, self.encoders))
            with open(path, "wb") as f:
                f.write(blob)
        self.write_s.append(time.perf_counter() - t0)
        # the buffers go back to the pool: keep a copy for drain()
        return {k: v.copy() for k, v in parts.items()}, decode

    def _settle_all(self) -> None:
        """Wait for every pending write (even past a failure); re-raise
        the first worker error."""
        err = None
        while self._pending:
            try:
                self._settle_oldest()
            except Exception as exc:  # noqa: BLE001 -- re-raised below
                err = err or exc
        if err is not None:
            raise err

    def drain(self):
        """Wait for every pending write; re-raise the first worker error;
        return the last snapshot's columns (``decode_columns`` of its
        parts, densified here, once per call)."""
        self._settle_all()
        if self._last is None:
            return None
        parts, decode = self._last
        return decode_columns(decode.assemble(parts), self.meta,
                              self.encoders)

    def close(self) -> None:
        try:
            self._settle_all()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
            return
        try:  # unwinding from an error in the body: do not mask it
            self.close()
        except Exception as err:  # noqa: BLE001
            print(f"WARNING: snapshot writer failed during unwind: {err!r}")


def result_path_fn(out_dir: str, name: str) -> Callable[[int], str]:
    """``<out>/<name>_result/<name>_synthesis_epoch_<e>.csv``, the
    reference server's snapshot layout."""
    result_dir = os.path.join(out_dir, f"{name}_result")
    os.makedirs(result_dir, exist_ok=True)
    return lambda e: os.path.join(result_dir, f"{name}_synthesis_epoch_{e}.csv")
