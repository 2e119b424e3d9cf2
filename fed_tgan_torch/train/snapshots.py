"""Per-round snapshot CSVs written off the training thread
(counterpart of ``fed_tgan_tpu/train/snapshots.py:136-312``).

The reference server samples 40,000 rows and writes their CSV inside every
round.  Here the device work of a snapshot (generator, K1, the packed
decode and the copy to the host) runs on the calling thread, and the host
work (assembling the values, decoding categories, formatting and writing
the CSV) goes to one background thread, so it overlaps the next round.
At most :data:`MAX_PENDING` snapshots are in flight: a new one waits for
the oldest.  A worker's error is re-raised at the next submit, at ``drain`` or
when the ``with`` block exits.

The writer thread holds the GIL while it formats, so it can slow the next
round's dispatch; ``chip_smoke.py`` measures by how much.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from typing import Callable

from fed_tgan_torch.data.csvio import write_csv
from fed_tgan_torch.data.decode import decode_columns

MAX_PENDING = 2  # snapshots in flight (each holds its parts on the host)


class SnapshotWriter:
    """``sample_hook``-compatible: ``writer(epoch, trainer)`` samples
    ``rows`` rows of stream ``seed + epoch`` from ``trainer`` and writes
    them to ``path_fn(epoch)``.  ``drain()`` waits for every write and
    returns the last snapshot's decoded columns."""

    def __init__(self, meta, encoders, path_fn: Callable[[int], str],
                 rows: int = 40000, seed: int = 0):
        self.meta = meta
        self.encoders = encoders
        self.path_fn = path_fn
        self.rows = rows
        self.seed = seed
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: list[cf.Future] = []
        self._last = None
        self.write_s: list[float] = []  # worker seconds per snapshot

    def _settle_oldest(self) -> None:
        self._last = self._pending.pop(0).result()

    def __call__(self, epoch: int, trainer) -> None:
        while len(self._pending) >= MAX_PENDING:
            self._settle_oldest()
        parts = trainer.sample_parts(self.rows, seed=self.seed + epoch)
        self._pending.append(self._pool.submit(
            self._write, self.path_fn(epoch), parts, trainer.decode))

    def _write(self, path: str, parts: dict, decode):
        t0 = time.perf_counter()
        cols = decode_columns(decode.assemble(parts), self.meta,
                              self.encoders)
        write_csv(cols, path)
        self.write_s.append(time.perf_counter() - t0)
        return cols

    def drain(self):
        """Wait for every pending write (even past a failure); re-raise
        the first worker error; return the last snapshot's columns."""
        err = None
        while self._pending:
            try:
                self._settle_oldest()
            except Exception as exc:  # noqa: BLE001 -- re-raised below
                err = err or exc
        if err is not None:
            raise err
        return self._last

    def close(self) -> None:
        try:
            self.drain()
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
