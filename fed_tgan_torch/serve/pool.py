"""Pre-generated row pools: a request whose rows are cached skips the
queue and the device (counterpart of ``fed_tgan_tpu/serve/pool.py``).

Clients walk the deterministic ``(seed, offset)`` row stream in small
contiguous requests, and the rows they want are a pure function of
``(model, seed, absolute row index, condition)``.  A background filler
samples CHUNKS of a hot stream (``chunk_rows`` at a time) and stores the
per-row CSV segments
(:meth:`~.engine.SamplingEngine.sample_csv_segments`).  A request whose
row span is covered is stitched from cached segments: its bytes equal a
cold dispatch's by the engine's determinism contract.

Keys are ``(tenant, seed, condition)``; a key becomes hot after
``hot_after`` requests asked for it.  Per key the pool keeps a sliding
window of at most ``max_chunks_per_key`` chunks, extended
``lookahead_chunks`` ahead of the demand.

Consistency: each chunk carries the ``model_id`` of the snapshot that made
it, an insert for another model drops the entry's older chunks, and the
fleet invalidates a tenant's entries whenever a hot reload adopts a new
model, so a hit never mixes models.  The fleet charges the quota token
before the pool lookup.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from fed_tgan_torch.analysis import lockwatch

__all__ = ["RowPool"]


class _PoolEntry:
    """One hot ``(tenant, seed, condition)`` stream: a sliding window of
    row-segment chunks plus the demand counters the filler reads."""

    __slots__ = ("model_id", "header", "chunks", "demand", "want_lo",
                 "want_hi", "unpoolable")

    def __init__(self):
        self.model_id: Optional[str] = None
        self.header: bytes = b""
        self.chunks: dict = {}      # chunk index -> [row_bytes] * chunk_rows
        self.demand = 0             # requests that asked for this key
        self.want_lo = 0            # lowest / highest chunk index recently
        self.want_hi = 0            # demanded (the filler's target window)
        self.unpoolable = False     # frame not row-sliceable: never pool


class RowPool:
    """Bounded pool of pre-serialized row chunks with a background filler.

    ``get`` is the request-path fast lookup (returns the response as a
    list of byte segments, or None on miss); ``fill_once`` runs one
    filler cycle synchronously (the deterministic seam the tests use);
    ``start``/``stop`` run ``fill_once`` on a daemon thread.
    All shared state is guarded by ``self._lock``; engine sampling always
    happens outside it.
    """

    def __init__(self, fleet, chunk_rows: int = 2048,
                 max_chunks_per_key: int = 8, max_keys: int = 32,
                 hot_after: int = 8, lookahead_chunks: int = 2,
                 fill_interval_s: float = 0.02,
                 max_fills_per_cycle: int = 4):
        self.fleet = fleet
        self.chunk_rows = max(1, int(chunk_rows))
        self.max_chunks_per_key = max(1, int(max_chunks_per_key))
        self.max_keys = max(1, int(max_keys))
        self.hot_after = max(0, int(hot_after))
        self.lookahead_chunks = max(0, int(lookahead_chunks))
        self.fill_interval_s = float(fill_interval_s)
        self.max_fills_per_cycle = max(1, int(max_fills_per_cycle))
        self._lock = threading.Lock()
        lockwatch.set_name(self._lock, "row_pool")
        self._entries: OrderedDict = OrderedDict()  # key -> _PoolEntry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "RowPool":
        self._stop.clear()
        self._thread = threading.Thread(target=self._filler,
                                        name="row-pool-filler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _filler(self) -> None:
        while not self._stop.wait(self.fill_interval_s):
            try:
                self.fill_once()
            except Exception:  # noqa: BLE001 — filling must never die
                pass

    # --------------------------------------------------------- request path

    def get(self, tenant: str, seed: int, offset: int, n: int,
            condition: Optional[int], header: bool) -> Optional[list]:
        """Response byte segments for rows [offset, offset+n) of
        ``(tenant, seed, condition)``, or None when not fully cached.
        Records the demand either way — misses are what make a key hot."""
        key = (tenant, seed, condition)
        c0 = offset // self.chunk_rows
        c1 = (offset + n - 1) // self.chunk_rows
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = _PoolEntry()
                entry.want_lo, entry.want_hi = c0, c1
                self._entries[key] = entry
                while len(self._entries) > self.max_keys:
                    self._entries.popitem(last=False)
                    self.evictions += 1
            else:
                self._entries.move_to_end(key)
            entry.demand += 1
            # grow the demanded window while it fits the per-key budget —
            # stable for clients looping a bounded stream — and only once
            # the span exceeds capacity slide it to the latest request,
            # which is what a forward-walking client expects
            lo = min(entry.want_lo, c0)
            hi = max(entry.want_hi, c1)
            if hi - lo >= self.max_chunks_per_key:
                lo = c0
                hi = max(c1, entry.want_hi) if entry.want_hi >= c0 else c1
            entry.want_lo, entry.want_hi = lo, hi
            if entry.unpoolable:
                return None
            out = [entry.header] if header else []
            for c in range(c0, c1 + 1):
                rows = entry.chunks.get(c)
                if rows is None:
                    self.misses += 1
                    return None
                lo = max(0, offset - c * self.chunk_rows)
                hi = min(self.chunk_rows, offset + n - c * self.chunk_rows)
                out.extend(rows[lo:hi])
            self.hits += 1
            return out

    def invalidate(self, tenant: str) -> None:
        """Drop every entry of ``tenant`` — called when a hot reload
        adopts a new model, so a pool hit can never serve stale rows."""
        with self._lock:
            for key in [k for k in self._entries if k[0] == tenant]:
                del self._entries[key]

    # --------------------------------------------------------------- filler

    def _plan(self) -> list:
        """(key, chunk_index) fills wanted right now, hot keys first by
        demand, bounded to ``max_fills_per_cycle``.  Also slides each
        entry's window: chunks behind the demanded range are dropped."""
        plan: list = []
        with self._lock:
            entries = sorted(self._entries.items(),
                             key=lambda kv: -kv[1].demand)
            for key, entry in entries:
                if entry.unpoolable or entry.demand < self.hot_after:
                    continue
                lo = entry.want_lo
                hi = entry.want_hi + self.lookahead_chunks
                hi = min(hi, lo + self.max_chunks_per_key - 1)
                for c in [c for c in entry.chunks if c < lo or c > hi]:
                    del entry.chunks[c]
                    self.evictions += 1
                for c in range(lo, hi + 1):
                    if c not in entry.chunks:
                        plan.append((key, c))
                        if len(plan) >= self.max_fills_per_cycle:
                            return plan
        return plan

    def _drop_key(self, key: tuple) -> bool:
        """Forget ``key`` (its tenant left the fleet); returns False so
        ``_fill_chunk`` can tail-call it."""
        with self._lock:
            self._entries.pop(key, None)
        return False

    def _fill_chunk(self, key: tuple, chunk: int) -> bool:
        tenant, seed, condition = key
        rt = self.fleet.get(tenant)
        if rt is None:
            return self._drop_key(key)
        snap = rt.engine.snapshot()
        try:
            header, rows = rt.engine.sample_csv_segments(
                self.chunk_rows, seed=seed, offset=chunk * self.chunk_rows,
                condition=condition, snap=snap)
        except ValueError:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    entry.unpoolable = True
                    entry.chunks.clear()
            return False
        model_id = snap.model.model_id
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return False
            if entry.model_id != model_id:
                if entry.model_id is not None:
                    # the tenant moved to a new model mid-fill: drop the
                    # old-model chunks rather than mixing generations
                    entry.chunks.clear()
                entry.model_id = model_id
            entry.header = header
            entry.chunks[chunk] = rows
            self.fills += 1
            while len(entry.chunks) > self.max_chunks_per_key:
                oldest = min(entry.chunks)
                del entry.chunks[oldest]
                self.evictions += 1
        return True

    def fill_once(self) -> int:
        """One filler cycle: plan under the lock, sample outside it,
        insert under the lock.  Returns the number of chunks filled."""
        filled = 0
        for key, chunk in self._plan():
            if self._fill_chunk(key, chunk):
                filled += 1
        return filled

    def fill_now(self, tenant: str, seed: int = 0, offset: int = 0,
                 n: int = 1, condition: Optional[int] = None) -> int:
        """Synchronously cover rows [offset, offset+n) for a key — the
        deterministic test seam (no background thread needed)."""
        key = (tenant, seed, condition)
        c0 = offset // self.chunk_rows
        c1 = (offset + n - 1) // self.chunk_rows
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = _PoolEntry()
                self._entries[key] = entry
            entry.demand = max(entry.demand, self.hot_after)
            entry.want_lo, entry.want_hi = c0, c1
        filled = 0
        for c in range(c0, c1 + 1):
            if self._fill_chunk(key, c):
                filled += 1
        return filled

    # --------------------------------------------------------------- status

    def stats(self) -> dict:
        with self._lock:
            chunks = sum(len(e.chunks) for e in self._entries.values())
            return {
                "keys": len(self._entries),
                "chunks": chunks,
                "rows": chunks * self.chunk_rows,
                "hits": self.hits,
                "misses": self.misses,
                "fills": self.fills,
                "evictions": self.evictions,
            }
