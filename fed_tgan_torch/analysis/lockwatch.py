"""lockwatch -- the runtime prong of locklint: an opt-in deadlock
sanitizer + lock metrics for the threaded serving/observability plane
(a copy of ``fed_tgan_tpu/analysis/lockwatch.py``; stdlib only).

Same contract as ``sanitizers.py``: **zero-cost when uninstalled** (no
import-time patching, plain ``threading`` locks untouched), armed
explicitly by tests / ``doctor`` / ``fleet --lockwatch``.
While installed, every lock created through ``threading.Lock()`` /
``threading.RLock()`` is wrapped; each wrapper records, per thread, the
stack of locks currently held and feeds a **global lock-order graph**
(GoodLock): acquiring B while holding A adds the edge A->B, and a path
B ->* A already in the graph means two threads can interleave the two
orders into a deadlock -- reported *without* needing the unlucky
schedule to actually happen.  Two report kinds:

* ``reentry`` -- a thread blocking-acquires a non-reentrant lock it
  already holds (the fleet's ``submit`` -> ``_shed`` shape).  This is a
  *certain* deadlock, so it always raises :class:`DeadlockError`
  instead of hanging the process, whatever the ``on_deadlock`` policy.
* ``cycle`` -- the order graph closed a cycle.  Potential deadlock:
  recorded, and raised as well under ``on_deadlock="raise"``.

Locks are identified by *allocation-site name* (``serve.fleet:__init__``
-- stable across instances, so two instances of one class still build
meaningful order edges); :func:`set_name` assigns curated names to the
locks a budget tracks (``fleet_adm``, ``row_pool``).  Per-lock
hold-time and acquire-wait histograms accumulate in-process and export
to ``obs/registry.py`` as labeled Prometheus series
(``fed_tgan_lock_hold_seconds{lock="..."}``) via
:func:`export_to_registry`; :func:`summary` returns the
``lock/<name>/hold_p99_ms`` figures ``fleet --lockwatch`` prints.

Caveat: ``Condition.wait`` releases its lock through the inner lock's
``_release_save`` (delegated, uncounted), so a waiter's hold-time
includes the waited interval -- fine for the contention signal these
histograms exist for.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

__all__ = [
    "DeadlockError",
    "DeadlockReport",
    "WatchedLock",
    "clear",
    "export_to_registry",
    "install",
    "installed",
    "reports",
    "set_name",
    "summary",
    "uninstall",
    "watch",
    "wrap",
]

# real factories captured at import time: lockwatch's own state and the
# uninstall path must never route through the wrappers
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

#: stdlib layers to skip when naming a lock by its allocation site --
#: ``queue.Queue()`` allocates its mutex inside ``queue``, but the
#: interesting site is whoever built the queue
_OPAQUE_MODULES = ("threading", "queue", "logging", "asyncio", "selectors",
                   "socketserver", "http", "concurrent",
                   "fed_tgan_torch.analysis.lockwatch")

#: per-lock sample cap -- enough for exact p99 over a load run
#: without unbounded growth on million-op runs
_MAX_SAMPLES = 100_000


class DeadlockError(RuntimeError):
    """Raised instead of letting the offending ``acquire`` hang."""


@dataclass
class DeadlockReport:
    kind: str                  # "reentry" | "cycle"
    locks: Tuple[str, ...]     # reentry: (name,); cycle: path, first==last
    thread: str
    detail: str


@dataclass
class _LockStats:
    acquisitions: int = 0
    contentions: int = 0
    holds: List[float] = field(default_factory=list)    # seconds
    waits: List[float] = field(default_factory=list)    # contended waits
    exported_holds: int = 0
    exported_waits: int = 0


class _State:
    def __init__(self) -> None:
        self.lock = _REAL_LOCK()
        self.installed = False
        self.raise_on_cycle = True
        self.edges: Dict[Tuple[str, str], str] = {}    # (a, b) -> detail
        self.reports: List[DeadlockReport] = []
        self.report_keys: Set[FrozenSet[str]] = set()
        self.stats: Dict[str, _LockStats] = {}


_STATE = _State()
_HELD = threading.local()   # .stack: List[Tuple[WatchedLock, float]]


def _thread_name() -> str:
    """Current thread's name WITHOUT ``threading.current_thread()``:
    that helper allocates a ``_DummyThread`` (whose ``Event`` touches a
    watched lock) when called during thread bootstrap, before the
    thread registers itself -- infinite recursion.  A raw ``_active``
    dict read is safe under the GIL and allocation-free."""
    ident = threading.get_ident()
    t = threading._active.get(ident)
    return t.name if t is not None else f"tid-{ident}"


def _held_stack() -> list:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


def _site_name() -> str:
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if not any(mod == m or mod.startswith(m + ".")
                   for m in _OPAQUE_MODULES):
            short = mod
            if short.startswith("fed_tgan_torch."):
                short = short[len("fed_tgan_torch."):]
            return f"{short}:{f.f_code.co_name}"
        f = f.f_back
    return "anon"


class WatchedLock:
    """Duck-typed ``threading.Lock``/``RLock`` stand-in.

    ``acquire``/``release``/``locked`` and the context protocol are
    instrumented; everything else (``_release_save`` / ``_is_owned`` /
    ... as used by ``threading.Condition``) delegates to the wrapped
    lock via ``__getattr__`` -- so a Condition built on a primitive
    watched lock still sees the AttributeError it uses to pick its
    fallback path, and one built on a watched RLock gets the real
    reentrancy internals.
    """

    def __init__(self, inner, name: str, reentrant: bool) -> None:
        self._inner = inner
        self.name = name
        self.reentrant = reentrant

    # ------------------------------------------------------ lock protocol

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        armed = _STATE.installed
        held = _held_stack() if armed else None
        if armed and blocking:
            self._check(held, indefinite=timeout is None or timeout < 0)
        got = self._inner.acquire(False)
        wait = 0.0
        contended = got is False
        if not got:
            if not blocking:
                if armed:
                    self._record_acquire(contended=True, wait=None)
                return False
            t0 = time.perf_counter()
            got = self._inner.acquire(True, timeout)
            wait = time.perf_counter() - t0
        if got and armed:
            held.append((self, time.perf_counter()))
            self._record_acquire(contended=contended,
                                 wait=wait if contended else 0.0)
        return got

    def release(self) -> None:
        if _STATE.installed:
            held = _held_stack()
            for i in range(len(held) - 1, -1, -1):
                if held[i][0] is self:
                    hold = time.perf_counter() - held[i][1]
                    del held[i]
                    self._record_release(hold)
                    break
        self._inner.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        if locked is not None:
            return locked()
        # RLock before the `locked()` API: probe via non-blocking acquire
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __enter__(self) -> "WatchedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __getattr__(self, attr):
        return getattr(object.__getattribute__(self, "_inner"), attr)

    def __repr__(self) -> str:
        return f"<WatchedLock {self.name!r} wrapping {self._inner!r}>"

    # ------------------------------------------------------- bookkeeping

    def _record_acquire(self, contended: bool,
                        wait: Optional[float]) -> None:
        with _STATE.lock:
            st = _STATE.stats.setdefault(self.name, _LockStats())
            if wait is not None:
                st.acquisitions += 1
            if contended:
                st.contentions += 1
            if wait and len(st.waits) < _MAX_SAMPLES:
                st.waits.append(wait)

    def _record_release(self, hold: float) -> None:
        with _STATE.lock:
            st = _STATE.stats.setdefault(self.name, _LockStats())
            if len(st.holds) < _MAX_SAMPLES:
                st.holds.append(hold)

    def _check(self, held: list, indefinite: bool) -> None:
        """Reentry + order-graph update before a blocking acquire."""
        me = _thread_name()
        if not self.reentrant and any(w is self for w, _ in held):
            report = DeadlockReport(
                kind="reentry", locks=(self.name,), thread=me,
                detail=(f"thread {me!r} re-acquired non-reentrant lock "
                        f"{self.name!r} it already holds"))
            with _STATE.lock:
                _STATE.reports.append(report)
            if indefinite:
                # proceeding would hang the thread forever: always raise
                raise DeadlockError(report.detail)
            return
        cycle_report = None
        with _STATE.lock:
            for w, _ in held:
                if w.name == self.name:
                    continue
                edge = (w.name, self.name)
                if edge in _STATE.edges:
                    continue
                path = self._find_path(self.name, w.name)
                _STATE.edges[edge] = (f"thread {me!r} acquired "
                                      f"{self.name!r} holding {w.name!r}")
                if path is not None:
                    cycle = (w.name,) + tuple(path)
                    key = frozenset(cycle)
                    if key not in _STATE.report_keys:
                        _STATE.report_keys.add(key)
                        cycle_report = DeadlockReport(
                            kind="cycle", locks=cycle, thread=me,
                            detail=("lock-order cycle "
                                    + " -> ".join(cycle)
                                    + f" (closed by thread {me!r})"))
                        _STATE.reports.append(cycle_report)
            raise_on_cycle = _STATE.raise_on_cycle
        if cycle_report is not None and raise_on_cycle:
            raise DeadlockError(cycle_report.detail)

    @staticmethod
    def _find_path(src: str, dst: str) -> Optional[List[str]]:
        """Path src ->* dst in the order graph (caller holds _STATE.lock);
        adding dst->src then closes a cycle."""
        adj: Dict[str, List[str]] = {}
        for a, b in _STATE.edges:
            adj.setdefault(a, []).append(b)
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


# ------------------------------------------------------------- factories

def _watched_lock():
    return WatchedLock(_REAL_LOCK(), _site_name(), reentrant=False)


def _watched_rlock():
    return WatchedLock(_REAL_RLOCK(), _site_name(), reentrant=True)


def wrap(lock, name: Optional[str] = None,
         reentrant: bool = False) -> WatchedLock:
    """Explicitly wrap an existing lock (for targeted instrumentation
    without installing the global factories)."""
    return WatchedLock(lock, name or _site_name(), reentrant=reentrant)


def set_name(lock, name: str) -> None:
    """Curated stable name for a lock the budgets reference.  No-op for
    plain (unwatched) locks so call sites need no feature gate."""
    if isinstance(lock, WatchedLock):
        lock.name = name


# ---------------------------------------------------------- arm / disarm

def install(on_deadlock: str = "raise") -> None:
    """Patch the ``threading.Lock``/``RLock`` factories.  Locks created
    from here on are watched; pre-existing locks are untouched.

    ``on_deadlock``: ``"raise"`` turns a detected order cycle into an
    immediate :class:`DeadlockError` at the closing acquire;
    ``"record"`` only appends to :func:`reports`.  Certain single-
    thread re-entry deadlocks always raise (the alternative is a hang).
    """
    if on_deadlock not in ("raise", "record"):
        raise ValueError(f"on_deadlock: {on_deadlock!r}")
    with _STATE.lock:
        if _STATE.installed:
            raise RuntimeError("lockwatch already installed")
        _STATE.installed = True
        _STATE.raise_on_cycle = on_deadlock == "raise"
    threading.Lock = _watched_lock
    threading.RLock = _watched_rlock


def uninstall() -> None:
    """Restore the real factories.  Existing wrappers fall back to plain
    delegation (the ``installed`` flag gates all bookkeeping), and the
    collected stats/reports survive until :func:`clear`."""
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    with _STATE.lock:
        _STATE.installed = False


def installed() -> bool:
    return _STATE.installed


def clear() -> None:
    with _STATE.lock:
        _STATE.edges.clear()
        _STATE.reports.clear()
        _STATE.report_keys.clear()
        _STATE.stats.clear()


@contextmanager
def watch(on_deadlock: str = "raise", clear_first: bool = True):
    """``with lockwatch.watch(): ...`` -- arm, run, disarm.  The state
    is cleared on entry (not exit) so callers can inspect reports and
    stats after the block."""
    if clear_first:
        clear()
    install(on_deadlock=on_deadlock)
    try:
        yield sys.modules[__name__]
    finally:
        uninstall()


# -------------------------------------------------------------- queries

def reports(kind: Optional[str] = None) -> List[DeadlockReport]:
    with _STATE.lock:
        out = list(_STATE.reports)
    return [r for r in out if kind is None or r.kind == kind]


def _quantile(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    lat = sorted(samples)
    return lat[min(len(lat) - 1, max(0, round(q * (len(lat) - 1))))]


def summary() -> Dict[str, Dict[str, float]]:
    """Per-lock stats: the ``lock/<name>/hold_p99_ms`` figures, plus
    contention context."""
    with _STATE.lock:
        items = [(name, st.acquisitions, st.contentions,
                  list(st.holds), list(st.waits))
                 for name, st in _STATE.stats.items()]
    out: Dict[str, Dict[str, float]] = {}
    for name, acq, cont, holds, waits in items:
        out[name] = {
            "acquisitions": acq,
            "contentions": cont,
            "hold_p50_ms": round(_quantile(holds, 0.50) * 1e3, 4),
            "hold_p99_ms": round(_quantile(holds, 0.99) * 1e3, 4),
            "hold_max_ms": round(max(holds) * 1e3, 4) if holds else 0.0,
            "wait_p99_ms": round(_quantile(waits, 0.99) * 1e3, 4),
        }
    return out


def export_to_registry(registry=None) -> None:
    """Flush accumulated samples into ``obs.registry`` labeled series
    (``fed_tgan_lock_hold_seconds{lock=...}`` / ``_wait_seconds`` /
    ``_contentions_total``).  Incremental: each call exports only the
    samples collected since the last one, so periodic flushes do not
    double-count."""
    from fed_tgan_torch.obs.registry import get_registry

    reg = registry if registry is not None else get_registry()
    with _STATE.lock:
        batches = []
        for name, st in _STATE.stats.items():
            batches.append((name,
                            st.holds[st.exported_holds:],
                            st.waits[st.exported_waits:],
                            st.contentions))
            st.exported_holds = len(st.holds)
            st.exported_waits = len(st.waits)
    for name, holds, waits, contentions in batches:
        labels = {"lock": name}
        hold_h = reg.histogram("fed_tgan_lock_hold_seconds",
                               "lock hold time (lockwatch)", labels=labels)
        for v in holds:
            hold_h.observe(v)
        wait_h = reg.histogram("fed_tgan_lock_wait_seconds",
                               "contended acquire wait (lockwatch)",
                               labels=labels)
        for v in waits:
            wait_h.observe(v)
        g = reg.gauge("fed_tgan_lock_contentions_total",
                      "contended acquires seen by lockwatch",
                      labels=labels)
        g.set(contentions)
