"""Runtime sanitizers: a sync guard, a build counter, a determinism guard
and a NaN guard (counterpart of ``fed_tgan_tpu/analysis/sanitizers.py``).

The lint prongs prove the *source* clean; these prove the *process* is.
Everything is opt-in and near zero-cost when off: :func:`hot_region` is a
no-op unless :func:`enable_sanitizers` (or ``--sanitize`` / the
:func:`sanitize` context manager) is active.

- **The sync guard** replaces JAX's
  ``transfer_guard_device_to_host("disallow")``.  While the sanitizers are
  on, the process runs under ``torch.cuda.set_sync_debug_mode("warn")``,
  which warns at every synchronising CUDA call; a ``warnings`` hook
  (with an ``"always"`` filter, so a second sync from one line is not
  deduplicated away) decides per thread.  Inside a steady
  :func:`hot_region` and outside :func:`sanctioned_sync` (the port's
  counterpart of an explicit ``jax.device_get``), a sync raises
  :class:`SyncGuardError` naming the region and the call site, from the
  synchronising call itself; should a warning not reach its caller (it
  is raised from a thread of the library's own), the region raises it on
  exit.  Syncs on other threads (the snapshot writer, the HTTP
  handlers) never trip the region of this one.  As in JAX, the first
  entry of each region name runs unguarded (set-up legitimately
  synchronises) unless ``guard_warmup``.  Every sync seen while the
  sanitizers are on is kept in a census (:func:`sync_census`): its call
  site, its region entry, and whether it was sanctioned.
- **The build counter** replaces JAX's compile counter.  The port
  compiles no XLA programs; what it builds once and then caches is the
  kernel library (``ops/activate_cuda.py::build``, ``data/fastcsv.build``),
  a layout's device tables (``_prepared``, ``ops/segments.py::
  cond_tables``), a launch plan (``_plan``) and the fleet's lane groups
  (``serve/fleet.py::ProgramCache.get_or_build``).  Each build calls
  :func:`note_build`, which counts it per name, journals a ``compile``
  event (``program=``) and notes it in the cost ledger.  The budgets
  keep JAX's meaning (:func:`check_training_budget`,
  :func:`check_serving_budget`, :func:`check_fleet_budget`).
- **The determinism guard**: ``torch.use_deterministic_algorithms(True)``,
  so that an op with no deterministic implementation raises instead of
  breaking the bit-exact rule.  cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG``
  set before a process's first cuBLAS handle; :func:`prepare_process`
  sets it, and the CLI, ``serve`` and ``fleet`` call it before any CUDA
  work when ``--sanitize`` is given.
- **The NaN guard** (``nan_debug``, ``--sanitize-nans``) replaces
  ``jax_debug_nans``: a ``TorchDispatchMode`` on the enabling thread
  checks every floating output of every aten op and raises
  ``FloatingPointError`` naming the op at the first NaN (as JAX's flag:
  an infinity is a legitimate value here, the initial value of the max
  reductions; the robust aggregators' NaN sentinels run inside
  :func:`nan_sentinels`).  The mode reaches the backward's ops on the
  autograd engine's threads too; ``torch.autograd.set_detect_anomaly``
  (without its own NaN check, which would sync there) adds the forward's
  traceback to a backward op's error.  The hand-written kernels launch through ``ctypes``, which no
  dispatch mode sees, so their wrappers check their outputs
  (:func:`check_kernel_output`).  The guard's own syncs are sanctioned.

torch is imported only when the sanitizers are enabled.
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings
from typing import Dict, List, Optional

from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.obs.ledger import get_ledger

__all__ = [
    "BuildCounter",
    "SyncGuardError",
    "building",
    "check_compile_budgets",
    "check_fleet_budget",
    "check_kernel_output",
    "check_serving_budget",
    "check_training_budget",
    "compile_report",
    "disable_sanitizers",
    "enable_sanitizers",
    "hot_region",
    "nan_sentinels",
    "note_build",
    "prepare_process",
    "report_and_check",
    "sanctioned_sync",
    "sanitize",
    "sanitizing",
    "sync_census",
    "sync_report",
]

#: the warning ``torch.cuda.set_sync_debug_mode("warn")`` raises at every
#: synchronising call
SYNC_MESSAGE = "called a synchronizing CUDA operation"
#: the cuBLAS workspace that makes its GEMMs deterministic
CUBLAS_WORKSPACE = ":4096:8"


class SyncGuardError(RuntimeError):
    """An unsanctioned synchronising call inside a steady hot region."""


class BuildCounter:
    """Counts the port's cached builds per name while attached."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: List[str] = []

    def record(self, name: str) -> None:
        with self._lock:
            self.events.append(name)
        _emit_event("compile", program=name)
        get_ledger().note_compile(name)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            names = list(self.events)
        out: Dict[str, int] = {}
        for name in names:
            out[name] = out.get(name, 0) + 1
        return out

    def count(self, name_substring: str) -> int:
        return sum(n for name, n in self.counts().items()
                   if name_substring in name)

    def reset(self) -> None:
        with self._lock:
            self.events = []


class _State:
    def __init__(self) -> None:
        self.active = False
        self.counter: Optional[BuildCounter] = None
        self.warmups: Optional[Dict[str, int]] = {}
        self.guard_warmup = False
        self.nan_mode = None  # the entered NaN dispatch mode
        self.nan_thread: Optional[int] = None
        self.saved: dict = {}
        self.syncs: Dict[tuple, int] = {}  # census key -> count
        # a hot region has begun its second entry: set-up is over
        self.steady = False
        self.lock = threading.Lock()


_STATE = _State()
# per thread: .region (name, entry, guarded) of the hot region entered, or
# None; .sanctioned (depth of sanctioned_sync blocks); .pending (errors raised
# in warnings that may not have reached their caller)
_TLS = threading.local()


def sanitizing() -> bool:
    return _STATE.active


def prepare_process() -> None:
    """What must precede a sanitized process's first CUDA work: cuBLAS's
    deterministic workspace (kept when the caller already set one)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)


# ------------------------------------------------------------- sync guard

def _site_of(filename: str, lineno: int) -> str:
    """``filename:lineno`` relative to the repository when inside it."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.abspath(filename)
    if path.startswith(root + os.sep):
        path = os.path.relpath(path, root)
    return f"{path}:{lineno}"


def note_sync(site: str) -> None:
    """Record one synchronising call of this thread from ``site``
    (``file:line``); raise :class:`SyncGuardError` when the thread is
    inside a steady hot region and not inside :func:`sanctioned_sync`."""
    region = getattr(_TLS, "region", None)
    sanctioned = getattr(_TLS, "sanctioned", 0) > 0
    key = (region[0] if region else None, region[1] if region else 0,
           sanctioned, site, _STATE.steady)
    with _STATE.lock:
        _STATE.syncs[key] = _STATE.syncs.get(key, 0) + 1
    if region is not None and region[2] and not sanctioned:
        err = SyncGuardError(
            f"unsanctioned synchronizing CUDA call in hot region "
            f"{region[0]!r} (entry {region[1]}) at {site}")
        _TLS.pending.append(err)
        raise err


_PREV_SHOWWARNING = None


def _showwarning(message, category, filename, lineno, file=None,
                 line=None):
    if _STATE.active and SYNC_MESSAGE in str(message):
        if (os.sep + "torch" + os.sep) in os.path.abspath(filename):
            # replayed by torch (a backward's warnings reach the thread
            # that called it at its end): the line that called into torch
            note_sync(_caller_site())
        else:
            note_sync(_site_of(filename, lineno))
        return
    _PREV_SHOWWARNING(message, category, filename, lineno, file, line)


@contextlib.contextmanager
def sanctioned_sync():
    """A synchronising call that is there by design (a chunk's one host
    copy, a response's copy, the snapshot writer's wait for its pinned
    copies, a build's copies to the card): legal inside a hot region,
    still in the census."""
    depth = getattr(_TLS, "sanctioned", 0)
    _TLS.sanctioned = depth + 1
    try:
        yield
    finally:
        _TLS.sanctioned = depth


class hot_region:
    """Mark a steady-state device-dispatch region (a ``with`` block).

    No-op unless the sanitizers are active.  The first entry per
    ``name`` runs unguarded (its syncs are still in the census, as its
    warm-up); later entries raise :class:`SyncGuardError` at an
    unsanctioned synchronising call of this thread."""

    def __init__(self, name: str):
        self.name = name
        self.entered = False

    def __enter__(self):
        st = _STATE
        if not st.active or st.warmups is None:
            return self
        with st.lock:
            n = st.warmups.get(self.name, 0) + 1
            st.warmups[self.name] = n
            st.steady = st.steady or n > 1
        self.entered = True
        self.prev = (getattr(_TLS, "region", None),
                     getattr(_TLS, "pending", None))
        _TLS.region = (self.name, n, n > 1 or st.guard_warmup)
        _TLS.pending = []
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self.entered:
            return False
        pending = _TLS.pending
        _TLS.region, _TLS.pending = self.prev
        if exc_type is None and pending:
            raise pending[0]
        return False


def sync_census() -> List[dict]:
    """Every synchronising call seen while the sanitizers were on, by
    ``(region, entry, sanctioned, site, steady)``: ``region`` None
    outside a hot region, ``entry`` the region's entry number (1: its
    warm-up), ``steady`` whether some hot region had begun its second
    entry (set-up is over: a sync outside the regions then is one of the
    steady state's, a snapshot's or a hook's)."""
    with _STATE.lock:
        items = sorted(_STATE.syncs.items(),
                       key=lambda kv: (kv[0][0] or "", kv[0][1], kv[0][2],
                                       kv[0][3], kv[0][4]))
    return [{"region": r, "entry": n, "sanctioned": s, "site": site,
             "steady": steady, "count": c}
            for (r, n, s, site, steady), c in items]


def sync_report() -> str:
    """Per hot region entry its unsanctioned and sanctioned syncs, then
    the syncs outside the hot regions, by site."""
    census = sync_census()
    lines = []
    entries: Dict[tuple, dict] = {}
    outside: Dict[tuple, int] = {}
    for c in census:
        if c["region"] is None:
            key = ("steady" if c["steady"] else "set-up", c["site"])
            outside[key] = outside.get(key, 0) + c["count"]
            continue
        e = entries.setdefault((c["region"], c["entry"]),
                               {"unsanctioned": 0, "sanctioned": {}})
        if c["sanctioned"]:
            e["sanctioned"][c["site"]] = c["count"]
        else:
            e["unsanctioned"] += c["count"]
    lines.append(f"sanitize: {sum(c['count'] for c in census)} "
                 "synchronizing call(s)")
    warm = _STATE.warmups is not None and not _STATE.guard_warmup
    for (region, n), e in sorted(entries.items()):
        sites = ", ".join(f"{s} x{k}" for s, k in
                          sorted(e["sanctioned"].items()))
        tag = " (warm-up, unguarded)" if n == 1 and warm else ""
        lines.append(f"  {region} entry {n}{tag}: {e['unsanctioned']} "
                     f"unsanctioned, {sum(e['sanctioned'].values())} "
                     f"sanctioned ({sites or 'none'})")
    for (when, site), k in sorted(outside.items(),
                                  key=lambda kv: (kv[0][0], -kv[1])):
        lines.append(f"  outside the hot regions, {when}: {site} x{k}")
    return "\n".join(lines)


# --------------------------------------------------------------- NaN guard

def _nan_mode_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _NanMode(TorchDispatchMode):
        """Raise at the first NaN in a floating output of an aten op
        (outputs of the ``empty`` family are uninitialised and skipped)."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if ("empty" not in func.__name__
                    and not getattr(_TLS, "nan_sentinels", 0)):
                for t in tree_leaves(out):
                    if (isinstance(t, torch.Tensor) and t.is_floating_point()
                            and t.device.type in ("cpu", "cuda")
                            and t.numel() and _has_nan(t)):
                        raise FloatingPointError(
                            f"NaN in the output of {func} at "
                            f"{_caller_site()} (sanitize-nans)")
            return out

    return _NanMode


@contextlib.contextmanager
def nan_sentinels():
    """Ops whose NaN is a sentinel by design (the robust aggregators mark
    excluded clients NaN for a NaN-skipping median): the NaN guard lets
    their outputs through, as JAX's flag sees only values that leave a
    compiled program."""
    depth = getattr(_TLS, "nan_sentinels", 0)
    _TLS.nan_sentinels = depth + 1
    try:
        yield
    finally:
        _TLS.nan_sentinels = depth


def _caller_site() -> str:
    """``file:line`` of the innermost frame outside torch, the warnings
    module and this module: the line whose op made the NaN or the sync."""
    import sys

    skip = (os.path.abspath(__file__), os.path.abspath(warnings.__file__))
    torch_dir = os.sep + "torch" + os.sep
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path not in skip and torch_dir not in path:
            return _site_of(path, f.f_lineno)
        f = f.f_back
    return "a backward op on the autograd engine's thread"


def _has_nan(t) -> bool:
    """Whether ``t`` holds a NaN.  On the card the flag is copied into
    pinned memory and waited for through an event: a wait the sync debug
    mode does not flag, since the check also runs on the autograd
    engine's threads, where this thread's sanction does not reach (their
    warnings are replayed on the thread that called backward)."""
    import torch

    flag = torch.isnan(t).any()
    if flag.device.type != "cuda":
        return bool(flag)
    host = flag.to("cpu", non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return bool(host)


def check_kernel_output(name: str, t) -> None:
    """The NaN guard's check of a hand-written kernel's output (``name``
    names the kernel); a no-op unless the guard is active and this is
    the thread it guards."""
    if (_STATE.nan_mode is None
            or threading.get_ident() != _STATE.nan_thread):
        return
    if _has_nan(t):
        raise FloatingPointError(f"NaN in the output of {name} "
                                 "(sanitize-nans)")


# ------------------------------------------------------------- on and off

def enable_sanitizers(sync_guard: bool = True, build_counter: bool = True,
                      nan_debug: bool = False, guard_warmup: bool = False,
                      deterministic: bool = True) -> Optional[BuildCounter]:
    """Turn the sanitizers on process-wide (the NaN guard on this thread
    and its backward passes).  Returns the build counter (None when
    ``build_counter`` is off).  Idempotent; pair with
    :func:`disable_sanitizers` or use :func:`sanitize`."""
    global _PREV_SHOWWARNING
    import torch

    st = _STATE
    with st.lock:
        if st.active:
            return st.counter
        st.saved = {
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "warn_only":
                torch.is_deterministic_algorithms_warn_only_enabled(),
            "anomaly": (torch.is_anomaly_enabled(),
                        torch.is_anomaly_check_nan_enabled()),
        }
        st.warmups = {} if sync_guard else None
        st.guard_warmup = guard_warmup and sync_guard
        st.counter = BuildCounter() if build_counter else None
        st.syncs = {}
        st.steady = False
        st.active = True
    if torch.cuda.is_available():
        st.saved["sync_debug_mode"] = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    warnings.filterwarnings("always", message=SYNC_MESSAGE)
    st.saved["filter"] = warnings.filters[0]
    _PREV_SHOWWARNING = warnings.showwarning
    warnings.showwarning = _showwarning
    if deterministic:
        torch.use_deterministic_algorithms(True)
    if nan_debug:
        st.nan_mode = _nan_mode_class()()
        st.nan_mode.__enter__()
        st.nan_thread = threading.get_ident()
        # the forward's traceback on a backward op's error; the dispatch
        # mode checks the backward's outputs (anomaly mode's own NaN
        # check would sync on the engine's threads)
        torch.autograd.set_detect_anomaly(True, check_nan=False)
    return st.counter


def disable_sanitizers() -> None:
    """Restore what :func:`enable_sanitizers` changed.  The NaN guard is
    left on the thread that entered it, so call this there."""
    global _PREV_SHOWWARNING
    import torch

    st = _STATE
    with st.lock:
        if not st.active:
            return
        st.active = False
    if st.nan_mode is not None:
        st.nan_mode.__exit__(None, None, None)
        st.nan_mode = st.nan_thread = None
    torch.autograd.set_detect_anomaly(*st.saved["anomaly"])
    torch.use_deterministic_algorithms(st.saved["deterministic"],
                                       warn_only=st.saved["warn_only"])
    if "sync_debug_mode" in st.saved:
        torch.cuda.set_sync_debug_mode(st.saved["sync_debug_mode"])
    if warnings.showwarning is _showwarning:
        warnings.showwarning = _PREV_SHOWWARNING
    with contextlib.suppress(ValueError):
        warnings.filters.remove(st.saved["filter"])
        warnings._filters_mutated()
    st.counter = None
    st.warmups = {}


@contextlib.contextmanager
def sanitize(sync_guard: bool = True, build_counter: bool = True,
             nan_debug: bool = False, guard_warmup: bool = False,
             deterministic: bool = True):
    """``with sanitize() as counter:`` -- scoped enable/disable."""
    counter = enable_sanitizers(sync_guard=sync_guard,
                                build_counter=build_counter,
                                nan_debug=nan_debug,
                                guard_warmup=guard_warmup,
                                deterministic=deterministic)
    try:
        yield counter
    finally:
        disable_sanitizers()


# ---------------------------------------------------------------- builds

def note_build(name: str) -> None:
    """One cached build of ``name`` (counted while the sanitizers are
    on)."""
    counter = _STATE.counter
    if _STATE.active and counter is not None:
        counter.record(name)


@contextlib.contextmanager
def building(name: str):
    """A cached build of ``name`` that copies to the card (a layout's
    tables, a lane group): counted by :func:`note_build`, its syncs
    sanctioned -- set-up work, as a compile is inside JAX's guarded
    region, wherever the first use falls."""
    note_build(name)
    with sanctioned_sync():
        yield


def check_compile_budgets(budgets: Dict[str, int],
                          counter: Optional[BuildCounter] = None
                          ) -> List[str]:
    """Violations for ``{build-name-substring: max_builds}``."""
    counter = counter or _STATE.counter
    if counter is None:
        return []
    out = []
    for name, budget in budgets.items():
        n = counter.count(name)
        if n > budget:
            out.append(f"build '{name}' ran {n}x (budget {budget}) -- "
                       "cache miss?")
    return out


def _once_each(counter: BuildCounter, prefixes: tuple, what: str
               ) -> List[str]:
    return [f"{what} '{name}' built {n}x (budget 1) -- rebuilt in "
            "steady state?"
            for name, n in counter.counts().items()
            if name.startswith(prefixes) and n > 1]


def _plans_for(counter: BuildCounter, rows) -> List[str]:
    """The launch plans built for any of the row counts ``rows``."""
    return [name for name in counter.counts()
            if name.startswith("plan[") and _plan_rows(name) in rows]


def _plan_rows(name: str) -> int:
    return int(name[len("plan["):].split("x", 1)[0])


def check_training_budget(trainer, counter=None) -> List[str]:
    """One table set per (layout, device), and one launch plan per
    distinct stacked row count of the trainer's steps
    (``trainer.step_rows``); nothing rebuilt.  (A watchdog rollback that
    rebuilds the trainer keeps the tables and plans cached: check against
    the final trainer.)"""
    counter = counter or _STATE.counter
    rows = getattr(trainer, "step_rows", None)
    if counter is None or rows is None:
        return []
    out = _once_each(counter, ("tables[", "plan[", "library["), "build")
    plans = _plans_for(counter, rows)
    if len(plans) > max(1, len(rows)):
        out.append(f"{len(plans)} launch plans for {len(rows)} stacked "
                   f"row count(s) {sorted(rows)} -- plan cache miss?")
    return out


def check_serving_budget(engine, counter=None) -> List[str]:
    """Each layout's tables and each chunk size's launch plan built once
    (``engine.chunk_rows``: the row counts it dispatched), none rebuilt
    in steady state."""
    counter = counter or _STATE.counter
    rows = getattr(engine, "chunk_rows", None)
    if counter is None or rows is None:
        return []
    out = _once_each(counter, ("tables[", "plan[", "library["), "build")
    plans = _plans_for(counter, rows)
    if len(plans) > max(1, len(rows)):
        out.append(f"{len(plans)} launch plans for {len(rows)} chunk "
                   f"size(s) -- plan cache miss?")
    return out


def check_fleet_budget(cache, counter=None) -> List[str]:
    """The fleet's shared LRU builds at most one lane group per cached
    key: builds <= entries + evictions, and one build per name while
    nothing has been evicted."""
    counter = counter or _STATE.counter
    stats = cache.stats() if cache is not None else None
    if counter is None or stats is None:
        return []
    budget = max(1, stats["entries"] + stats["evictions"])
    out = check_compile_budgets({"lanes[": budget}, counter)
    if stats["evictions"] == 0:
        out += _once_each(counter, ("lanes[",), "lane group")
    out += _once_each(counter, ("tables[", "plan[", "library["), "build")
    return out


def compile_report(counter: Optional[BuildCounter] = None) -> str:
    counter = counter or _STATE.counter
    if counter is None:
        return "sanitize: build counter inactive"
    counts = counter.counts()
    if not counts:
        return "sanitize: 0 build events"
    lines = [f"sanitize: {sum(counts.values())} build event(s):"]
    for name in sorted(counts, key=lambda k: (-counts[k], k)):
        lines.append(f"  {counts[name]:4d}x {name}")
    return "\n".join(lines)



def report_and_check(problems: List[str], quiet: bool = False) -> int:
    """The end-of-run report: builds, syncs, and each budget problem as a
    ``SANITIZE:`` line; 4 when there is one, else 0."""
    if not quiet:
        print(compile_report())
        print(sync_report())
    for problem in problems:
        print(f"SANITIZE: {problem}")
    return 4 if problems else 0
