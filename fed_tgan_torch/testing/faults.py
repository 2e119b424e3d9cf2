"""Deterministic fault injection (counterpart of
``fed_tgan_tpu/testing/faults.py:99-476``).

A :class:`FaultPlan` parses the JAX package's spec grammar: ``;``-separated
faults, ``,``-separated ``key=value`` arguments, every kind of
:attr:`FaultPlan.VALID_KINDS`.  An unknown kind fails fast.  The port acts
on every kind:

- ``kill_client:rank=R,round=E`` — client ``R`` (1-based) is dropped at
  the start of round ``E`` (1-based), once; in a multi-process world the
  participant of rank ``R`` hard-exits (``os._exit(17)``) at the start of
  that round instead (:mod:`fed_tgan_torch.train.multihost`);
- ``delay_msg:ms=M`` — every transport send sleeps ``M`` ms first
  (:meth:`FaultPlan.maybe_delay`);
- ``sever_conn:rank=R,after=N`` — client ``R`` severs its own live
  transport connection after its ``N``-th successful send, once
  (:meth:`FaultPlan.should_sever`), so the next operation rides a
  reconnect and a sequence resync;
- ``crash_checkpoint:save=N`` — the ``N``-th ``save_federated`` call
  raises :class:`FaultInjected` after ``host.json`` is staged and before
  the publish, as a crash mid-write would;
- ``nan_update`` / ``scale_update`` / ``stuck_update`` with
  ``rank=R[,round=E][,until=U]`` (``scale_update:F`` reads the factor
  positionally) — client ``R`` ships all-NaN parameters, ``prev + F *
  delta``, or its pre-round parameters after its local steps in every
  round of the window [E, U] (U=0: forever);
- ``degrade_snapshot:factor=F[,nth=N]`` (``degrade_snapshot:F`` reads the
  factor positionally) — the ``N``-th published sampling artifact
  (``save_synthesizer``) has the generator's first linear weight scaled by
  ``F`` in place after the publish (:func:`degrade_checkpoint`): loadable,
  with a new fingerprint, and only the canary's scoring can tell;
- ``corrupt_cache:nth=N`` — the ``N``-th init-cache entry stored in this
  process (default the first) is truncated after its atomic publish; the
  digest check must catch it on the next read and force a refit;
- ``join:round=E[,count=N]`` — ``N`` (default 1) newcomers join at the
  start of round ``E`` (1-based), through the elastic federation
  (:mod:`fed_tgan_torch.federation.elastic`);
- ``leave:client=C,round=E`` — client ``C`` (0-based) departs at the start
  of round ``E``; the survivors' weights renormalize;
- ``drift:client=C,round=E[,shift=S]`` — client ``C``'s shard is silently
  swapped for :func:`drift_frame` of it (continuous columns moved by ``S``
  standard deviations, categorical mass rotated) at the start of round
  ``E``; only the drift detector's windows can catch it;
- ``straggle:rank=R,delay=D[,round=E][,until=U]`` — client ``R`` (1-based)
  straggles over rounds [E, U] (U=0: forever): under buffered aggregation
  it leaves each such round's barrier and its delta lands ``D`` rounds
  later, discounted (:func:`straggle_window`); under sync aggregation the
  fault does nothing, as in JAX.

The churn kinds are host events between rounds: :meth:`FaultPlan.
churn_events` lists a round's, :meth:`FaultPlan.next_churn_round` the next
round that has one.  A kind the port did not act on would be refused by
:func:`install_plan` and :func:`active_plan` (:func:`require_ported`,
through :data:`NOT_PORTED_KINDS`, now empty), so none parses and then
quietly does nothing.

Plans come from the ``--faults`` CLI flag or the
``FED_TGAN_TORCH_FAULTS`` environment variable, which the CLI exports so
the processes of a multi-process world see the same plan.  The trainer and the
checkpoint writer consult :func:`active_plan`, which is None unless a plan
was installed.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Optional

import numpy as np

log = logging.getLogger("fed_tgan_torch.faults")

ENV_VAR = "FED_TGAN_TORCH_FAULTS"

# kind -> the ROADMAP item the port waits for before it can act on it
NOT_PORTED_KINDS: dict = {}


class FaultInjected(RuntimeError):
    """Raised at an injection point that simulates an in-process crash."""


@dataclasses.dataclass
class FaultPlan:
    """Parsed fault spec; the counters are per process and thread-safe.
    The fields are the JAX package's, with its defaults."""

    kill_rank: int = 0          # 0 = no kill fault
    kill_round: int = 0
    delay_ms: int = 0
    sever_rank: int = 0         # 0 = no sever fault
    sever_after: int = 0
    crash_save: int = 0         # 0 = no checkpoint-crash fault
    update_kind: str = ""       # "" = no update fault; nan | scale | stuck
    update_rank: int = 0        # 1-based client rank shipping bad updates
    update_factor: float = 1.0  # delta scale for kind == "scale"
    update_round: int = 1       # first faulty round (1-based)
    update_until: int = 0       # last faulty round (0 = forever)
    straggle_rank: int = 0
    straggle_delay: int = 1
    straggle_round: int = 1
    straggle_until: int = 0
    corrupt_cache_nth: int = 0
    degrade_factor: float = 0.0
    degrade_nth: int = 1
    joins: list = dataclasses.field(default_factory=list)   # [(round, count)]
    leaves: list = dataclasses.field(default_factory=list)  # [(round, client)]
    drifts: list = dataclasses.field(default_factory=list)  # [(round, client, shift)]

    VALID_KINDS = ("corrupt_cache", "crash_checkpoint", "degrade_snapshot",
                   "delay_msg", "drift", "join", "kill_client", "leave",
                   "nan_update", "scale_update", "sever_conn", "straggle",
                   "stuck_update")

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._save_calls = 0
        self._cache_stores = 0
        self._snapshot_saves = 0
        self._severed = False
        self._killed = False
        self.kinds: list[str] = []  # the kinds of the parsed spec, in order

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        plan = cls()
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            name, _, argstr = part.partition(":")
            if name not in cls.VALID_KINDS:
                # before the arguments: a typo'd kind with a positional
                # factor must name the real problem
                raise ValueError(
                    f"unknown fault {name!r} in spec {spec!r}; valid "
                    f"kinds: {', '.join(cls.VALID_KINDS)}")
            plan.kinds.append(name)
            args = {}
            for kv in filter(None, (a.strip() for a in argstr.split(","))):
                k, eq, v = kv.partition("=")
                if not eq and name in ("scale_update", "degrade_snapshot"):
                    args["factor"] = float(k)  # scale_update:100
                    continue
                k = k.strip()
                args[k] = float(v) if k in ("factor", "shift") else int(v)
            _apply(plan, name, args, spec)
        return plan

    # -- injection points -----------------------------------------------

    def maybe_delay(self) -> None:
        """Sleep ``delay_ms`` before a transport send."""
        if self.delay_ms > 0:
            time.sleep(self.delay_ms / 1000.0)

    def should_sever(self, rank: int, sent_count: int) -> bool:
        """True exactly once, for client ``rank`` once it has made
        ``sever_after`` successful sends."""
        if self.sever_rank != rank or sent_count < self.sever_after:
            return False
        with self._lock:
            if self._severed:
                return False
            self._severed = True
            return True

    def should_kill(self, rank: int, round_1based: int) -> bool:
        """True exactly once, for client ``rank`` at ``round_1based``."""
        if self.kill_rank != rank or round_1based < self.kill_round:
            return False
        with self._lock:
            if self._killed:
                return False
            self._killed = True
            return True

    def on_checkpoint_write(self, path: str) -> None:
        """Called mid-``save_federated`` after part of the state is on
        disk; raises on the ``crash_save``-th call."""
        if self.crash_save <= 0:
            return
        with self._lock:
            self._save_calls += 1
            fire = self._save_calls == self.crash_save
        if fire:
            log.warning("FAULT: crashing checkpoint save #%d mid-write (%s)",
                        self.crash_save, path)
            raise FaultInjected(f"checkpoint save crashed mid-write: {path}")

    def on_cache_store(self, path: str) -> bool:
        """Called after an init-cache payload is published; truncates the
        ``corrupt_cache_nth`` stored file in place to half its size (the
        store itself reports success).  Returns whether the fault
        fired."""
        if self.corrupt_cache_nth <= 0:
            return False
        with self._lock:
            self._cache_stores += 1
            fire = self._cache_stores == self.corrupt_cache_nth
        if not fire:
            return False
        log.warning("FAULT: corrupting init-cache store #%d (%s)",
                    self.corrupt_cache_nth, path)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return True

    def has_churn(self) -> bool:
        return bool(self.joins or self.leaves or self.drifts)

    def churn_events(self, e0: int) -> list:
        """The membership events due at the start of 0-based round
        ``e0``: ``("join", count)``, ``("leave", client)`` and ``("drift",
        client, shift)``, joins first, then leaves, then drifts."""
        due: list = []
        due += [("join", n) for r, n in self.joins if r - 1 == e0]
        due += [("leave", c) for r, c in self.leaves if r - 1 == e0]
        due += [("drift", c, s) for r, c, s in self.drifts if r - 1 == e0]
        return due

    def next_churn_round(self, e0: int) -> Optional[int]:
        """The smallest 0-based round ``>= e0`` with a churn event, or
        None."""
        rounds = [r - 1 for r, *_ in (*self.joins, *self.leaves,
                                      *self.drifts) if r - 1 >= e0]
        return min(rounds) if rounds else None

    def on_snapshot_publish(self, path: str) -> bool:
        """Called after ``save_synthesizer`` publishes ``path``; degrades
        the ``degrade_nth`` published artifact in place (the save still
        reports success).  Returns whether the fault fired."""
        if self.degrade_factor == 0.0:
            return False
        with self._lock:
            self._snapshot_saves += 1
            fire = self._snapshot_saves == self.degrade_nth
        if not fire:
            return False
        log.warning("FAULT: degrading published snapshot #%d by x%g (%s)",
                    self.degrade_nth, self.degrade_factor, path)
        degrade_checkpoint(path, self.degrade_factor)
        return True


def _pandas_std(values: np.ndarray) -> float:
    """``Series.std()`` (ddof 1, NaN skipped) by pandas' two-pass
    formula, so the value's bits are pandas'."""
    v = values.astype(np.float64)
    mask = np.isnan(v)
    count = float(len(v) - mask.sum())
    d = count - 1.0
    if d <= 0:
        return float("nan")
    vals = np.where(mask, 0.0, v)
    avg = vals.sum(dtype=np.float64) / count
    sqr = (avg - vals) ** 2
    sqr[mask] = 0.0
    return float(np.sqrt(sqr.sum(dtype=np.float64) / d))


def _str_cells(values: np.ndarray) -> np.ndarray:
    """``Series.astype(str)`` of a raw column: a missing cell is
    ``"nan"``, as pandas writes it."""
    from fed_tgan_torch.data.csvio import cell_strings

    return np.array(["nan" if v is None else v
                     for v in cell_strings(values).tolist()], dtype=object)


def drift_frame(table: dict, shift: float, seed: int) -> dict:
    """A shard ``{column: values}`` drifted deterministically, schema
    kept (``fed_tgan_tpu/testing/faults.py:388-420``, with the same numpy
    calls, so the result equals JAX's on the same shard): a numeric column
    with more than 2 distinct values moves by ``shift`` standard
    deviations (1 when the std is 0), cast back to its dtype; any other
    column keeps its vocabulary, and each row flips to the next value of
    its sorted string vocabulary with probability ``min(0.8, 0.35 *
    |shift|)``, one ``default_rng(seed)`` draw a row per such column in
    column order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, col in table.items():
        col = np.asarray(col)
        present = col[~np.isnan(col)] if col.dtype.kind == "f" else col
        if col.dtype.kind in "iuf" and len(np.unique(present)) > 2:
            std = _pandas_std(col)
            out[name] = (col + shift * (std if std > 0 else 1.0)
                         ).astype(col.dtype)
            continue
        cells = _str_cells(col)
        vals = sorted(set(cells.tolist()))
        nxt = {v: vals[(i + 1) % len(vals)] for i, v in enumerate(vals)}
        flip = rng.random(len(col)) < min(0.8, 0.35 * abs(shift))
        drifted = cells.copy()
        if flip.any():
            drifted[flip] = [nxt[v] for v in drifted[flip].tolist()]
        if col.dtype.kind == "O":
            out[name] = drifted
        elif col.dtype.kind == "U":
            out[name] = np.asarray(drifted.tolist())
        else:  # as pandas' astype from strings: bool by truthiness
            out[name] = drifted.astype(col.dtype)
    return out


def degrade_checkpoint(path: str, factor: float) -> str:
    """Scale the generator's first linear weight in the sampling artifact
    at ``path`` by ``factor``, in place; returns the rewritten
    ``weights.npz``.

    It is the matrix the JAX package scales (the first 2-D float leaf of
    its ``arrays.npz``, the first dense kernel, ``fed_tgan_tpu/testing/
    faults.py:423``), in torch's ``(out, in)`` layout: the first residual
    block's ``fc.weight``, or ``out.weight`` without blocks.  No draw, no
    truncation: the artifact stays valid and loadable, with a new
    fingerprint."""
    npz = os.path.join(path, "weights.npz")
    with np.load(npz) as z:
        data = {k: z[k] for k in z.files}
    for key in ("generator.blocks.0.fc.weight", "generator.out.weight"):
        if key in data:
            arr = data[key]
            data[key] = (arr * factor).astype(arr.dtype)
            break
    else:
        raise ValueError(f"{npz}: no generator linear weight to degrade")
    with open(npz, "wb") as f:
        np.savez(f, **data)
        f.flush()
        os.fsync(f.fileno())
    return npz


def _need(spec: str, name: str, args: dict, keys, example: str) -> None:
    missing = [k for k in keys if k not in args]
    if missing:
        raise ValueError(f"{name} needs {' and '.join(missing)} in spec "
                         f"{spec!r} ({example})")


def _apply(plan: FaultPlan, name: str, args: dict, spec: str) -> None:
    """One parsed fault's arguments into ``plan`` (the JAX dispatch)."""
    if name == "kill_client":
        plan.kill_rank, plan.kill_round = args["rank"], args["round"]
    elif name == "delay_msg":
        plan.delay_ms = args["ms"]
    elif name == "sever_conn":
        plan.sever_rank, plan.sever_after = args["rank"], args["after"]
    elif name == "crash_checkpoint":
        plan.crash_save = args.get("save", 1)
    elif name == "corrupt_cache":
        plan.corrupt_cache_nth = int(args.get("nth", 1))
    elif name == "degrade_snapshot":
        _need(spec, name, args, ("factor",),
              "degrade_snapshot:100 or degrade_snapshot:factor=100")
        plan.degrade_factor = float(args["factor"])
        plan.degrade_nth = int(args.get("nth", 1))
    elif name == "join":
        if "round" not in args:  # JAX's wording: an unscheduled join
            raise ValueError(f"join needs a round in spec {spec!r} "
                             "(join:round=5 or join:round=5,count=2)")
        plan.joins.append((int(args["round"]),
                           max(1, int(args.get("count", 1)))))
    elif name == "leave":
        _need(spec, name, args, ("client", "round"), "leave:client=2,round=8")
        plan.leaves.append((int(args["round"]), int(args["client"])))
    elif name == "drift":
        _need(spec, name, args, ("client", "round"),
              "drift:client=1,round=10,shift=2.0")
        plan.drifts.append((int(args["round"]), int(args["client"]),
                            float(args.get("shift", 1.0))))
    elif name == "straggle":
        plan.straggle_rank = int(args["rank"])
        plan.straggle_delay = max(1, int(args.get("delay", 1)))
        plan.straggle_round = int(args.get("round", 1))
        plan.straggle_until = int(args.get("until", 0))
    else:  # nan_update | scale_update | stuck_update
        plan.update_kind = name.split("_", 1)[0]
        plan.update_rank = int(args.get("rank", 1))
        plan.update_factor = float(args.get("factor", 1.0))
        plan.update_round = int(args.get("round", 1))
        plan.update_until = int(args.get("until", 0))


def require_ported(plan: Optional[FaultPlan]) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of the first
    kind in ``plan`` the port does not act on yet."""
    for kind in getattr(plan, "kinds", ()):
        if kind in NOT_PORTED_KINDS:
            raise NotImplementedError(
                f"fault kind {kind!r} is not ported yet (ROADMAP "
                f"{NOT_PORTED_KINDS[kind]})")


def update_fault_window(
    plan: Optional[FaultPlan], e0: int, size: int
) -> tuple[Optional[tuple[str, int, float]], int]:
    """The update fault of a chunk of ``size`` rounds from the 0-based
    round ``e0``: ``(fault, clipped_size)``, ``fault = (kind, client_idx0,
    factor)`` when every round of the clipped chunk lies in the fault's
    window, else None; the chunk is clipped at the window's edges."""
    if plan is None or not plan.update_kind:
        return None, size
    active, size = _window(plan.update_round, plan.update_until, e0, size)
    fault = ((plan.update_kind, plan.update_rank - 1, plan.update_factor)
             if active else None)
    return fault, size


def straggle_window(
    plan: Optional[FaultPlan], e0: int, size: int
) -> tuple[Optional[tuple[int, int]], int]:
    """The straggler of a chunk of ``size`` rounds from the 0-based round
    ``e0`` (``fed_tgan_tpu/testing/faults.py:361-385``), by the window
    contract of :func:`update_fault_window`: ``(straggler,
    clipped_size)``, ``straggler = (client_idx0, delay_rounds)`` when every
    round of the clipped chunk lies in the straggle window, else None."""
    if plan is None or not plan.straggle_rank:
        return None, size
    active, size = _window(plan.straggle_round, plan.straggle_until, e0,
                           size)
    return ((plan.straggle_rank - 1, plan.straggle_delay) if active
            else None), size


def _window(first: int, until: int, e0: int, size: int) -> tuple[bool, int]:
    """Whether 0-based round ``e0`` lies in the 1-based window [first,
    until] (until 0: open-ended), and ``size`` clipped at the first edge
    inside the chunk, so the window never flips mid-chunk."""
    lo = first - 1
    hi = until - 1 if until else None
    for edge in sorted(x for x in (lo, (hi + 1) if hi is not None else None)
                       if x is not None and e0 < x < e0 + size):
        size = edge - e0
        break
    return e0 >= lo and (hi is None or e0 <= hi), size


_active: Optional[FaultPlan] = None
_env_checked = False


def install_plan(plan: Optional[FaultPlan]) -> None:
    """Install (or clear, with None) the process-wide plan; a plan with a
    kind the port does not act on is refused."""
    global _active, _env_checked
    require_ported(plan)
    _active = plan
    _env_checked = True  # an explicit install wins over the env var


def active_plan() -> Optional[FaultPlan]:
    """The process-wide plan: installed, or parsed from
    ``FED_TGAN_TORCH_FAULTS`` on first use."""
    global _active, _env_checked
    if not _env_checked:
        _env_checked = True
        spec = os.environ.get(ENV_VAR)
        if spec:
            plan = FaultPlan.parse(spec)
            require_ported(plan)
            _active = plan
            log.warning("fault injection active from %s=%r", ENV_VAR, spec)
    return _active
