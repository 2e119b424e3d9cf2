"""Interprocedural lockset model backing the L01-L04 rules (copied from
``fed_tgan_tpu/analysis/concurrency/model.py``).

Pure stdlib AST -- no torch import, millisecond startup.  The unit of analysis is the class: locks are
``self.<attr>`` objects, the call graph is ``self.<method>()`` edges,
and locksets are sets of lock attribute names.  Cross-class lock flow
(e.g. a ``FleetService`` handing its lock to a ``RowPool``) is out of
scope; within a class the model is path-insensitive but call-graph
aware:

1. **Inventory** -- one walk over the class collects lock attributes
   (``threading.Lock/RLock/Condition``), which of those are reentrant,
   thread-safe containers (``queue.Queue`` family, ``deque``,
   ``Event``/``Semaphore``) and thread handles.
2. **Lexical scan** -- each method body is walked with the lexically
   held lockset threaded through ``with self._lock:`` blocks and bare
   ``.acquire()``/``.release()`` statements, recording every lock
   acquisition, shared-field access, ``self.<method>()`` call site and
   known-blocking call together with the lockset at that point.
3. **Propagation** -- a fixed point over the intra-class call graph
   computes each method's *entry* locksets: ``entry_must`` is the
   intersection over internal call sites of (caller must + lexical at
   the site) -- public methods and never-internally-called ones start
   at the empty set because outside callers hold nothing; ``entry_may``
   is the union over call sites.  ``must`` keeps L01 quiet on
   ``_locked``-suffix-style helpers; ``may`` lets L02/L03 flag hazards
   that exist on *some* call path.

Guard inference for L01: a field's guard set is every lock observed
held (must + lexical) at some non-atomic mutation of it.  Plain
rebinds (``self.x = v``) stay atomic under the GIL and never establish
nor violate a guard, which keeps the immutable-swap pattern (build a
fresh dict, publish by rebind, read without the lock) clean.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from fed_tgan_torch.analysis.concurrency.ast_helpers import (
    _LOCK_TYPES,
    _MUTATORS,
    _SAFE_TYPES,
    _imports_threading,
    _self_attr,
    dotted,
)

_RLOCK_TYPES = ("threading.RLock", "RLock",
                "threading.Condition", "Condition")
_CONDITION_TYPES = ("threading.Condition", "Condition")
_QUEUE_TYPES = ("queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
                "queue.PriorityQueue", "Queue", "SimpleQueue", "LifoQueue",
                "PriorityQueue")
_THREAD_TYPES = ("threading.Thread", "threading.Timer", "Thread", "Timer")

#: Non-mutating container-method reads that are still compound (value
#: can be torn mid-resize by a concurrent mutator).
_READER_METHODS = {"get", "items", "keys", "values", "copy"}

#: ``.attr(`` calls that block regardless of receiver type.
_BLOCKING_ATTRS = {"recv", "recvfrom", "accept", "sendall", "connect",
                   "getresponse", "get_or_build"}

#: Methods that run before (or after) any peer thread can observe the
#: object -- their accesses neither establish guards nor violate them.
_SINGLE_THREADED_METHODS = {"__init__", "__del__", "__repr__"}


@dataclass
class Access:
    field: str
    line: int
    kind: str          # "mutate" | "read"
    what: str          # human description, e.g. "item write", ".append()"
    lockset: FrozenSet[str]


@dataclass
class Acquire:
    lock: str
    line: int
    lockset: FrozenSet[str]   # lexically held just before this acquisition
    raw: bool                 # bare .acquire() call, not a with-statement
    protected: bool           # raw acquire with a try/finally release
    nonblocking: bool         # acquire(False) / acquire(blocking=False)


@dataclass
class CallSite:
    callee: str
    line: int
    lockset: FrozenSet[str]


@dataclass
class BlockingCall:
    desc: str
    line: int
    lockset: FrozenSet[str]


@dataclass
class Method:
    name: str
    line: int
    accesses: List[Access] = field(default_factory=list)
    acquires: List[Acquire] = field(default_factory=list)
    calls: List[CallSite] = field(default_factory=list)
    blocking: List[BlockingCall] = field(default_factory=list)
    entry_must: FrozenSet[str] = frozenset()
    entry_may: FrozenSet[str] = frozenset()


@dataclass
class ClassModel:
    name: str
    line: int
    locks: Set[str] = field(default_factory=set)
    rlocks: Set[str] = field(default_factory=set)      # reentrant subset
    conditions: Set[str] = field(default_factory=set)  # Condition subset
    safe: Set[str] = field(default_factory=set)
    queues: Set[str] = field(default_factory=set)
    threads: Set[str] = field(default_factory=set)
    methods: Dict[str, Method] = field(default_factory=dict)
    #: field name -> locks observed held at some non-atomic mutation
    guards: Dict[str, Set[str]] = field(default_factory=dict)


@dataclass
class ModuleModel:
    classes: List[ClassModel] = field(default_factory=list)


# ------------------------------------------------------------------ scan

def _call_nonblocking(call: ast.Call) -> bool:
    """acquire(False) / acquire(blocking=False) / get(block=False) /
    get(timeout=0) -- variants that cannot block indefinitely... or at
    all, for the blocking=False family."""
    if call.args:
        a0 = call.args[0]
        if isinstance(a0, ast.Constant) and a0.value in (False, 0):
            return True
    for kw in call.keywords:
        if kw.arg in ("blocking", "block") and \
                isinstance(kw.value, ast.Constant) and \
                kw.value.value in (False, 0):
            return True
        if kw.arg == "timeout" and isinstance(kw.value, ast.Constant) and \
                kw.value.value == 0:
            return True
    return False


class _ClassScanner:
    """Builds one ClassModel: inventory, then per-method lexical scan."""

    def __init__(self, cls: ast.ClassDef):
        self.cls = cls
        self.model = ClassModel(name=cls.name, line=cls.lineno)
        self._inventory()
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                m = Method(name=item.name, line=item.lineno)
                # first def wins on duplicates (e.g. @property pairs)
                self.model.methods.setdefault(item.name, m)
                if self.model.methods[item.name] is m:
                    self._scan_block(item.body, frozenset(), m, frozenset())
        self._infer_guards()

    # -------------------------------------------------------- inventory

    def _inventory(self) -> None:
        mdl = self.model
        for node in ast.walk(self.cls):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            d = dotted(node.value.func) or ""
            for t in node.targets:
                attr = _self_attr(t)
                if not attr:
                    continue
                if d in _LOCK_TYPES:
                    mdl.locks.add(attr)
                    if d in _RLOCK_TYPES:
                        mdl.rlocks.add(attr)
                    if d in _CONDITION_TYPES:
                        mdl.conditions.add(attr)
                elif d in _SAFE_TYPES:
                    mdl.safe.add(attr)
                    if d in _QUEUE_TYPES:
                        mdl.queues.add(attr)
                elif d in _THREAD_TYPES:
                    mdl.threads.add(attr)

    # ----------------------------------------------------- lexical scan

    def _with_locks(self, withstmt) -> List[str]:
        out = []
        for item in withstmt.items:
            expr = item.context_expr
            attr = _self_attr(expr)
            if attr in self.model.locks:
                out.append(attr)
        return out

    def _raw_lock_call(self, s: ast.stmt, op: str
                       ) -> Optional[Tuple[str, ast.Call]]:
        """(lock_attr, call) when ``s`` is ``self.<lock>.<op>(...)`` as a
        bare Expr or single-target Assign statement."""
        if isinstance(s, ast.Expr):
            call = s.value
        elif isinstance(s, ast.Assign) and len(s.targets) == 1:
            call = s.value
        else:
            return None
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == op):
            return None
        attr = _self_attr(call.func.value)
        if attr in self.model.locks:
            return attr, call
        return None

    def _releases_in(self, stmts) -> Set[str]:
        out: Set[str] = set()
        for s in stmts:
            for node in ast.walk(s):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "release":
                    attr = _self_attr(node.func.value)
                    if attr in self.model.locks:
                        out.add(attr)
        return out

    def _scan_block(self, stmts, lockset: FrozenSet[str], m: Method,
                    finally_released: FrozenSet[str]) -> None:
        held = set(lockset)
        for idx, s in enumerate(stmts):
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(s, (ast.With, ast.AsyncWith)):
                acquired: List[str] = []
                for item in s.items:
                    attr = _self_attr(item.context_expr)
                    if attr in self.model.locks:
                        m.acquires.append(Acquire(
                            lock=attr, line=item.context_expr.lineno,
                            lockset=frozenset(held) | frozenset(acquired),
                            raw=False, protected=True, nonblocking=False))
                        acquired.append(attr)
                    else:
                        self._scan_exprs([item.context_expr],
                                         frozenset(held), m)
                self._scan_block(s.body, frozenset(held) | set(acquired),
                                 m, finally_released)
                continue
            raw_acq = self._raw_lock_call(s, "acquire")
            if raw_acq is not None:
                lock, call = raw_acq
                nonblocking = _call_nonblocking(call)
                protected = lock in finally_released
                if not protected and idx + 1 < len(stmts) and \
                        isinstance(stmts[idx + 1], ast.Try):
                    protected = lock in self._releases_in(
                        stmts[idx + 1].finalbody)
                m.acquires.append(Acquire(
                    lock=lock, line=s.lineno, lockset=frozenset(held),
                    raw=True, protected=protected, nonblocking=nonblocking))
                if not nonblocking:
                    held.add(lock)
                continue
            raw_rel = self._raw_lock_call(s, "release")
            if raw_rel is not None:
                held.discard(raw_rel[0])
                continue
            self._scan_stmt(s, frozenset(held), m)
            if isinstance(s, ast.Try):
                fr = frozenset(finally_released
                               | self._releases_in(s.finalbody))
                self._scan_block(s.body, frozenset(held), m, fr)
                for h in s.handlers:
                    self._scan_block(h.body, frozenset(held), m, fr)
                self._scan_block(s.orelse, frozenset(held), m, fr)
                self._scan_block(s.finalbody, frozenset(held), m,
                                 finally_released)
            else:
                for attr in ("body", "orelse"):
                    sub = getattr(s, attr, None)
                    if isinstance(sub, list) and sub and \
                            isinstance(sub[0], ast.stmt):
                        self._scan_block(sub, frozenset(held), m,
                                         finally_released)

    def _header_exprs(self, s: ast.stmt) -> Optional[List[ast.expr]]:
        """The expressions evaluated by a compound statement's header
        (its blocks are scanned separately); None for simple statements
        whose whole subtree is expression territory."""
        if isinstance(s, (ast.If, ast.While)):
            return [s.test]
        if isinstance(s, (ast.For, ast.AsyncFor)):
            return [s.target, s.iter]
        if isinstance(s, ast.Try):
            return []
        return None

    def _scan_stmt(self, s: ast.stmt, lockset: FrozenSet[str],
                   m: Method) -> None:
        header = self._header_exprs(s)
        if header is None:
            # simple statement: targets first (mutation kinds), then the
            # full expression walk
            if isinstance(s, ast.Assign):
                for t in s.targets:
                    self._scan_target(t, lockset, m)
            elif isinstance(s, ast.AugAssign):
                t = s.target
                f = _self_attr(t) or (_self_attr(t.value)
                                      if isinstance(t, ast.Subscript) else "")
                if self._is_field(f):
                    m.accesses.append(Access(
                        field=f, line=s.lineno, kind="mutate",
                        what="read-modify-write", lockset=lockset))
            elif isinstance(s, ast.Delete):
                for t in s.targets:
                    if isinstance(t, ast.Subscript):
                        f = _self_attr(t.value)
                        if self._is_field(f):
                            m.accesses.append(Access(
                                field=f, line=s.lineno, kind="mutate",
                                what="del", lockset=lockset))
            self._scan_exprs([s], lockset, m)
        else:
            if isinstance(s, (ast.For, ast.AsyncFor)):
                f = _self_attr(s.iter)
                if self._is_field(f):
                    m.accesses.append(Access(
                        field=f, line=s.iter.lineno, kind="read",
                        what="iteration", lockset=lockset))
            self._scan_exprs(header, lockset, m)

    def _scan_target(self, t, lockset: FrozenSet[str], m: Method) -> None:
        if isinstance(t, ast.Subscript):
            f = _self_attr(t.value)
            if self._is_field(f):
                m.accesses.append(Access(
                    field=f, line=t.lineno, kind="mutate",
                    what="item write", lockset=lockset))
        elif isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                self._scan_target(elt, lockset, m)

    def _is_field(self, attr: str) -> bool:
        return bool(attr) and attr not in self.model.locks \
            and attr not in self.model.safe \
            and attr not in self.model.threads

    def _scan_exprs(self, roots, lockset: FrozenSet[str],
                    m: Method) -> None:
        mdl = self.model
        for root in roots:
            for node in ast.walk(root):
                if isinstance(node, ast.Subscript) and \
                        isinstance(node.ctx, ast.Load):
                    f = _self_attr(node.value)
                    if self._is_field(f):
                        m.accesses.append(Access(
                            field=f, line=node.lineno, kind="read",
                            what="subscript read", lockset=lockset))
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if isinstance(func, ast.Attribute):
                    attr = func.attr
                    recv = _self_attr(func.value)
                    if recv in mdl.locks and attr in ("acquire", "release",
                                                      "locked", "notify",
                                                      "notify_all"):
                        continue
                    # self.<method>() call sites feed the call graph
                    if isinstance(func.value, ast.Name) and \
                            func.value.id in ("self", "cls"):
                        if attr in {i.name for i in self.cls.body
                                    if isinstance(i, (ast.FunctionDef,
                                                      ast.AsyncFunctionDef))}:
                            m.calls.append(CallSite(
                                callee=attr, line=node.lineno,
                                lockset=lockset))
                    self._scan_blocking(node, func, attr, recv, lockset, m)
                    if recv and self._is_field(recv):
                        if attr in _MUTATORS:
                            m.accesses.append(Access(
                                field=recv, line=node.lineno, kind="mutate",
                                what=f".{attr}()", lockset=lockset))
                        elif attr in _READER_METHODS:
                            m.accesses.append(Access(
                                field=recv, line=node.lineno, kind="read",
                                what=f".{attr}()", lockset=lockset))
                else:
                    self._scan_blocking(node, func, "", "", lockset, m)

    def _scan_blocking(self, call: ast.Call, func, attr: str, recv: str,
                       lockset: FrozenSet[str], m: Method) -> None:
        mdl = self.model
        desc = ""
        if attr in ("wait", "wait_for"):
            # Condition.wait on the condition you hold releases it while
            # waiting -- that is the correct pattern, not a blocking call
            if recv in mdl.conditions and recv in lockset:
                return
            desc = f"`.{attr}()`"
        elif attr == "join":
            if recv in mdl.threads or recv in mdl.queues:
                desc = f"`self.{recv}.join()`"
        elif attr in ("get", "put"):
            if recv in mdl.queues and not _call_nonblocking(call):
                desc = f"queue `self.{recv}.{attr}()`"
        elif attr in _BLOCKING_ATTRS:
            desc = f"`.{attr}()`"
        if not desc:
            d = dotted(func) or ""
            if d in ("time.sleep", "sleep"):
                desc = "`time.sleep()`"
            elif d.startswith("subprocess."):
                desc = f"`{d}()`"
            elif d in ("socket.create_connection",):
                desc = f"`{d}()`"
            elif d.endswith("urlopen"):
                desc = f"`{d}()`"
        if desc:
            m.blocking.append(BlockingCall(desc=desc, line=call.lineno,
                                           lockset=lockset))

    # ------------------------------------------------------ propagation

    def _infer_guards(self) -> None:
        """Fixed-point entry locksets, then per-field guard sets."""
        mdl = self.model
        methods = mdl.methods
        all_locks = frozenset(mdl.locks)
        internally_called = {c.callee for m in methods.values()
                            for c in m.calls if c.callee in methods}
        for m in methods.values():
            m.entry_may = frozenset()
            public = not m.name.startswith("_") or \
                (m.name.startswith("__") and m.name.endswith("__"))
            if public or m.name not in internally_called:
                m.entry_must = frozenset()
            else:
                m.entry_must = all_locks  # top; shrinks monotonically
        changed = True
        while changed:
            changed = False
            for caller in methods.values():
                for site in caller.calls:
                    callee = methods.get(site.callee)
                    if callee is None or callee is caller:
                        continue
                    may = caller.entry_may | site.lockset
                    if not may <= callee.entry_may:
                        callee.entry_may = callee.entry_may | may
                        changed = True
                    must = callee.entry_must & (caller.entry_must
                                                | site.lockset)
                    if must != callee.entry_must:
                        callee.entry_must = must
                        changed = True
        for m in methods.values():
            if m.name in _SINGLE_THREADED_METHODS:
                continue
            for acc in m.accesses:
                if acc.kind != "mutate":
                    continue
                eff = m.entry_must | acc.lockset
                held = eff & all_locks
                if held:
                    mdl.guards.setdefault(acc.field, set()).update(held)


# ----------------------------------------------------------------- entry

def _scoped(mod) -> bool:
    in_serve = "/serve/" in mod.relpath.replace("\\", "/")
    return in_serve or _imports_threading(mod.tree)


_CACHE: Dict[Tuple[str, int, int], ModuleModel] = {}


def analyze(mod) -> ModuleModel:
    """ModuleModel for a ``lint.ModuleInfo`` (memoized: the four L rules
    each call this per module)."""
    key = (mod.relpath, len(mod.source), hash(mod.source))
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    model = ModuleModel()
    if _scoped(mod):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                model.classes.append(_ClassScanner(node).model)
    if len(_CACHE) > 128:
        _CACHE.clear()
    _CACHE[key] = model
    return model


def iter_methods(model: ModuleModel
                 ) -> Iterator[Tuple[ClassModel, Method]]:
    for cls in model.classes:
        for name in sorted(cls.methods):
            yield cls, cls.methods[name]
