"""locklint rules L01-L04 over the interprocedural lockset model
(copied from ``fed_tgan_tpu/analysis/concurrency/rules.py``).

Each rule has ``rule_id`` / ``title`` / ``hint`` / ``check(mod)`` and
plugs into :mod:`fed_tgan_torch.analysis.lint`: ``path:rule:line``
finding keys, ``# torchlint: disable=LXX`` escapes, the baseline
ratchet.  All four share one memoized :func:`model.analyze` pass.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Set, Tuple

from fed_tgan_torch.analysis.concurrency.model import (
    _SINGLE_THREADED_METHODS,
    ClassModel,
    Method,
    analyze,
)

#: Read shapes L01 flags on guarded fields.  Scalar loads, subscript
#: reads and ``.get()`` are single bytecode-level dict/list ops -- atomic
#: under the GIL -- so only *iterating* reads (which a concurrent
#: mutation tears with "dict changed size during iteration" or a torn
#: view) count as compound.
_COMPOUND_READS = ("iteration", ".items()", ".keys()", ".values()")


def _sorted_methods(cls: ClassModel) -> List[Method]:
    return [cls.methods[k] for k in sorted(cls.methods)]


class UnguardedFieldRule:
    """L01 -- shared-field access without the lock that guards it.

    Interprocedural lockset check: a method's
    *entry must-lockset* (held on every internal call path) counts
    toward the guard, so a private helper only ever called under the
    lock is clean.  Two shapes:

    * a non-atomic mutation (item write / del / ``+=`` / mutator call)
      whose effective lockset misses the field's inferred guard set --
      or, for never-guarded fields, any such mutation with no lock at
      all;
    * a compound read (iteration, ``.items()``/``.keys()``/
      ``.values()``) of a field that *is* mutation-guarded elsewhere,
      reached without that guard.
    """

    rule_id = "L01"
    title = "unguarded shared field access"
    hint = ("hold the field's guard lock (`with self._lock:`) at this "
            "access, or switch the field to a thread-safe structure / "
            "immutable-swap (publish a fresh object by rebind)")

    def check(self, mod) -> Iterator:
        for cls in analyze(mod).classes:
            for m in _sorted_methods(cls):
                if m.name in _SINGLE_THREADED_METHODS:
                    continue
                for acc in m.accesses:
                    guards = cls.guards.get(acc.field, set())
                    eff = m.entry_must | acc.lockset
                    if acc.kind == "mutate":
                        if guards:
                            if eff & guards:
                                continue
                            lock = "/".join(
                                f"self.{g}" for g in sorted(guards))
                            yield (self.rule_id, acc.line,
                                   f"{acc.what} on `self.{acc.field}` "
                                   f"without its guard `{lock}` "
                                   f"(held at other mutation sites) "
                                   f"[{cls.name}.{m.name}]", self.hint)
                        elif not eff:
                            yield (self.rule_id, acc.line,
                                   f"{acc.what} on shared "
                                   f"`self.{acc.field}` without any lock "
                                   f"[{cls.name}.{m.name}]", self.hint)
                    elif acc.what in _COMPOUND_READS and guards \
                            and not (eff & guards):
                        lock = "/".join(f"self.{g}" for g in sorted(guards))
                        yield (self.rule_id, acc.line,
                               f"compound read ({acc.what}) of guarded "
                               f"`self.{acc.field}` without `{lock}` "
                               f"[{cls.name}.{m.name}]", self.hint)


class LockOrderRule:
    """L02 -- lock-order cycles and non-reentrant re-acquisition.

    Builds the per-class acquisition graph: an edge A->B every time B
    is acquired while A *may* be held (entry may-lockset + lexical,
    i.e. including locks inherited through ``self.<method>()`` call
    chains).  Any cycle is a potential cross-thread deadlock; acquiring
    a non-reentrant lock that may already be held on the path (the
    fleet's ``submit`` holding ``_adm_lock`` -> ``_shed`` re-acquire) is a
    single-thread deadlock and is flagged at the acquisition site.
    """

    rule_id = "L02"
    title = "lock-order cycle / re-acquisition"
    hint = ("release the outer lock before this acquisition (hoist the "
            "call out of the `with` block), or impose one global "
            "acquisition order; use RLock only when re-entry is the "
            "designed behaviour")

    def check(self, mod) -> Iterator:
        for cls in analyze(mod).classes:
            yield from self._check_class(cls)

    def _check_class(self, cls: ClassModel) -> Iterator:
        edges: Dict[Tuple[str, str], Tuple[int, str]] = {}
        for m in _sorted_methods(cls):
            for acq in m.acquires:
                may = m.entry_may | acq.lockset
                if acq.lock in may and acq.lock not in cls.rlocks:
                    yield (self.rule_id, acq.line,
                           f"`self.{acq.lock}` re-acquired while a call "
                           f"path into `{cls.name}.{m.name}` already "
                           f"holds it (non-reentrant Lock: deadlock)",
                           self.hint)
                for outer in sorted(may):
                    if outer != acq.lock:
                        edges.setdefault(
                            (outer, acq.lock),
                            (acq.line, f"{cls.name}.{m.name}"))
        for cyc_edges in self._cyclic_edges(edges):
            for (a, b), (line, where) in cyc_edges:
                order = " -> ".join(sorted({a, b} | {
                    x for e, _ in cyc_edges for x in e}))
                yield (self.rule_id, line,
                       f"lock-order cycle: `self.{b}` acquired under "
                       f"`self.{a}` in `{where}` while the reverse "
                       f"order exists elsewhere (cycle over {order})",
                       self.hint)

    def _cyclic_edges(self, edges: Dict[Tuple[str, str], Tuple[int, str]]
                      ) -> List[List[Tuple[Tuple[str, str],
                                           Tuple[int, str]]]]:
        """Edges whose endpoints share a strongly connected component of
        size >= 2, grouped per component (Tarjan, iterative)."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        sccs: List[Set[str]] = []
        counter = [0]

        def strongconnect(root: str) -> None:
            work = [(root, iter(adj[root]))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(adj[w])))
                        advanced = True
                        break
                    if w in on_stack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    comp: Set[str] = set()
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.add(w)
                        if w == v:
                            break
                    if len(comp) >= 2:
                        sccs.append(comp)

        for node in sorted(adj):
            if node not in index:
                strongconnect(node)
        out = []
        for comp in sccs:
            comp_edges = sorted(
                (e, site) for e, site in edges.items()
                if e[0] in comp and e[1] in comp)
            if comp_edges:
                out.append(comp_edges)
        return out


class BlockingUnderLockRule:
    """L03 -- blocking call reached while a lock may be held.

    ``queue.get``/``put``, ``Event.wait``, thread ``join``,
    ``time.sleep``, ``subprocess``, socket/HTTP I/O and the
    ``ProgramCache.get_or_build`` compile path all stall every other
    thread contending for the held lock (the discipline the serving
    plane enforces by hand: sample outside the lock, build outside the
    lock, shed outside the lock).  ``Condition.wait`` on the condition
    you hold is the designed pattern and is exempt.
    """

    rule_id = "L03"
    title = "blocking call under lock"
    hint = ("move the blocking call outside the `with` block: snapshot "
            "the state you need under the lock, drop it, then block "
            "(see ProgramCache.get_or_build / RowPool._fill_chunk)")

    def check(self, mod) -> Iterator:
        for cls in analyze(mod).classes:
            for m in _sorted_methods(cls):
                if m.name in _SINGLE_THREADED_METHODS:
                    continue
                for b in m.blocking:
                    may = m.entry_may | b.lockset
                    if may:
                        locks = "/".join(f"self.{x}" for x in sorted(may))
                        yield (self.rule_id, b.line,
                               f"{b.desc} may run while holding "
                               f"`{locks}` [{cls.name}.{m.name}]",
                               self.hint)


class LockLeakRule:
    """L04 -- bare ``.acquire()`` without ``with`` or ``try/finally``.

    An exception between the acquire and the release leaks the lock and
    wedges every other thread.  Non-blocking probes
    (``acquire(False)``) are exempt -- their result is branched on, not
    held unconditionally.
    """

    rule_id = "L04"
    title = "lock acquire without release protection"
    hint = ("use `with self._lock:` (or wrap the acquire in "
            "`try: ... finally: self._lock.release()`)")

    def check(self, mod) -> Iterator:
        for cls in analyze(mod).classes:
            for m in _sorted_methods(cls):
                for acq in m.acquires:
                    if acq.raw and not acq.protected \
                            and not acq.nonblocking:
                        yield (self.rule_id, acq.line,
                               f"`self.{acq.lock}.acquire()` without a "
                               f"`with` block or try/finally release "
                               f"[{cls.name}.{m.name}]", self.hint)
