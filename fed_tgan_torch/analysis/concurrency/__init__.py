"""locklint -- concurrency-correctness analysis for the threaded plane
(counterpart of ``fed_tgan_tpu/analysis/concurrency/``).

Two prongs:

* **Static** (this package): a pure-stdlib AST pass over the serving /
  observability modules.  ``model.py`` builds a per-class inventory of
  lock objects and shared mutable fields, scans every method for lock
  acquisitions, field accesses, self-method calls and blocking calls
  with their *lexical* locksets, then propagates locksets through the
  intra-class call graph (a fixed point) to a per-method *entry
  lockset* -- ``must`` (held on every internal path, used to avoid false
  positives) and ``may`` (held on some path, used to catch any-path
  hazards).  ``rules.py`` turns the model into the L01-L04 findings
  wired through ``analysis/lint.py`` (``path:rule:line`` keys,
  ``# torchlint: disable=LXX`` inline escapes, the ``baseline.json``
  ratchet).

* **Runtime** (``analysis/lockwatch.py``, a sibling module): opt-in
  instrumented lock wrappers that record per-thread acquisition order
  into a global graph and report potential deadlocks while tests and
  the fleet run.

Rules:

* **L01** unguarded-shared-field-access -- a non-atomic mutation (or a
  compound read) of a field that is guarded by a lock elsewhere,
  reached on a path whose must-lockset misses that guard: a private
  ``_shed``-style helper only ever called under the lock inherits the
  caller's lockset instead of being flagged.
* **L02** lock-order-cycle -- the acquisition graph (edge A->B when B
  is acquired while A may be held, including through calls) contains a
  cycle, or a non-reentrant lock is re-acquired on a path that may
  already hold it (the fleet's ``submit`` -> ``_shed`` deadlock shape).
* **L03** blocking-call-under-lock -- ``queue.get``/``Event.wait``/
  ``subprocess``/socket I/O/``ProgramCache.get_or_build`` reached
  while any lock may be held.
* **L04** lock-leak -- a bare ``.acquire()`` not paired with a
  ``with`` block or a ``try/finally`` release.
"""

from fed_tgan_torch.analysis.concurrency.model import analyze  # noqa: F401
from fed_tgan_torch.analysis.concurrency.rules import (  # noqa: F401
    BlockingUnderLockRule,
    LockLeakRule,
    LockOrderRule,
    UnguardedFieldRule,
)

__all__ = ["analyze", "UnguardedFieldRule", "LockOrderRule",
           "BlockingUnderLockRule", "LockLeakRule"]
