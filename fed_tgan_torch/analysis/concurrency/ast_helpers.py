"""The AST helpers and type inventories the lockset model reads (copied
from ``fed_tgan_tpu/analysis/rules/base.py:42-60`` and
``fed_tgan_tpu/analysis/rules/shared_state.py:26-73``): what counts as a
lock, a thread-safe container and a mutator call.  Pure stdlib."""

from __future__ import annotations

import ast
from typing import Optional

_LOCK_TYPES = ("threading.Lock", "threading.RLock", "threading.Condition",
               "Lock", "RLock", "Condition")
_SAFE_TYPES = ("queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
               "queue.PriorityQueue", "Queue", "SimpleQueue",
               "collections.deque", "deque", "threading.Event", "Event",
               "threading.Semaphore", "threading.BoundedSemaphore")

_MUTATORS = {"append", "extend", "add", "insert", "pop", "popitem",
             "popleft", "remove", "discard", "clear", "update",
             "setdefault", "appendleft", "sort", "reverse"}


def dotted(node: ast.AST) -> Optional[str]:
    """Dotted-name form of a callee expression: ``a.b.c`` -> "a.b.c"; a
    call in the chain collapses to "()" (``self._fn(n)(x)`` -> the outer
    callee "self._fn()").  Unresolvable shapes yield None, except
    attribute access on a complex base, which keeps the attribute name
    alone."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        base = dotted(node.func)
        return f"{base}()" if base else None
    return None


def _imports_threading(tree) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "threading" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "threading":
                return True
    return False


def _self_attr(node) -> str:
    """'x' for ``self.x``, else ''."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and \
            node.value.id in ("self", "cls"):
        return node.attr
    return ""
