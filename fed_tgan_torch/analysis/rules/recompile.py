"""J03 -- rebuild hazards and value branches in hot code (counterpart of
``fed_tgan_tpu/analysis/rules/recompile.py``).

JAX's J03 flags ``jax.jit`` inside a loop (a compile per iteration) and a
Python branch on a traced value (a retrace per value).  Their torch
counterparts:

* a build inside a ``for``/``while`` body: ``built_once(...)`` applied,
  a kernel build (``.build()``, ``load_inline``,
  ``cpp_extension.load``), ``torch.compile``, ``torch.jit.script``/
  ``trace``, or a CUDA graph capture (``torch.cuda.graph``,
  ``CUDAGraph``, ``make_graphed_callables``) -- a fresh build (and cache
  entry) per iteration; hoist it or cache it by its static key;
* a Python ``if``/``while``/conditional expression on a device tensor's
  value in a hot loop or a function called from one: an implicit
  ``bool()`` that syncs the host every iteration (and breaks a graph
  capture); use ``torch.where`` or decide on the host from the chunk's
  one copy.  ``is None``/``isinstance``/shape tests read no value.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from fed_tgan_torch.analysis.rules.base import dotted, scan

RULE_ID = "J03"
HINT = ("hoist builds and captures out of loops (cache them by their "
        "static key with built_once); branch on device values with "
        "torch.where, or on the host after the one batched copy")

_BUILD_RE = re.compile(
    r"(?:^|\.)(?:built_once|build|load_inline|make_graphed_callables|"
    r"CUDAGraph)$|^torch\.(?:compile|jit\.script|jit\.trace|cuda\.graph)$"
    r"|(?:^|\.)cpp_extension\.load$|^triton\.jit$")


def _builds_in_loops(tree):
    out = []

    def visit(node, in_loop):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                visit(child, False)
            return
        if isinstance(node, ast.Call) and in_loop:
            d = dotted(node.func) or ""
            if _BUILD_RE.search(d):
                out.append((node.lineno, f"{d}() inside a loop builds "
                                         "afresh every iteration"))
        loop = isinstance(node, (ast.For, ast.AsyncFor, ast.While))
        for child in ast.iter_child_nodes(node):
            head = loop and child in (getattr(node, "iter", None),
                                      getattr(node, "test", None))
            visit(child, in_loop if head else (in_loop or loop))

    for stmt in tree.body:
        visit(stmt, False)
    return out


class RecompileRule:
    rule_id = RULE_ID
    title = "rebuild hazard / value branch in hot code"
    hint = HINT

    def check(self, mod) -> Iterator:
        findings: dict = {}
        for line, message in _builds_in_loops(mod.tree):
            findings.setdefault(line, message)
        for line, message in scan(mod).branches:
            findings.setdefault(line, message)
        for line in sorted(findings):
            yield (self.rule_id, line, findings[line], self.hint)
