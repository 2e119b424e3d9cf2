"""J02 -- a draw without an explicit generator, or generators seeded
alike (counterpart of ``fed_tgan_tpu/analysis/rules/prng_reuse.py``).

JAX keys are splittable values, and the JAX rule catches one key consumed
twice.  Torch's generators are stateful, and the port's rule is that every
draw names its ``torch.Generator``: a draw from the global generator
depends on every draw before it anywhere in the process, so a run's
streams stop being functions of ``(seed, round, client)``.  Flagged:

* ``torch.rand``/``randn``/``randint``/``randperm``/``multinomial``/
  ``bernoulli``/``normal``/``poisson`` and the ``*_like`` draws,
  ``F.dropout`` (and ``nn.Dropout``, which draws from the global
  generator), and a device tensor's ``.uniform_()``/``.normal_()``/
  ``.bernoulli_()``/``.random_()``/``.exponential_()``/... without
  ``generator=``;
* the stateful counterparts of "one key consumed twice": a
  ``manual_seed(E)`` whose seed expression ``E`` another generator of the
  same function was already seeded with (two streams that are one), and a
  ``manual_seed(E)`` inside a loop where nothing in ``E`` changes from
  one iteration to the next (the same stream every iteration).

``torch.manual_seed`` (the global generator) is not a draw.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from fed_tgan_torch.analysis.rules.base import (
    assigned_names,
    dotted,
    names_in,
)

RULE_ID = "J02"
HINT = ("pass generator=<a torch.Generator seeded from (seed, stream, "
        "step)> to every draw, and derive distinct seeds per stream "
        "(step_seed(stream, step))")

_DRAW_FNS = re.compile(
    r"^(?:torch|torch\.nn\.functional|F|nn\.functional)\."
    r"(?:rand|randn|randint|randperm|multinomial|bernoulli|normal|poisson|"
    r"rand_like|randn_like|randint_like|dropout|dropout1d|dropout2d|"
    r"dropout3d|alpha_dropout|feature_alpha_dropout)$")
_DROPOUT_MODULES = re.compile(r"^(?:torch\.)?nn\.(?:Alpha)?Dropout\d?d?$")
_DRAW_METHODS = {"uniform_", "normal_", "bernoulli_", "random_",
                 "exponential_", "geometric_", "log_normal_", "cauchy_"}


def _draw(call: ast.Call):
    """A message when ``call`` draws from the global generator."""
    d = dotted(call.func) or ""
    has_gen = any(kw.arg == "generator" for kw in call.keywords)
    if _DRAW_FNS.match(d) and not has_gen:
        return f"{d}() draws from the global generator"
    if _DROPOUT_MODULES.match(d):
        return f"{d}() draws its masks from the global generator"
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in _DRAW_METHODS and not has_gen and \
            not d.startswith(("np.", "numpy.", "rng.")):
        return f".{call.func.attr}() draws from the global generator"
    return None


def _seed_expr(call: ast.Call):
    """``E`` of a generator's ``.manual_seed(E)`` (not the global one)."""
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr == "manual_seed" and call.args and \
            (dotted(call.func) or "") != "torch.manual_seed":
        return call.args[0]
    return None


def _scan_body(stmts, findings) -> None:
    """Seeds and loops of one function body (nested defs excluded)."""
    seeds: dict = {}  # ast.dump(E) -> line of its first manual_seed

    def visit(node, loop_names):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            inner = set(loop_names or set()) | assigned_names(node.body)
            if isinstance(node, (ast.For, ast.AsyncFor)):
                inner |= names_in(node.target)
                visit(node.iter, loop_names)
            else:
                visit(node.test, inner)
            for child in node.body + node.orelse:
                visit(child, inner)
            return
        if isinstance(node, ast.Call):
            msg = _draw(node)
            if msg:
                findings.setdefault(node.lineno, msg)
            expr = _seed_expr(node)
            if expr is not None:
                key = ast.dump(expr)
                if loop_names is not None and \
                        not names_in(expr) & loop_names:
                    findings.setdefault(
                        node.lineno, "manual_seed() gives the generator "
                        "the same seed every loop iteration: the same "
                        "stream each time")
                elif key in seeds and seeds[key] != node.lineno and \
                        loop_names is None:
                    findings.setdefault(
                        node.lineno, "a second generator seeded with the "
                        f"seed of line {seeds[key]}: the two streams are "
                        "one")
                seeds.setdefault(key, node.lineno)
        for child in ast.iter_child_nodes(node):
            visit(child, loop_names)

    for stmt in stmts:
        visit(stmt, None)


class PrngReuseRule:
    rule_id = RULE_ID
    title = "draw without a generator / generators seeded alike"
    hint = HINT

    def check(self, mod) -> Iterator:
        findings: dict = {}
        _scan_body(mod.tree.body, findings)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _scan_body(node.body, findings)
        for line in sorted(findings):
            yield (self.rule_id, line, findings[line], self.hint)
