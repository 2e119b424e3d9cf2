"""obslint extraction: every telemetry contract surface, statically
(counterpart of ``fed_tgan_tpu/analysis/telemetry/extract.py``).

Pure stdlib + AST (importing this never imports torch).  One walk over
the package collects the four surfaces
the O01-O05 rules cross-check against ``obs/schema.json``:

- **emit sites** -- every ``emit("type", field=...)`` call, threading
  through the ``from fed_tgan_torch.obs.journal import emit as _emit_event``
  aliases used across ``train/``, ``serve/``, ``runtime/``,
  ``federation/`` and ``analysis/sanitizers.py``, plus ``journal.emit(...)``
  attribute calls, the event-keeping wrappers (``self._event("type",
  ...)``, ``self._emit({"type": "...", ...})``)
  and the raw ``{"ts": ..., "type": "..."}`` dict-literal append in
  ``obs/watch.py``.  ``**{...literal...}`` splats contribute their
  constant keys; any other splat marks the site *open* (it may attach
  fields the AST cannot see).
- **metric sites** -- every ``counter/gauge/histogram`` get-or-create
  call (by registry import alias or terminal attribute), recording the
  static name (or f-string prefix), kind, label keys (one assignment hop
  is resolved), and which label values look unbounded -- ``str(x)`` or
  an f-string of a variable with no ``*_CAP`` guard in the enclosing
  function, the cardinality hazard O03 flags.  The 64-label client-cap
  idiom in ``train/federated.py`` is the exempt pattern.
- **consumer reads** -- which event fields ``obs/report.py`` /
  ``slo.py`` / ``watch.py`` actually read, via the two consumer idioms:
  (A) ``rounds = [e for e in events if e.get("type") == "round"]``
  followed by iteration/``next()`` reads (one call-threading hop into
  module-local helpers like ``_clients_section``), and
  (B) ``kind = ev.get("type")`` + ``if kind == "...":`` branch-scoped
  reads (the ``journal_figures`` / ``_WatchState.fold`` shape).
- **figure + bench-metric producers** -- the figure keys/prefixes
  ``journal_figures`` can fold and the ``"metric"`` literals bench
  record writers stamp, which O04 checks budget selectors against.

Fault-spec references (O05) come from a text scan over the port's
tests, ``chip_smoke.py`` and the repo's documents for ``kind:key=value`` shaped strings whose key set overlaps
the fault-arg vocabulary; ``testing/faults.py``'s ``VALID_KINDS`` tuple
is read from its AST, never imported.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from fed_tgan_torch.analysis.lint import (
    ModuleInfo,
    PKG_ROOT,
    REPO_ROOT,
    iter_py_files,
    parse_module,
)

__all__ = [
    "BenchMetric",
    "ConsumerFilter",
    "ConsumerRead",
    "EmitSite",
    "Extraction",
    "FaultRef",
    "FigureKey",
    "MetricSite",
    "extract_repo",
]

REGISTRY_FUNCS = ("counter", "gauge", "histogram")

#: ``.attr(`` calls that journal their first argument: the journal's own
#: ``emit``, and the port's event-keeping wrappers (``self._event("type",
#: **fields)``, ``self._emit({"type": ..., ...})``)
EMIT_METHODS = ("emit", "_emit", "_event")

#: argument-key vocabulary of ``testing/faults.py`` spec strings -- a
#: ``kind:key=value`` match must use at least one of these to count as a
#: fault-spec reference (keeps the O05 text scan away from URLs, YAML,
#: and prose that merely contains a colon).
FAULT_ARG_KEYS = frozenset({
    "rank", "round", "ms", "after", "save", "nth", "factor",
    "client", "count", "delay", "shift", "until",
})

_CAP_RE = re.compile(r"[A-Z_]*CAP\b")
_FAULT_REF_RE = re.compile(
    r"\b([a-z][a-z0-9_]{2,}):((?:[a-z_]+=[-\w./]+)(?:,[a-z_]+=[-\w./]+)*)")
_FIGURE_KEY_RE = re.compile(r"[a-z0-9_]+(?:/[a-z0-9_\[\]]+)*/?")


@dataclass(frozen=True)
class EmitSite:
    event: str
    fields: Tuple[str, ...]
    open: bool  # a non-literal ``**splat`` may attach unseen fields
    path: str
    line: int


@dataclass(frozen=True)
class MetricSite:
    name: str      # full name, or the static prefix when dynamic
    dynamic: bool  # f-string / concat tail the AST cannot resolve
    kind: str      # counter | gauge | histogram
    labels: Tuple[str, ...]
    unbounded: Tuple[str, ...]  # label keys with unbounded value exprs
    path: str
    line: int


@dataclass(frozen=True)
class ConsumerFilter:
    """A consumer site *selecting* an event type (list-comp filter or
    dispatch branch) -- checked against the schema even when no field
    of the selected events is read."""
    event: str
    path: str
    line: int


@dataclass(frozen=True)
class ConsumerRead:
    event: str
    field: str
    path: str
    line: int


@dataclass(frozen=True)
class BenchMetric:
    name: str      # full metric literal, or static prefix when dynamic
    dynamic: bool
    path: str
    line: int


@dataclass(frozen=True)
class FigureKey:
    key: str
    prefix: bool  # True: journal fold produces ``key`` + a dynamic tail


@dataclass(frozen=True)
class FaultRef:
    kind: str
    spec: str
    path: str
    line: int


@dataclass
class Extraction:
    emits: List[EmitSite] = field(default_factory=list)
    metrics: List[MetricSite] = field(default_factory=list)
    filters: List[ConsumerFilter] = field(default_factory=list)
    reads: List[ConsumerRead] = field(default_factory=list)
    bench_metrics: List[BenchMetric] = field(default_factory=list)
    figures: List[FigureKey] = field(default_factory=list)
    fault_kinds: Tuple[str, ...] = ()
    fault_refs: List[FaultRef] = field(default_factory=list)
    #: relpath -> source lines, for the shared suppression-comment check
    lines: Dict[str, List[str]] = field(default_factory=dict)


# -------------------------------------------------------------- helpers


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _static_name(node) -> Optional[Tuple[str, bool]]:
    """Resolve a metric/bench name expr -> (static prefix, dynamic?)."""
    s = _const_str(node)
    if s is not None:
        return s, False
    if isinstance(node, ast.JoinedStr):
        prefix: List[str] = []
        for part in node.values:
            if isinstance(part, ast.Constant) and isinstance(part.value, str):
                prefix.append(part.value)
            else:
                return "".join(prefix), True
        return "".join(prefix), False
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _static_name(node.left)
        if left is None:
            return None
        lname, ldyn = left
        if ldyn:
            return lname, True
        right = _static_name(node.right)
        if right is None:
            return lname, True
        rname, rdyn = right
        return lname + rname, rdyn
    return None


def _get_field(node, varname: str) -> Optional[str]:
    """``var.get("f")`` / ``var["f"]`` -> "f" (None when not a read)."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == varname and node.args):
        return _const_str(node.args[0])
    if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
            and node.value.id == varname):
        sl = node.slice
        return _const_str(sl)
    return None


def _type_filter(test) -> Set[str]:
    """Event types selected by an if-expression like
    ``e.get("type") == "round"`` / ``e["type"] in ("a", "b")``.
    BoolOp(And) operands are scanned too."""
    types: Set[str] = set()
    nodes = test.values if isinstance(test, ast.BoolOp) else [test]
    for t in nodes:
        if not (isinstance(t, ast.Compare) and len(t.ops) == 1):
            continue
        left = t.left
        is_type_read = (
            isinstance(left, ast.Call)
            and isinstance(left.func, ast.Attribute)
            and left.func.attr == "get" and left.args
            and _const_str(left.args[0]) == "type"
        ) or (
            isinstance(left, ast.Subscript)
            and _const_str(left.slice) == "type"
        )
        if not is_type_read:
            continue
        comp = t.comparators[0]
        if isinstance(t.ops[0], ast.Eq):
            s = _const_str(comp)
            if s is not None:
                types.add(s)
        elif isinstance(t.ops[0], ast.In) and isinstance(
                comp, (ast.Tuple, ast.List, ast.Set)):
            for el in comp.elts:
                s = _const_str(el)
                if s is not None:
                    types.add(s)
    return types


# ----------------------------------------------------- per-module walk


class _ModuleExtractor:
    def __init__(self, mod: ModuleInfo, out: Extraction,
                 bench_mode: bool = False,
                 consumer_mode: bool = False) -> None:
        self.mod = mod
        self.out = out
        self.bench_mode = bench_mode
        self.consumer_mode = consumer_mode
        self.emit_names: Set[str] = set()
        self.reg_names: Dict[str, str] = {}
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.fn_defs: Dict[str, ast.FunctionDef] = {
            n.name: n for n in mod.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        #: (fn name, param name) -> event types threaded from call sites
        self.param_types: Dict[Tuple[str, str], Set[str]] = {}

    # -- imports -------------------------------------------------------

    def _collect_imports(self) -> None:
        for node in ast.walk(self.mod.tree):
            if not isinstance(node, ast.ImportFrom) or not node.module:
                continue
            m = node.module
            if m.endswith("obs.journal") or m == "journal":
                for alias in node.names:
                    if alias.name == "emit":
                        self.emit_names.add(alias.asname or alias.name)
            if (m.endswith("obs.registry") or m.endswith(".obs")
                    or m in ("obs", "registry")):
                for alias in node.names:
                    if alias.name in REGISTRY_FUNCS:
                        self.reg_names[alias.asname or alias.name] = \
                            alias.name

    # -- emit sites ----------------------------------------------------

    def _emit_site(self, call: ast.Call) -> None:
        f = call.func
        is_emit = (isinstance(f, ast.Name) and f.id in self.emit_names) or \
            (isinstance(f, ast.Attribute) and f.attr in EMIT_METHODS)
        if not is_emit or not call.args:
            return
        if isinstance(call.args[0], ast.Dict):
            self._event_dict_site(call.args[0])
            return
        etype = _const_str(call.args[0])
        if etype is None:
            return
        fields: Set[str] = set()
        open_ = False
        for kw in call.keywords:
            if kw.arg is not None:
                fields.add(kw.arg)
            elif (isinstance(kw.value, ast.Dict)
                  and all(k is not None and _const_str(k) is not None
                          for k in kw.value.keys)):
                fields.update(_const_str(k) for k in kw.value.keys)
            else:
                open_ = True
        self.out.emits.append(EmitSite(
            event=etype, fields=tuple(sorted(fields)), open=open_,
            path=self.mod.relpath, line=call.lineno))

    def _event_dict_site(self, node: ast.Dict) -> None:
        """An event built as a dict literal with a constant ``"type"`` and
        handed to an emitting method (``self._emit({"type": ...})``, the
        idiom of the port's elastic layer and init cache, which keep
        every event they journal)."""
        keymap = {}
        open_ = False
        for k, v in zip(node.keys, node.values):
            ks = _const_str(k) if k is not None else None
            if ks is None:
                open_ = True
            else:
                keymap[ks] = v
        etype = _const_str(keymap.get("type"))
        if etype is None:
            return
        fields = tuple(sorted(k for k in keymap if k != "type"))
        self.out.emits.append(EmitSite(
            event=etype, fields=fields, open=open_,
            path=self.mod.relpath, line=node.lineno))

    def _dict_emit_site(self, node: ast.Dict) -> None:
        """Raw journal-line dict literal (the ``obs watch`` breach
        append): both ``"ts"`` and a constant ``"type"`` present."""
        keymap = {}
        for k, v in zip(node.keys, node.values):
            ks = _const_str(k) if k is not None else None
            if ks is not None:
                keymap[ks] = v
        if "ts" not in keymap or "type" not in keymap:
            return
        etype = _const_str(keymap["type"])
        if etype is None:
            return
        fields = tuple(sorted(k for k in keymap if k not in ("ts", "type")))
        self.out.emits.append(EmitSite(
            event=etype, fields=fields, open=True,
            path=self.mod.relpath, line=node.lineno))

    # -- metric sites --------------------------------------------------

    def _metric_site(self, call: ast.Call) -> None:
        f = call.func
        kind = None
        if isinstance(f, ast.Name):
            kind = self.reg_names.get(f.id)
        elif isinstance(f, ast.Attribute) and f.attr in REGISTRY_FUNCS:
            kind = f.attr
        if kind is None or not call.args:
            return
        nm = _static_name(call.args[0])
        if nm is None:
            return
        name, dynamic = nm
        labels: Tuple[str, ...] = ()
        unbounded: List[str] = []
        for kw in call.keywords:
            if kw.arg != "labels":
                continue
            d = self._resolve_dict(kw.value, call)
            if d is None:
                continue
            keys = []
            for k, v in zip(d.keys, d.values):
                ks = _const_str(k) if k is not None else None
                if ks is None:
                    continue
                keys.append(ks)
                if self._value_unbounded(v) and not self._cap_exempt(call):
                    unbounded.append(ks)
            labels = tuple(sorted(keys))
        self.out.metrics.append(MetricSite(
            name=name, dynamic=dynamic, kind=kind, labels=labels,
            unbounded=tuple(sorted(unbounded)),
            path=self.mod.relpath, line=call.lineno))

    def _resolve_dict(self, expr, ctx) -> Optional[ast.Dict]:
        if isinstance(expr, ast.Dict):
            return expr
        if isinstance(expr, ast.Name):
            fn = self._enclosing_function(ctx)
            scope = fn if fn is not None else self.mod.tree
            for node in ast.walk(scope):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == expr.id
                        and isinstance(node.value, ast.Dict)):
                    return node.value
        return None

    @staticmethod
    def _value_unbounded(v) -> bool:
        if (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                and v.func.id == "str" and v.args
                and not isinstance(v.args[0], ast.Constant)):
            return True
        if isinstance(v, ast.JoinedStr) and any(
                isinstance(p, ast.FormattedValue) for p in v.values):
            return True
        return False

    def _enclosing_function(self, node):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def _cap_exempt(self, node) -> bool:
        """The bounded-label idiom: the enclosing function guards the
        loop with a ``*_CAP`` comparison (``if i >= self._LEDGER_
        LABEL_CAP: continue``) before labeling by index."""
        fn = self._enclosing_function(node)
        if fn is None:
            return False
        end = getattr(fn, "end_lineno", fn.lineno)
        seg = "\n".join(self.mod.lines[fn.lineno - 1:end])
        return bool(_CAP_RE.search(seg))

    # -- consumer reads ------------------------------------------------

    def _consumer_pass(self, collect: bool) -> None:
        scopes = [self.mod.tree] + list(self.fn_defs.values())
        for scope in scopes:
            self._consumer_scope(scope, collect)

    def _consumer_scope(self, scope, collect: bool) -> None:
        listmap: Dict[str, Set[str]] = {}
        scalarmap: Dict[str, Set[str]] = {}
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for arg in scope.args.args + scope.args.kwonlyargs:
                seeded = self.param_types.get((scope.name, arg.arg))
                if seeded:
                    listmap[arg.arg] = set(seeded)
        own_nodes = self._scope_nodes(scope)
        # 1. filter assigns + dispatch-variable discovery
        for node in own_nodes:
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            target = node.targets[0].id
            value = node.value
            comp = None
            scalar = False
            if isinstance(value, (ast.ListComp, ast.GeneratorExp)):
                comp = value
            elif (isinstance(value, ast.Call)
                  and isinstance(value.func, ast.Name)
                  and value.func.id == "next" and value.args
                  and isinstance(value.args[0], ast.GeneratorExp)):
                comp = value.args[0]
                scalar = True
            if comp is not None and len(comp.generators) == 1:
                types: Set[str] = set()
                for cond in comp.generators[0].ifs:
                    types |= _type_filter(cond)
                if types:
                    if collect:
                        for t in sorted(types):
                            self.out.filters.append(ConsumerFilter(
                                event=t, path=self.mod.relpath,
                                line=node.lineno))
                    (scalarmap if scalar else listmap)[target] = types
        # 2. one-hop call threading into module-local helpers
        if not collect:
            for node in own_nodes:
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id in self.fn_defs):
                    continue
                fn = self.fn_defs[node.func.id]
                params = [a.arg for a in fn.args.args]
                for i, a in enumerate(node.args):
                    if isinstance(a, ast.Name) and a.id in listmap \
                            and i < len(params):
                        self.param_types.setdefault(
                            (fn.name, params[i]), set()).update(
                                listmap[a.id])
                for kw in node.keywords:
                    if kw.arg and isinstance(kw.value, ast.Name) \
                            and kw.value.id in listmap:
                        self.param_types.setdefault(
                            (fn.name, kw.arg), set()).update(
                                listmap[kw.value.id])
        if not collect:
            return
        # 3. iteration reads over list-vars
        for node in own_nodes:
            iters = []
            if isinstance(node, ast.For) and isinstance(node.iter, ast.Name) \
                    and node.iter.id in listmap \
                    and isinstance(node.target, ast.Name):
                iters.append((node.target.id, listmap[node.iter.id],
                              node.body))
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                                   ast.SetComp, ast.DictComp)):
                for gen in node.generators:
                    if isinstance(gen.iter, ast.Name) \
                            and gen.iter.id in listmap \
                            and isinstance(gen.target, ast.Name):
                        iters.append((gen.target.id,
                                      listmap[gen.iter.id], [node]))
            for var, types, body in iters:
                self._collect_reads(body, var, types)
        # 4. scalar reads (next()-selected single events)
        for var, types in scalarmap.items():
            self._collect_reads(own_nodes, var, types, walked=True)
        # 5. dispatch branches: k = ev.get("type"); if k == "...":
        dispatch: Dict[str, str] = {}  # dispatch var -> event var
        for node in own_nodes:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "get"
                    and isinstance(node.value.func.value, ast.Name)
                    and node.value.args
                    and _const_str(node.value.args[0]) == "type"):
                dispatch[node.targets[0].id] = node.value.func.value.id
        for node in own_nodes:
            if not isinstance(node, ast.If):
                continue
            for kvar, evar in dispatch.items():
                types = self._dispatch_types(node.test, kvar)
                if types:
                    if collect:
                        for t in sorted(types):
                            self.out.filters.append(ConsumerFilter(
                                event=t, path=self.mod.relpath,
                                line=node.lineno))
                    self._collect_reads(node.body, evar, types)

    @staticmethod
    def _dispatch_types(test, kvar: str) -> Set[str]:
        types: Set[str] = set()
        nodes = test.values if isinstance(test, ast.BoolOp) else [test]
        for t in nodes:
            if not (isinstance(t, ast.Compare)
                    and isinstance(t.left, ast.Name) and t.left.id == kvar
                    and len(t.ops) == 1):
                continue
            comp = t.comparators[0]
            if isinstance(t.ops[0], ast.Eq):
                s = _const_str(comp)
                if s is not None:
                    types.add(s)
            elif isinstance(t.ops[0], ast.In) and isinstance(
                    comp, (ast.Tuple, ast.List, ast.Set)):
                for el in comp.elts:
                    s = _const_str(el)
                    if s is not None:
                        types.add(s)
        return types

    def _collect_reads(self, body, var: str, types: Set[str],
                       walked: bool = False) -> None:
        nodes = body if walked else [
            n for stmt in body for n in ast.walk(stmt)]
        for n in nodes:
            fld = _get_field(n, var)
            if fld is None or fld in ("type", "ts"):
                continue
            for t in sorted(types):
                self.out.reads.append(ConsumerRead(
                    event=t, field=fld, path=self.mod.relpath,
                    line=n.lineno))

    def _scope_nodes(self, scope) -> List[ast.AST]:
        """All nodes of ``scope`` excluding nested function bodies (the
        nested defs are their own scopes; closures over dynamic field
        names read nothing the AST can attribute)."""
        out: List[ast.AST] = []
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            n = stack.pop()
            out.append(n)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and n is not scope:
                continue
            stack.extend(ast.iter_child_nodes(n))
        return out

    # -- bench "metric" literals --------------------------------------

    def _bench_metric(self, node: ast.Dict) -> None:
        for k, v in zip(node.keys, node.values):
            if k is None or _const_str(k) != "metric":
                continue
            nm = _static_name(v)
            if nm is None or not nm[0]:
                continue
            self.out.bench_metrics.append(BenchMetric(
                name=nm[0], dynamic=nm[1],
                path=self.mod.relpath, line=node.lineno))

    # -- the walk ------------------------------------------------------

    def run(self) -> None:
        self._collect_imports()
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.Call):
                self._emit_site(node)
                self._metric_site(node)
            elif isinstance(node, ast.Dict):
                self._dict_emit_site(node)
                if self.bench_mode:
                    self._bench_metric(node)
        # two passes: first threads filtered vars into helper params,
        # second collects reads with the seeded parameter types.  Only
        # the obs consumer modules fold journal events -- a
        # ``.get("type") == ...`` filter anywhere else (column metadata,
        # fault specs) is not a telemetry read.
        if self.consumer_mode:
            self._consumer_pass(collect=False)
            self._consumer_pass(collect=True)


# ------------------------------------------------- repo-level surfaces


def _extract_figures(out: Extraction) -> None:
    """Figure keys/prefixes ``journal_figures`` (obs/slo.py) can fold."""
    slo = PKG_ROOT / "obs" / "slo.py"
    if not slo.exists():
        return
    mod = parse_module(slo)
    fn = next((n for n in mod.tree.body
               if isinstance(n, ast.FunctionDef)
               and n.name == "journal_figures"), None)
    if fn is None:
        return
    seen: Set[Tuple[str, bool]] = set()
    fstring_parts = {id(c) for n in ast.walk(fn)
                     if isinstance(n, ast.JoinedStr)
                     for c in ast.walk(n) if isinstance(c, ast.Constant)}
    for node in ast.walk(fn):
        key = prefix = None
        s = None if id(node) in fstring_parts else _const_str(node)
        if s is not None and "/" in s and _FIGURE_KEY_RE.fullmatch(s):
            key, prefix = s, False
        elif isinstance(node, ast.JoinedStr):
            nm = _static_name(node)
            if nm and nm[1] and "/" in nm[0] \
                    and _FIGURE_KEY_RE.fullmatch(nm[0]):
                key, prefix = nm[0], True
        if key is not None and (key, prefix) not in seen:
            seen.add((key, prefix))
            out.figures.append(FigureKey(key=key, prefix=prefix))


def _extract_fault_kinds(out: Extraction) -> None:
    faults = PKG_ROOT / "testing" / "faults.py"
    if not faults.exists():
        return
    mod = parse_module(faults)
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "VALID_KINDS"
                and isinstance(node.value, (ast.Tuple, ast.List))):
            kinds = tuple(_const_str(el) for el in node.value.elts)
            if all(k is not None for k in kinds):
                out.fault_kinds = kinds
                return


def _scan_fault_refs(out: Extraction, files: Sequence[Path]) -> None:
    for path in files:
        try:
            text = path.read_text()
        except OSError:
            continue
        try:
            rel = path.resolve().relative_to(REPO_ROOT).as_posix()
        except ValueError:
            rel = path.as_posix()
        out.lines.setdefault(rel, text.splitlines())
        for lineno, line in enumerate(text.splitlines(), 1):
            for m in _FAULT_REF_RE.finditer(line):
                kind, argstr = m.group(1), m.group(2)
                keys = {p.partition("=")[0] for p in argstr.split(",")}
                if keys & FAULT_ARG_KEYS:
                    out.fault_refs.append(FaultRef(
                        kind=kind, spec=m.group(0), path=rel, line=lineno))


def _default_fault_scan_files() -> List[Path]:
    """The port's own tests, its chip script and the repo's documents."""
    files = sorted(p for p in (REPO_ROOT / "tests").glob("test_torch_*.py"))
    files += [p for p in (REPO_ROOT / "chip_smoke.py",) if p.exists()]
    files.extend(sorted(REPO_ROOT.glob("*.md")))
    return files


def extract_repo(paths: Optional[Sequence] = None) -> Extraction:
    """Extract every telemetry surface.

    ``paths=None`` is the repo-wide default: the ``fed_tgan_torch``
    package for emit/metric/consumer sites, and the port's tests, its
    chip script and the repo's documents for fault-spec references.  The
    port has no bench of its own yet, so the bench-metric catalogue is
    the registry's ``bench_metrics``.  Explicit ``paths`` (fixture mode)
    scope the site and fault-ref scans to those files; the figure and
    fault-kind catalogues always come from their canonical producers
    (``obs/slo.py``, ``testing/faults.py``) so the rules keep a full
    reference even on a scoped run.
    """
    out = Extraction()
    if paths is None:
        py_files = iter_py_files()
        fault_files = _default_fault_scan_files()
    else:
        py_files = iter_py_files(paths)
        fault_files = list(py_files)
    consumer_paths = {
        str(PKG_ROOT / "obs" / name)
        for name in ("report.py", "slo.py", "watch.py")}
    for path in py_files:
        mod = parse_module(path)
        out.lines[mod.relpath] = mod.lines
        _ModuleExtractor(mod, out, bench_mode=paths is not None,
                         consumer_mode=str(path) in consumer_paths
                         or paths is not None).run()
    _extract_figures(out)
    _extract_fault_kinds(out)
    _scan_fault_refs(out, fault_files)
    out.emits.sort(key=lambda s: (s.path, s.line, s.event))
    out.metrics.sort(key=lambda s: (s.path, s.line, s.name))
    out.reads = sorted(set(out.reads),
                       key=lambda r: (r.path, r.line, r.event, r.field))
    out.filters = sorted(set(out.filters),
                         key=lambda f: (f.path, f.line, f.event))
    return out
