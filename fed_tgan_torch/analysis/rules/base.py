"""Shared AST machinery of the J rules in torch idiom (counterpart of
``fed_tgan_tpu/analysis/rules/base.py``).

Plain-stdlib AST analysis: no torch import.  Where the JAX rules taint
"an output of a compiled program", these taint *a tensor on the device*:

* a parameter annotated ``torch.Tensor`` (``Optional[...]``, lists of
  tensors too);
* a ``torch.*`` call given a ``device=`` (not the literal ``"cpu"``) or a
  tainted argument; ``.to(<device>)`` and ``.cuda()`` of anything;
* whatever is computed from a tainted value: arithmetic, subscripts,
  method calls and attributes (except the metadata ``shape``, ``dtype``,
  ``device``, ``numel()`` ...), unpacking, iteration, and calls of any
  function given a tainted argument (builtins that return host values,
  ``np.*`` and the host copies excepted);
* a ``self.<attr>`` assigned a tainted value anywhere in the module.

Host values launder the taint: ``.cpu()``, ``.numpy()``, ``.tolist()``,
``.item()``, ``float()``/``int()``/``bool()``/``len()``, ``np.*``
results, and everything inside ``with sanctioned_sync():`` -- the port's
designed host copies (a chunk's one copy, a response's copy), which the
runtime sync guard allows too -- or returned by ``_to_host``.

:func:`scan` walks a module once (three fixpoint sweeps: a helper called
from a loop is hot, and a helper handed a tainted argument taints its
parameter, one hop per sweep) and returns the events J01, J03, J04 and
J06 report; the result is cached on the module.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Optional

#: numpy module aliases as the repo spells them
NUMPY_PREFIXES = ("np.", "numpy.")

#: ``torch.*`` callables whose result is never a device tensor
_HOST_TORCH = re.compile(
    r"^torch\.(?:from_numpy|Generator|device|dtype|Size|is_tensor|"
    r"is_grad_enabled|is_floating_point|get_\w+|set_\w+|manual_seed|"
    r"no_grad|enable_grad|inference_mode|finfo|iinfo|promote_types|"
    r"result_type|can_cast|backends\..*|cuda\.(?!.*Tensor).*|distributed\..*|"
    r"utils\..*|autograd\..*|profiler\..*|testing\..*|library\..*|"
    r"compile|jit\..*|nn\..*|optim\..*|set_num_threads|get_num_threads|"
    r"use_deterministic_algorithms|are_deterministic_algorithms_enabled)$")

#: builtins whose result is a host value whatever they are given
_HOST_BUILTINS = {"float", "int", "bool", "str", "len", "repr", "isinstance",
                  "hasattr", "callable", "type", "id", "print", "range",
                  "hash", "format", "_to_host", "self._to_host"}

#: methods of a tensor that read host-side metadata or copy to the host
_HOST_METHODS = {"size", "dim", "numel", "nelement", "ndimension",
                 "element_size", "data_ptr", "stride", "is_contiguous",
                 "get_device", "is_floating_point", "is_complex",
                 "cpu", "numpy", "tolist", "item", "type", "storage_offset",
                 "untyped_storage", "is_pinned", "pin_memory", "keys",
                 "__len__"}
#: attributes of a tensor that are host-side metadata
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_leaf", "names", "itemsize", "nbytes",
               "is_sparse", "is_quantized", "is_meta", "type"}

#: host-sync sinks on a tainted receiver
SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
SYNC_BUILTINS = ("float", "int", "bool")

_F64_NAMES = {"torch.float64", "torch.double", "float", "np.float64",
              "numpy.float64", "np.double"}


def dotted(node: ast.AST) -> Optional[str]:
    """Dotted-name form of a callee expression; a call in the chain
    collapses to "()" (``self._fn(n)(x)`` -> "self._fn()")."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        base = dotted(node.func)
        return f"{base}()" if base else None
    return None


def assigned_names(stmts) -> set:
    """Every name (re)bound anywhere inside ``stmts``."""
    out: set = set()

    def bind(target):
        if isinstance(target, ast.Name):
            out.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                bind(elt)
        elif isinstance(target, ast.Starred):
            bind(target.value)

    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    bind(t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                bind(node.target)
            elif isinstance(node, (ast.For, ast.AsyncFor,
                                   ast.comprehension)):
                bind(node.target)
            elif isinstance(node, ast.withitem) and node.optional_vars:
                bind(node.optional_vars)
            elif isinstance(node, ast.NamedExpr):
                bind(node.target)
    return out


def names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def is_f64(node) -> bool:
    """``torch.float64``, ``torch.double``, ``float``, ``np.float64`` or
    the string ``"float64"``/``"double"``."""
    if isinstance(node, ast.Constant):
        return node.value in ("float64", "double")
    return (dotted(node) or "") in _F64_NAMES


def _kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_cpu(node) -> bool:
    """The literal ``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and (dotted(node.func) or "") == \
            "torch.device" and node.args:
        return _is_cpu(node.args[0])
    return False


def _is_dtype(node) -> bool:
    """A dtype argument of ``.to()``: ``torch.<dtype>`` or a name that
    says ``dtype``."""
    d = dotted(node) or ""
    if d.startswith("torch."):
        return not d.startswith("torch.device")
    return "dtype" in d.rsplit(".", 1)[-1]


def _tensor_annotation(ann) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann) if not isinstance(ann, ast.Constant) \
        else str(ann.value)
    return "Tensor" in text


#: numpy calls that make float64 arrays unless given a dtype
_F64_NUMPY = re.compile(
    r"^(?:np|numpy)\.(?:zeros|ones|empty|full|linspace|random\.\w+|"
    r"float64|double|eye|identity)$")


@dataclass
class Events:
    """What one module scan found: (line, message[, hot]) per kind."""

    syncs: list = field(default_factory=list)     # J01: (line, msg)
    branches: list = field(default_factory=list)  # J03: (line, msg)
    numpy: list = field(default_factory=list)     # (line, msg, hot)
    f64: list = field(default_factory=list)       # J06: (line, msg)


@dataclass
class _FnInfo:
    node: ast.AST
    params: list
    tainted_params: set = field(default_factory=set)
    hot: bool = False


def _f64_aliases(tree: ast.Module) -> set:
    """Module-level names assigned a float64 dtype (``F64 =
    torch.float64``)."""
    return {t.id for node in tree.body if isinstance(node, ast.Assign)
            and is_f64(node.value) for t in node.targets
            if isinstance(t, ast.Name)}


def _f64_params(fn, aliases) -> set:
    """Parameters of ``fn`` whose default is float64 (or an alias)."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set()
    args = fn.args
    pos = args.posonlyargs + args.args
    pairs = list(zip(pos[len(pos) - len(args.defaults):], args.defaults))
    pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
              if d is not None]
    return {a.arg for a, d in pairs if is_f64(d) or (
        isinstance(d, ast.Name) and d.id in aliases)}


def _local_fns(tree: ast.Module) -> dict:
    out: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            allargs = args.posonlyargs + args.args + args.kwonlyargs
            params = [a.arg for a in args.posonlyargs + args.args
                      if a.arg not in ("self", "cls")]
            info = _FnInfo(node=node, params=params)
            info.tainted_params = {a.arg for a in allargs
                                   if _tensor_annotation(a.annotation)}
            out.setdefault(node.name, info)
    return out


class _Scanner:
    """One pass over one function body (or the module's top level)."""

    def __init__(self, info, fns, module_taint, self_taint, f64_names,
                 collect, f64_aliases=frozenset()):
        self.info = info
        # names standing for float64: module constants, and parameters
        # whose default is one
        self.f64_aliases = set(f64_aliases) | _f64_params(info.node,
                                                          f64_aliases)
        self.fns = fns
        self.taint = set(module_taint) | set(info.tainted_params)
        self.self_taint = self_taint
        self.f64_names = set(f64_names)
        self.collect = collect
        self.events = Events()
        self.callsites: list = []
        self._memo: dict = {}

    # -------------------------------------------------------- taint eval

    def tainted(self, e) -> bool:
        """Whether ``e`` is (or holds) a device tensor; memoized until the
        next binding."""
        key = id(e)
        hit = self._memo.get(key)
        if hit is None:
            hit = self._memo[key] = self._tainted(e)
        return hit

    def _tainted(self, e) -> bool:  # noqa: C901 -- one case per node type
        if isinstance(e, ast.Name):
            return e.id in self.taint
        if isinstance(e, ast.Attribute):
            if e.attr in _HOST_ATTRS:
                return False
            if isinstance(e.value, ast.Name) and e.value.id in ("self",
                                                                 "cls"):
                return e.attr in self.self_taint
            return self.tainted(e.value)
        if isinstance(e, (ast.Subscript, ast.Starred)):
            return self.tainted(e.value)
        if isinstance(e, ast.Call):
            return self._call_tainted(e)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(x) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(self.tainted(v) for v in e.values)
        if isinstance(e, ast.BinOp):
            return self.tainted(e.left) or self.tainted(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.tainted(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.tainted(v) for v in e.values)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return self.tainted(e.left) or \
                any(self.tainted(c) for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return self.tainted(e.body) or self.tainted(e.orelse)
        if isinstance(e, ast.NamedExpr):
            t = self.tainted(e.value)
            if t:
                self.bind(e.target)
            return t
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for gen in e.generators:
                if self.tainted(gen.iter):
                    self.bind(gen.target)
            return self.tainted(e.elt)
        if isinstance(e, ast.DictComp):
            for gen in e.generators:
                if self.tainted(gen.iter):
                    self.bind(gen.target)
            return self.tainted(e.value)
        return False

    def _call_tainted(self, e: ast.Call) -> bool:
        d = dotted(e.func) or ""
        args = list(e.args) + [k.value for k in e.keywords]
        if d in _HOST_BUILTINS or d.startswith(NUMPY_PREFIXES):
            return False
        if isinstance(e.func, ast.Attribute):
            attr = e.func.attr
            if attr in _HOST_METHODS:
                return False
            if attr == "cuda":
                return True
            if attr == "to":
                target = e.args[0] if e.args else _kwarg(e, "device")
                if target is None or _is_dtype(target):
                    return self.tainted(e.func.value)
                return not _is_cpu(target)
        if d.startswith("torch."):
            if _HOST_TORCH.match(d):
                return False
            dev = _kwarg(e, "device")
            if dev is not None:
                return not _is_cpu(dev)
            return any(self.tainted(a) for a in args)
        if isinstance(e.func, ast.Attribute) and self.tainted(e.func.value):
            return True  # a method of a device tensor (or module)
        return any(self.tainted(a) for a in args)

    def bind(self, target) -> None:
        self._memo.clear()
        if isinstance(target, ast.Name):
            self.taint.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.bind(elt)
        elif isinstance(target, ast.Starred):
            self.bind(target.value)
        elif isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            self.self_taint.add(target.attr)

    def unbind(self, target) -> None:
        if isinstance(target, ast.Name) and target.id in self.taint:
            self._memo.clear()
            self.taint.discard(target.id)

    def _f64_array(self, e) -> bool:
        """``e`` is a float64 numpy array: a float64-making numpy call
        without a dtype, ``.astype(<f64>)``, or a name bound to one."""
        if isinstance(e, ast.Name):
            return e.id in self.f64_names
        if not isinstance(e, ast.Call):
            return False
        d = dotted(e.func) or ""
        if isinstance(e.func, ast.Attribute) and e.func.attr == "astype":
            return bool(e.args) and self.is_f64(e.args[0])
        if _F64_NUMPY.match(d):
            dt = _kwarg(e, "dtype")
            return dt is None or self.is_f64(dt)
        return False

    def is_f64(self, node) -> bool:
        return is_f64(node) or (isinstance(node, ast.Name)
                                and node.id in self.f64_aliases)

    # ------------------------------------------------------------- sinks

    def _add(self, kind, line, message, *extra):
        if self.collect:
            getattr(self.events, kind).append((line, message, *extra))

    def check_call(self, call, hot, sanctioned) -> None:
        self._register_callsite(call, hot)
        d = dotted(call.func) or ""
        func = call.func
        if d.startswith(NUMPY_PREFIXES) and any(
                self.tainted(a) for a in list(call.args)
                + [k.value for k in call.keywords]):
            self._add("numpy", call.lineno,
                      f"{d}() on a device tensor: numpy reads it on the "
                      "host (an implicit copy and sync, and a TypeError "
                      "on a CUDA tensor)", hot and not sanctioned)
        if hot and not sanctioned:
            if isinstance(func, ast.Attribute) and \
                    func.attr in SYNC_METHODS and self.tainted(func.value):
                self._add("syncs", call.lineno,
                          f".{func.attr}() of a device tensor syncs the "
                          "host with the device every iteration")
            elif d in SYNC_BUILTINS and len(call.args) == 1 and \
                    self.tainted(call.args[0]):
                self._add("syncs", call.lineno,
                          f"{d}() of a device tensor blocks on a device "
                          "sync every iteration")
        self._check_f64(call, d)

    def _check_f64(self, call, d) -> None:
        func = call.func
        recv = func.value if isinstance(func, ast.Attribute) else None
        if recv is not None and self.tainted(recv):
            if func.attr == "double" or (
                    func.attr in ("to", "type")
                    and any(self.is_f64(a) for a in call.args)) or \
                    (func.attr == "to" and
                     self.is_f64(_kwarg(call, "dtype"))):
                self._add("f64", call.lineno,
                          f".{func.attr}() asks for float64 on the device")
                return
        if d.startswith("torch.") and not _HOST_TORCH.match(d):
            dt, dev = _kwarg(call, "dtype"), _kwarg(call, "device")
            on_dev = (dev is not None and not _is_cpu(dev)) or any(
                self.tainted(a) for a in call.args)
            if dt is not None and self.is_f64(dt) and on_dev:
                self._add("f64", call.lineno,
                          f"{d}(dtype={ast.unparse(dt)}) makes a float64 "
                          "tensor on the device")
                return
            if d in ("torch.as_tensor", "torch.tensor") and dt is None and \
                    dev is not None and not _is_cpu(dev) and call.args and \
                    self._f64_array(call.args[0]):
                self._add("f64", call.lineno,
                          f"{d}() of a float64 array onto the device "
                          "without a dtype keeps float64")
                return
        if isinstance(func, ast.Attribute) and func.attr in ("to", "cuda") \
                and isinstance(recv, ast.Call) and \
                (dotted(recv.func) or "") == "torch.from_numpy" and \
                recv.args and self._f64_array(recv.args[0]) and \
                not any(_is_dtype(a) and not _is_cpu(a) for a in call.args) \
                and _kwarg(call, "dtype") is None:
            self._add("f64", call.lineno,
                      "torch.from_numpy() of a float64 array moved to the "
                      "device without a dtype keeps float64")

    def check_binop(self, node) -> None:
        for side, other in ((node.left, node.right),
                            (node.right, node.left)):
            if isinstance(side, ast.Call) and \
                    (dotted(side.func) or "") in ("np.float64",
                                                  "numpy.float64",
                                                  "np.double") and \
                    self.tainted(other):
                self._add("f64", node.lineno,
                          "a numpy float64 scalar mixed with a device "
                          "tensor")
                return

    def _register_callsite(self, call, hot) -> None:
        func = call.func
        name = None
        if isinstance(func, ast.Name) and func.id in self.fns:
            name = func.id
        elif isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id in ("self", "cls") \
                and func.attr in self.fns:
            name = func.attr
        if name is None:
            return
        pos = [self.tainted(a) for a in call.args
               if not isinstance(a, ast.Starred)]
        kw = {k.arg: self.tainted(k.value) for k in call.keywords if k.arg}
        self.callsites.append((name, pos, kw, hot))

    # ----------------------------------------------------- tree walking

    def scan_expr(self, e, hot, sanctioned) -> None:
        if e is None or not isinstance(e, ast.AST):
            return
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            for gen in e.generators:
                self.scan_expr(gen.iter, hot, sanctioned)
                if self.tainted(gen.iter):
                    self.bind(gen.target)
                for cond in gen.ifs:
                    self.scan_expr(cond, True, sanctioned)
            parts = [e.key, e.value] if isinstance(e, ast.DictComp) \
                else [e.elt]
            for p in parts:
                self.scan_expr(p, True, sanctioned)
            return
        if isinstance(e, ast.Lambda):
            return
        if isinstance(e, ast.IfExp):
            self.check_branch(e, hot, sanctioned)
        if isinstance(e, ast.BinOp):
            self.check_binop(e)
        if isinstance(e, ast.Call):
            self.check_call(e, hot, sanctioned)
        for child in ast.iter_child_nodes(e):
            self.scan_expr(child, hot, sanctioned)

    def check_branch(self, node, hot, sanctioned) -> None:
        if not hot or sanctioned:
            return
        if self.tainted(node.test):
            self._add("branches", node.lineno,
                      "a Python branch on a device tensor's value syncs "
                      "the host every iteration (an implicit bool())")

    def scan_stmts(self, stmts, hot, sanctioned) -> None:  # noqa: C901
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue  # scanned as their own functions
            if isinstance(s, ast.Assign):
                self.scan_expr(s.value, hot, sanctioned)
                if not sanctioned and self.tainted(s.value):
                    for t in s.targets:
                        self.bind(t)
                else:  # a host value rebinds the name
                    for t in s.targets:
                        self.unbind(t)
                if self._f64_array(s.value):
                    for t in s.targets:
                        if isinstance(t, ast.Name):
                            self.f64_names.add(t.id)
            elif isinstance(s, (ast.AugAssign, ast.AnnAssign)):
                if s.value is not None:
                    self.scan_expr(s.value, hot, sanctioned)
                    if not sanctioned and self.tainted(s.value):
                        self.bind(s.target)
            elif isinstance(s, (ast.For, ast.AsyncFor)):
                self.scan_expr(s.iter, hot, sanctioned)
                if self.tainted(s.iter):
                    self.bind(s.target)
                else:
                    for name in names_in(s.target):
                        self.unbind(ast.Name(id=name))
                self.scan_stmts(s.body, True, sanctioned)
                self.scan_stmts(s.orelse, True, sanctioned)
            elif isinstance(s, ast.While):
                self.check_branch(s, True, sanctioned)
                self.scan_expr(s.test, True, sanctioned)
                self.scan_stmts(s.body, True, sanctioned)
                self.scan_stmts(s.orelse, hot, sanctioned)
            elif isinstance(s, ast.If):
                self.check_branch(s, hot, sanctioned)
                self.scan_expr(s.test, hot, sanctioned)
                self.scan_stmts(s.body, hot, sanctioned)
                self.scan_stmts(s.orelse, hot, sanctioned)
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                inner = sanctioned or any(
                    (dotted(item.context_expr) or "").split("(")[0]
                    .endswith("sanctioned_sync") for item in s.items)
                for item in s.items:
                    self.scan_expr(item.context_expr, hot, sanctioned)
                    if item.optional_vars is not None and \
                            self.tainted(item.context_expr):
                        self.bind(item.optional_vars)
                self.scan_stmts(s.body, hot, inner)
            elif isinstance(s, ast.Try):
                self.scan_stmts(s.body, hot, sanctioned)
                for h in s.handlers:
                    self.scan_stmts(h.body, hot, sanctioned)
                self.scan_stmts(s.orelse, hot, sanctioned)
                self.scan_stmts(s.finalbody, hot, sanctioned)
            else:
                for child in ast.iter_child_nodes(s):
                    self.scan_expr(child, hot, sanctioned)

    def run(self, body) -> None:
        self.scan_stmts(body, self.info.hot, False)


#: fixpoint sweeps: 1 seeds call sites, 2 propagates hot/taint one hop,
#: 3 reaches helpers-of-helpers and collects the events
_PASSES = 3


def scan(mod) -> Events:
    """The J01/J03/J04/J06 events of ``mod`` (a ``lint.ModuleInfo``),
    computed once per module."""
    cached = getattr(mod, "_torch_events", None)
    if cached is not None:
        return cached
    tree = mod.tree
    fns = _local_fns(tree)
    module_info = _FnInfo(node=tree, params=[])
    self_taint: set = set()
    aliases = _f64_aliases(tree)
    events = Events()
    for sweep in range(_PASSES):
        collect = sweep == _PASSES - 1
        mscan = _Scanner(module_info, fns, set(), self_taint, set(), collect,
                         aliases)
        mscan.run(tree.body)
        scanners = [mscan]
        for info in fns.values():
            sc = _Scanner(info, fns, mscan.taint, self_taint, mscan.f64_names,
                          collect, aliases)
            sc.run(info.node.body)
            scanners.append(sc)
        for sc in scanners:
            for name, pos, kw, hot in sc.callsites:
                callee = fns[name]
                if hot:
                    callee.hot = True
                for i, tainted in enumerate(pos):
                    if tainted and i < len(callee.params):
                        callee.tainted_params.add(callee.params[i])
                for k, tainted in kw.items():
                    if tainted and k in callee.params:
                        callee.tainted_params.add(k)
            if collect:
                for kind in ("syncs", "branches", "numpy", "f64"):
                    getattr(events, kind).extend(getattr(sc.events, kind))
    mod._torch_events = events
    return events


def unique(rows) -> list:
    """(line, message) rows, first message per line, by line."""
    out: dict = {}
    for line, message, *_ in rows:
        out.setdefault(line, message)
    return sorted(out.items())
