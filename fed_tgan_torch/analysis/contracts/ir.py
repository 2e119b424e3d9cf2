"""One call of an entry point -> structured program fingerprint
(counterpart of ``fed_tgan_tpu/analysis/contracts/ir.py``).

The JAX package reads the StableHLO text of a lowered program.  The port
lowers nothing: its counterpart of a program is the work one call of an
entry point dispatches, which :class:`DispatchRecorder` records with a
``TorchDispatchMode`` (as ``obs/ledger.py::measure_dispatch`` does).  The
facts kept are coarse -- op counts, byte totals, dtype tallies -- so the
diff stays stable across benign refactors yet catches the silent cost
regressions no test sees on the CPU:

* ``collectives``: count and payload bytes of every ``c10d`` op (the
  multi-process round's all-gather, ``parallel/multihost.py``).
  Single-process programs record ``{}``, as JAX's serve programs do;
* ``transfers``: the tensors and arrays that cross the entry point's
  boundary (``n_inputs``/``in_bytes`` handed in, ``n_outputs``/
  ``out_bytes`` handed back), ``syncs`` (ops that block the host on the
  program's device: :data:`SYNC_OPS`) and ``copies``/``copy_bytes``
  (cross-device ``_to_copy``/``copy_``);
* ``dtypes``: the census of op results on the program's device, named as
  XLA names them (``f32``, ``bf16``, ``f64``, ``i64``, ``i1`` ...);
* ``kernels``: calls of K1 and K2 per variant (``K1[f32]``,
  ``K2[bf16]`` ...).  They launch through ``ctypes`` where no dispatch
  mode sees them, so the wrappers report each call to the recorder
  (``ops/activate_cuda.py``'s ``observer``); on the card the count is
  held against the wrappers' launch counters.  The census is suspended
  inside a wrapper: on the CPU its plain version dispatches aten ops the
  card never runs, and the CPU and card contracts would otherwise differ
  by design;
* ``ops`` (the total op tally) and ``host_ops`` (the sync and copy ops by
  name): informational only, the op delta ``--explain`` names.

On the CPU, ``.cpu()`` of a CPU tensor and ``.numpy()`` dispatch nothing,
and ``.to(cpu)`` of one is no copy: the CPU contracts hold the syncs and
the boundary, and only the card's contracts (``contracts/gpu/``) hold the
copies.  Each sync, copy, collective and f64 result also keeps its Python
call site (not stored in the contract: line numbers move) for
``--explain``.

:class:`Fingerprint` and its helpers are pure stdlib; torch is imported
only by the recorder.
"""

from __future__ import annotations

import os
import traceback
from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["DispatchRecorder", "Fingerprint", "SYNC_OPS",
           "boundary", "dtype_name", "kernel_calls"]

#: torch dtype -> XLA's short name; anything else keeps torch's name
_DTYPE_NAMES = {
    "float64": "f64", "float32": "f32", "float16": "f16", "bfloat16": "bf16",
    "float8_e4m3fn": "f8E4M3FN", "float8_e5m2": "f8E5M2",
    "int64": "i64", "int32": "i32", "int16": "i16", "int8": "i8",
    "uint8": "ui8", "bool": "i1", "complex64": "c64", "complex128": "c128",
}

#: ops that block the host until the device has run up to them
SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "masked_select", "unique", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive",
    "is_nonzero", "equal",
})

#: ops that copy between devices when their operands' devices differ
_COPY_OPS = frozenset({"_to_copy", "copy_", "_copy_from",
                       "_copy_from_and_resize"})

#: ``c10d`` op -> the collective's name as the JAX contracts spell it
_COLLECTIVES = {
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "all_gather_into_tensor": "all_gather",
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "all_reduce": "all_reduce",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor": "reduce_scatter",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
    "all_to_all_single": "all_to_all",
    "broadcast_": "collective_broadcast", "broadcast": "collective_broadcast",
}

#: call sites kept per metric (``--explain``)
MAX_SITES = 5

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
_HERE = os.path.abspath(__file__)


def dtype_name(dtype) -> str:
    """XLA's short name of a torch (or numpy) dtype."""
    name = str(dtype).replace("torch.", "")
    return _DTYPE_NAMES.get(name, name)


@dataclass
class Fingerprint:
    """The contract-relevant shape of one dispatch of an entry point."""

    #: op -> {"count": occurrences, "bytes": summed payload bytes}
    collectives: Dict[str, Dict[str, int]] = field(default_factory=dict)
    #: n_inputs / in_bytes / n_outputs / out_bytes / syncs / copies /
    #: copy_bytes
    transfers: Dict[str, int] = field(default_factory=dict)
    #: dtype -> op results of that dtype on the program's device
    dtypes: Dict[str, int] = field(default_factory=dict)
    #: "K1[f32]" ... -> calls of that kernel variant
    kernels: Dict[str, int] = field(default_factory=dict)
    #: every op dispatched outside the kernels (informational)
    ops: int = 0
    #: sync and copy ops by name (informational: the op delta)
    host_ops: Dict[str, int] = field(default_factory=dict)
    #: metric -> "op @ file:line: code" call sites; never stored
    sites: Dict[str, List[str]] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "collectives": {k: dict(v) for k, v in
                            sorted(self.collectives.items())},
            "transfers": dict(sorted(self.transfers.items())),
            "dtypes": dict(sorted(self.dtypes.items())),
            "kernels": dict(sorted(self.kernels.items())),
            "ops": self.ops,
            "host_ops": dict(sorted(self.host_ops.items())),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "Fingerprint":
        return cls(
            collectives={k: dict(v) for k, v in
                         data.get("collectives", {}).items()},
            transfers=dict(data.get("transfers", {})),
            dtypes=dict(data.get("dtypes", {})),
            kernels=dict(data.get("kernels", {})),
            ops=int(data.get("ops", 0)),
            host_ops=dict(data.get("host_ops", {})),
        )


def kernel_calls(fp: Fingerprint, kernel: str = "") -> int:
    """Calls of every kernel variant of ``fp`` (of ``kernel``, "K1" or
    "K2", when given)."""
    return sum(n for k, n in fp.kernels.items() if k.startswith(kernel))


def boundary(obj) -> tuple:
    """(count, bytes) of the tensors and numpy arrays in ``obj``, through
    lists, tuples and dict values."""
    if isinstance(obj, (list, tuple)):
        parts = [boundary(x) for x in obj]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    if isinstance(obj, dict):
        return boundary(list(obj.values()))
    mod = type(obj).__module__
    if mod == "numpy" and type(obj).__name__ == "ndarray":
        return 1, int(obj.nbytes)
    if mod.startswith("torch") and type(obj).__name__ in ("Tensor",
                                                          "Parameter"):
        return 1, obj.numel() * obj.element_size()
    return 0, 0


def _site(op: str) -> str:
    """``op @ file:line: code`` of the innermost frame outside torch and
    this recorder."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path == _HERE or f"{os.sep}torch{os.sep}" in path \
                or f"{os.sep}contextlib.py" in path:
            continue
        rel = os.path.relpath(path, _REPO) if path.startswith(_REPO) \
            else path
        return f"{op} @ {rel}:{frame.lineno}: {(frame.line or '').strip()}"
    return op


class DispatchRecorder:
    """Record the ops dispatched inside ``with DispatchRecorder(device):``
    on this thread (a dispatch mode sees only the thread that enters it,
    and the autograd threads it hands its state to) and the kernel calls
    of the wrappers; :meth:`fingerprint` turns them into a
    :class:`Fingerprint`."""

    def __init__(self, device):
        import torch

        self.device_type = torch.device(device).type
        self.fp = Fingerprint()
        self.fp.transfers = {"syncs": 0, "copies": 0, "copy_bytes": 0}
        self._suspended = 0
        self._mode = None
        self._prev_observer = None
        self._launches = None

    # ----------------------------------------------------------- kernels

    def _observe(self, kernel: str, variant: str):
        import contextlib

        key = f"{kernel}[{variant}]"
        self.fp.kernels[key] = self.fp.kernels.get(key, 0) + 1

        @contextlib.contextmanager
        def suspended():
            self._suspended += 1
            try:
                yield
            finally:
                self._suspended -= 1

        return suspended()

    @staticmethod
    def _launch_counts() -> tuple:
        from fed_tgan_torch.ops import activate_cuda

        return (activate_cuda.fused_apply_activate.launches,
                activate_cuda.fused_activate_bwd.launches)

    # -------------------------------------------------------------- ops

    def _add_site(self, metric: str, op: str) -> None:
        sites = self.fp.sites.setdefault(metric, [])
        if len(sites) < MAX_SITES:
            sites.append(_site(op))

    def _note(self, func, args, kwargs, out) -> None:
        import torch
        from torch.utils._pytree import tree_leaves

        fp = self.fp
        ns, name = func.namespace, func._opname
        if ns in ("c10d", "_c10d_functional"):
            op = _COLLECTIVES.get(name, name.rstrip("_"))
            # c10d's in-place ops write their first argument; the
            # functional ones return their result
            payload = args[0] if ns == "c10d" and args else out
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(payload)
                         if isinstance(t, torch.Tensor))
            entry = fp.collectives.setdefault(op, {"count": 0, "bytes": 0})
            entry["count"] += 1
            entry["bytes"] += nbytes
            self._add_site(f"collectives.{op}", name)
            return
        fp.ops += 1
        mine = self.device_type
        inputs = [t for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in results:
            if t.device.type == mine:
                dt = dtype_name(t.dtype)
                fp.dtypes[dt] = fp.dtypes.get(dt, 0) + 1
                if dt == "f64":
                    self._add_site("dtypes.f64", name)
        if name in SYNC_OPS and any(t.device.type == mine for t in inputs):
            fp.transfers["syncs"] += 1
            fp.host_ops[name] = fp.host_ops.get(name, 0) + 1
            self._add_site("transfers.syncs", name)
        elif name in _COPY_OPS and inputs:
            if name == "_to_copy":
                src, dst = inputs[0], (results[0] if results else inputs[0])
            else:  # copy_(dst, src) and the _copy_from family (src, dst)
                src, dst = ((inputs[1], inputs[0]) if name == "copy_"
                            and len(inputs) > 1 else
                            (inputs[0], inputs[-1]))
            if src.device.type != dst.device.type:
                fp.transfers["copies"] += 1
                fp.transfers["copy_bytes"] += dst.numel() * dst.element_size()
                fp.host_ops[name] = fp.host_ops.get(name, 0) + 1
                self._add_site("transfers.copies", name)

    # --------------------------------------------------------- lifecycle

    def __enter__(self) -> "DispatchRecorder":
        from torch.utils._python_dispatch import TorchDispatchMode

        from fed_tgan_torch.ops import activate_cuda

        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if not rec._suspended:
                    rec._note(func, args, kwargs, out)
                return out

        self._prev_observer = activate_cuda.observer
        activate_cuda.observer = self._observe
        self._launches = self._launch_counts()
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        from fed_tgan_torch.ops import activate_cuda

        self._mode.__exit__(*exc)
        activate_cuda.observer = self._prev_observer
        if exc[0] is None and self.device_type == "cuda":
            k1, k2 = (b - a for a, b in zip(self._launches,
                                            self._launch_counts()))
            seen = (kernel_calls(self.fp, "K1"), kernel_calls(self.fp, "K2"))
            if (k1, k2) != seen:
                raise RuntimeError(
                    f"the wrappers reported K1/K2 calls {seen} but counted "
                    f"{(k1, k2)} launches")

    def fingerprint(self, inputs=(), outputs=()) -> Fingerprint:
        """The recorded fingerprint, with the boundary of ``inputs`` (what
        the entry point was handed) and ``outputs`` (what it returned)."""
        n_in, in_bytes = boundary(inputs)
        n_out, out_bytes = boundary(outputs)
        self.fp.transfers.update(n_inputs=n_in, in_bytes=in_bytes,
                                 n_outputs=n_out, out_bytes=out_bytes)
        return self.fp
