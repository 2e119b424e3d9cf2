"""Program cost ledger: per-program FLOP / memory accounting, the live part
(counterpart of ``fed_tgan_tpu/obs/ledger.py:47-215``).

The JAX trainer records a ``program_cost`` journal event for each distinct
round program the first time it is dispatched, from XLA's cost analysis.
The port has no compiled program to ask, so :func:`measure_dispatch`
measures the real dispatch itself -- the round chunk the trainer runs
anyway, never an extra step, which would change the state:

- ``flops`` -- ``torch.utils.flop_counter.FlopCounterMode`` over every
  aten op of the dispatch (matrix products and convolutions, forward and
  backward, the gradient penalty's double backward included);
- ``bytes_accessed`` -- the summed bytes of every operand and result of
  every aten op a ``TorchDispatchMode`` sees (views and allocations move
  no data and are left out);
- the hand-written kernels launch through ``ctypes``
  (``ops/activate_cuda.py``), which no dispatch mode sees: they are
  counted from their wrappers' element counters at the per-element cost
  of PERF.md's kernel table (:data:`KERNEL_COST`);
- ``peak_bytes`` -- ``torch.cuda.max_memory_allocated`` across the
  dispatch, reset before it (0 on the CPU).

Neither mode changes which kernels run: each aten op is dispatched as it
is called.  Nothing here reads a device tensor.

:class:`CostEntry`, :class:`CostLedger` and :func:`get_ledger` are the JAX
package's; the ``ledger`` subcommand's AOT pass over the hlolint
contracts has no torch counterpart (ROADMAP A.20).  This module imports
torch only inside :func:`measure_dispatch`.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict

__all__ = [
    "CostEntry",
    "CostLedger",
    "KERNEL_COST",
    "get_ledger",
    "measure_dispatch",
]

#: (kernel wrapper, variant) -> (bytes, float operations) per element:
#: K1 reads x and u and writes out, about 10 operations; K2 reads dy and
#: out and writes dx, about 5; the bf16 variants move 2-byte rows (K1's
#: training variant also writes its float32 residual)
KERNEL_COST = {
    ("fwd", "f32"): (12, 10), ("fwd", "bf16"): (8, 10),
    ("fwd", "bf16_train"): (12, 10),
    ("bwd", "f32"): (12, 5), ("bwd", "bf16"): (8, 5),
}


@dataclass
class CostEntry:
    """Cost figures of one program (the JAX package's fields; the port
    fills ``flops``, ``bytes_accessed`` and ``peak_bytes``)."""

    name: str
    family: str = ""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    generated_code_bytes: int = 0
    donated_bytes: int = 0
    peak_bytes: int = 0
    compiles: int = 0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "family": self.family,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "transcendentals": self.transcendentals,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "donated_bytes": self.donated_bytes,
            "peak_bytes": self.peak_bytes,
            "compiles": self.compiles,
        }


class CostLedger:
    """Thread-safe name -> :class:`CostEntry` map."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, CostEntry] = {}

    def record(self, entry: CostEntry) -> CostEntry:
        with self._lock:
            prev = self._entries.get(entry.name)
            if prev is not None:
                entry.compiles = prev.compiles
            self._entries[entry.name] = entry
        return entry

    def note_compile(self, name: str) -> None:
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                entry = CostEntry(name=name)
                self._entries[name] = entry
            entry.compiles += 1

    def entries(self) -> Dict[str, CostEntry]:
        with self._lock:
            return dict(self._entries)

    def snapshot(self) -> dict:
        """JSON-shaped dump: {name: entry dict}, stable key order."""
        entries = self.entries()
        return {name: entries[name].to_dict() for name in sorted(entries)}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_LEDGER = CostLedger()


def get_ledger() -> CostLedger:
    """The process-wide ledger."""
    return _LEDGER


def _kernel_elements() -> dict:
    """(wrapper, variant) -> elements the hand-written kernels have
    processed in this process so far."""
    from fed_tgan_torch.ops import activate_cuda

    out = {}
    for tag, wrapper in (("fwd", activate_cuda.fused_apply_activate),
                         ("bwd", activate_cuda.fused_activate_bwd)):
        for variant, n in wrapper.variant_elements.items():
            out[(tag, variant)] = n
    return out


@contextlib.contextmanager
def measure_dispatch(entry: CostEntry, device):
    """Fill ``entry``'s ``flops``, ``bytes_accessed`` and ``peak_bytes``
    from the work dispatched inside the ``with`` block on ``device``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    def moves_data(func) -> bool:
        """Not a view (a result aliasing an input, unwritten) and not an
        allocation."""
        if func.__name__.startswith("empty"):
            return False
        return not any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if moves_data(func):
                self.total += (nbytes(args) + nbytes(kwargs or {})
                               + nbytes(out))
            return out

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = _kernel_elements()
    flops, moved = FlopCounterMode(display=False), _Bytes()
    with flops, moved:
        yield entry
    kernel_bytes = kernel_flops = 0
    for key, n in _kernel_elements().items():
        b, f = KERNEL_COST[key]
        kernel_bytes += b * (n - before.get(key, 0))
        kernel_flops += f * (n - before.get(key, 0))
    entry.flops = float(flops.get_total_flops() + kernel_flops)
    entry.bytes_accessed = float(moved.total + kernel_bytes)
    entry.peak_bytes = (int(torch.cuda.max_memory_allocated(device))
                        if cuda else 0)
