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
package's.  JAX's ``ledger`` subcommand compiles the programs of its
hlolint contracts; the port's (:func:`port_cost_ledger`, ``python -m
fed_tgan_torch.obs ledger``) runs one small instance of each program
family the port dispatches (the stacked round chunk in f32 and bf16, an
engine chunk, a 2-lane fleet dispatch, the similarity monitor's probe)
through :func:`measure_dispatch`.  The port's program contracts
(``analysis/contracts/``) record their programs from the same small
instances (:func:`_small_init`, :func:`_small_config`).  This module
imports torch only inside :func:`measure_dispatch` and the ledger's
families.
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
    "FAMILIES",
    "get_ledger",
    "ledger_main",
    "measure_dispatch",
    "port_cost_ledger",
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
                # a dispatch mode is entered on one thread and sees only
                # that thread's ops
                self.total += (  # torchlint: disable=L01
                    nbytes(args) + nbytes(kwargs or {}) + nbytes(out))
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


# ------------------------------------------------------- the ledger CLI


def _small_init(device, seed: int = 3):
    """``(init, tables)``: the federated init of a small two-column table
    (one continuous, one categorical) over 2 clients of 80 rows."""
    import numpy as np

    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize

    rng = np.random.default_rng(seed)
    tables = [{"x": np.round(rng.normal(0, 1, 80), 3),
               "c": rng.choice(["a", "b", "c"], 80).astype(object)}
              for _ in range(2)]
    init = federated_initialize(
        [TablePreprocessor(table=t, categorical_columns=["c"])
         for t in tables], seed=0, device=device)
    return init, tables


def _small_config(precision: str = "f32", **overrides):
    """The small trainer's config (2 steps a round at 80 rows), with
    ``overrides``."""
    from fed_tgan_torch.train.steps import TrainConfig

    kw = dict(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),
              batch_size=40, pac=4, precision=precision)
    kw.update(overrides)
    return TrainConfig(**kw)


def _small_trainer(device, precision: str = "f32", seed: int = 3):
    """A 2-client federated trainer on :func:`_small_init`'s table."""
    from fed_tgan_torch.train.federated import FederatedTrainer

    init, tables = _small_init(device, seed)
    return FederatedTrainer(init, _small_config(precision), seed=seed,
                            device=device), tables


def _measured(name: str, family: str, device, fn) -> CostEntry:
    entry = CostEntry(name=name, family=family)
    with measure_dispatch(entry, device):
        fn()
    return entry


def _train_family(device) -> list:
    out = []
    for precision in ("f32", "bf16"):
        tr, _ = _small_trainer(device, precision)
        out.append(_measured(
            f"train_step[stack{tr.capacity}@{precision}]", "train_live",
            device, lambda tr=tr: tr._dispatch_chunk(0, 1, None, None)))
    return out


def _artifact_engines(device, root: str, tenants: int):
    """``tenants`` hot tenants of one random-weight Intrusion-layout
    artifact (full width, TrainConfig() defaults) in a fleet."""
    from fed_tgan_torch.serve.demo import build_random_artifact
    from fed_tgan_torch.serve.fleet import FleetRegistry

    build_random_artifact(root, seed=0)
    fleet = FleetRegistry(device=device, log=lambda *a, **k: None)
    for i in range(tenants):
        fleet.load(f"t{i}", root)
    return fleet


def _serve_family(device, root: str) -> list:
    fleet = _artifact_engines(device, root, 1)
    engine = fleet.get("t0").engine
    rows = 4 * engine.cfg.batch_size
    return [_measured(f"serve_chunk[{rows}@{engine.cfg.precision}]",
                      "serve_engine", device,
                      lambda: engine.sample_encoded(rows, seed=1))]


def _fleet_family(device, root: str) -> list:
    from fed_tgan_torch.serve.fleet import (
        FleetService,
        _FleetRequest,
        _Member,
    )

    fleet = _artifact_engines(device, root, 2)
    members = []
    for i, name in enumerate(("t0", "t1")):
        rt = fleet.get(name)
        snap = rt.engine.snapshot()
        members.append(_Member(_FleetRequest(name, 2 * snap.cfg.batch_size,
                                             5 + i, 0, None, True),
                               rt, snap, 0, 0))
    svc = FleetService(fleet, max_lanes=2, log=lambda *a, **k: None)
    return [_measured("fleet_lanes[2x2]", "serve_fleet", device,
                      lambda: svc.lane_pass(members, 2))]


def _monitor_family(device) -> list:
    import numpy as np

    from fed_tgan_torch.train.monitor import SimilarityMonitor

    tr, tables = _small_trainer(device)
    real = {c: np.concatenate([t[c] for t in tables]) for c in tables[0]}
    mon = SimilarityMonitor(tr.init.global_meta, tr.init.encoders, real,
                            n_rows=400, seed=0, device=device)
    return [_measured("monitor_probe[400]", "monitor", device,
                      lambda: mon.evaluate(tr, seed=0))]


#: family -> the function (device, scratch directory) of its measured entries
FAMILIES = {
    "train_live": lambda device, root: _train_family(device),
    "serve_engine": _serve_family,
    "serve_fleet": _fleet_family,
    "monitor": lambda device, root: _monitor_family(device),
}


def port_cost_ledger(families=None, device="cuda",
                     ledger: CostLedger = None,
                     journal: bool = True) -> Dict[str, CostEntry]:
    """Run one small instance of each program family in ``families``
    (default: every one of :data:`FAMILIES`) on ``device`` and ledger its
    cost; each emits a ``program_cost`` event when a journal is installed
    and ``journal``.  Returns the entries keyed by program name."""
    import shutil
    import tempfile

    from fed_tgan_torch.device import resolve_device
    from fed_tgan_torch.obs.journal import emit as _emit_event

    device = resolve_device(device)
    ledger = ledger if ledger is not None else get_ledger()
    out: Dict[str, CostEntry] = {}
    root = tempfile.mkdtemp(prefix="fed_tgan_ledger_")
    try:
        for family in families or FAMILIES:
            for entry in FAMILIES[family](device, root):
                ledger.record(entry)
                out[entry.name] = entry
                if journal:
                    _emit_event("program_cost", **entry.to_dict())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def ledger_main(args) -> int:
    """``python -m fed_tgan_torch.obs ledger [--json] [--family F ...]
    [--device cuda|cpu]`` (``fed_tgan_tpu/obs/ledger.py:249-300``): run
    the families and print the ledger as JAX prints it."""
    import json

    if args.family:
        unknown = [f for f in args.family if f not in FAMILIES]
        if unknown:
            print(f"ledger: unknown families {unknown}; "
                  f"known: {sorted(FAMILIES)}")
            return 2
    try:
        entries = port_cost_ledger(families=args.family, device=args.device,
                                   journal=False)
    except RuntimeError as exc:  # no card where one was asked for
        print(f"ledger: {exc}")
        return 2
    if args.json:
        print(json.dumps({n: e.to_dict() for n, e in entries.items()},
                         indent=2, sort_keys=True))
        return 0
    print(f"{'program':<38} {'family':<16} {'Mflops':>10} "
          f"{'MB accessed':>12} {'peak MB':>9} {'donated MB':>11}")
    for name in sorted(entries):
        e = entries[name]
        print(f"{name:<38} {e.family:<16} {e.flops / 1e6:>10.2f} "
              f"{e.bytes_accessed / 1e6:>12.2f} "
              f"{e.peak_bytes / 1e6:>9.2f} "
              f"{e.donated_bytes / 1e6:>11.2f}")
    return 0
