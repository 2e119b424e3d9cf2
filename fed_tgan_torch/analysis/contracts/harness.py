"""Every contracted entry point, dispatched once and recorded
(counterpart of ``fed_tgan_tpu/analysis/contracts/harness.py``).

The JAX harness AOT-lowers each jitted entry point on a virtual 8-device
CPU mesh.  The port compiles nothing, so each program here is one call of
the entry point the production caller makes, built from the small
instances the port's cost ledger already runs (``obs/ledger.py``'s small
2-client table and config) and recorded by
:class:`~fed_tgan_torch.analysis.contracts.ir.DispatchRecorder` after one
warm-up call (the first call builds what later calls reuse: the contract
is the steady state).  The six families keep JAX's names and, program by
program, JAX's names:

* ``train_federated``: one 2-round chunk of the in-process trainer
  (``FederatedTrainer._dispatch_chunk``) per aggregator variant;
* ``fused_rounds``: a chunk of K = 1, 2, 4 rounds
  (``--rounds-per-program K``), float32 and bf16;
* ``cohort_rounds``: a 2-round chunk of a fixed cohort of 8 drawn from a
  population of 16, 32 and 64 (the small clients tiled);
* ``parallel_fedavg``: the aggregators of ``parallel/fedavg.py`` over 8
  stacked clients, float32 and the bf16 payload, plus
  ``gather_leaves[f32]``: a participant's all-gather of
  ``parallel/multihost.py`` in a 1-rank gloo world (the only program with
  a collective);
* ``ingest``: the batched mixture fit (``features/bgm.py::fit_columns``)
  at two bucket shapes and the WD weights (``federation/sketch.py::
  wd_scores``) at two populations;
* ``serve_engine``: ``SamplingEngine.sample_decoded`` chunks of 1 and 4
  steps, conditional or not, float32 and bf16, and a 2-lane fleet
  dispatch (``FleetService.lane_pass``) on the caller's thread: a
  dispatch mode sees only the thread that enters it.

Every shape is fixed and every draw seeded, so a contract is the same
between runs, processes and thread counts.  Torch and numpy are imported
lazily, so the lint prong of ``python -m fed_tgan_torch.analysis`` keeps
its torch-free startup.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from fed_tgan_torch.analysis.contracts.ir import DispatchRecorder, Fingerprint

__all__ = [
    "ENTRYPOINT_FAMILIES",
    "HarnessError",
    "PROGRAM_REQUIREMENTS",
    "Program",
    "record_fingerprints",
]

N_CLIENTS = 8  #: stacked clients of the aggregation programs (JAX's mesh)
COHORT = 8     #: the cohort_rounds family's fixed cohort


class HarnessError(RuntimeError):
    """The programs cannot be recorded here (CLI exit code 2)."""


@dataclass
class Program:
    """One entry point call: ``call()`` dispatches it and returns what the
    entry point returns; ``inputs`` are the tensors and arrays it is
    handed (the boundary's input side); ``close()``, when given, runs
    after the recording."""

    call: Callable[[], object]
    inputs: object = ()
    close: Optional[Callable[[], None]] = None


class Harness:
    """What the builders share: the device, a scratch directory, and the
    small init, built once."""

    def __init__(self, device):
        self.device = device
        self.root = tempfile.mkdtemp(prefix="fed_tgan_contracts_")
        self._init = None

    def init(self):
        from fed_tgan_torch.obs.ledger import _small_init

        if self._init is None:
            self._init = _small_init(self.device)[0]
        return self._init

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


# ------------------------------------------------------------- training

#: trainer variants: config overrides of ``obs/ledger.py``'s small config
_EPOCH_VARIANTS = {
    "weighted": dict(update_gate=False),
    "gated": dict(),
    "median": dict(aggregator="median"),
    "ema": dict(update_gate=False, ema_decay=0.999),
    "weighted@bf16": dict(update_gate=False, precision="bf16"),
    "gated@bf16": dict(precision="bf16"),
}


def _population(init, n: int):
    """``init`` with its clients tiled to ``n`` (uniform weights): a
    population without an init per client."""
    import numpy as np

    k = len(init.client_matrices)
    tile = lambda xs: [xs[i % k] for i in range(n)]  # noqa: E731
    return dataclasses.replace(
        init, client_matrices=tile(init.client_matrices),
        transformers=tile(init.transformers),
        rows_per_client=tile(list(init.rows_per_client)),
        weights=np.full(n, 1.0 / n), jsd=np.zeros(n), wd=np.zeros(n))


def _chunk(h: Harness, rounds: int, init=None, **overrides) -> Program:
    """A chunk of ``rounds`` rounds of the in-process trainer, its round
    index advancing from call to call as in a run."""
    from fed_tgan_torch.obs.ledger import _small_config
    from fed_tgan_torch.train.federated import FederatedTrainer

    tr = FederatedTrainer(init if init is not None else h.init(),
                          _small_config(**overrides), seed=3,
                          device=h.device)
    first = [0]

    def call():
        e, first[0] = first[0], first[0] + rounds
        return tr._dispatch_chunk(e, rounds, None, None)

    return Program(call)


def _epoch(h: Harness, variant: str) -> Program:
    return _chunk(h, 2, **_EPOCH_VARIANTS[variant])


def _fused_rounds(h: Harness, k: int, precision: str = "f32") -> Program:
    return _chunk(h, k, precision=precision)


def _cohort(h: Harness, n: int) -> Program:
    return _chunk(h, 2, init=_population(h.init(), n), cohort=COHORT)


# ---------------------------------------------------------- aggregation

def _agg_inputs(device):
    """prev (no client axis), the stacked (8, ...) new leaves, weights and
    steps, as the aggregators see them inside a round."""
    import torch

    prev = [torch.zeros((4, 3), device=device), torch.zeros(4, device=device)]
    new = [torch.ones((N_CLIENTS, 4, 3), device=device),
           torch.ones((N_CLIENTS, 4), device=device)]
    weights = torch.full((N_CLIENTS,), 1.0 / N_CLIENTS, device=device)
    steps = torch.ones(N_CLIENTS, dtype=torch.int64, device=device)
    return prev, new, weights, steps


def _weighted(h: Harness) -> Program:
    from fed_tgan_torch.parallel.fedavg import weighted_average

    prev, new, w, _ = _agg_inputs(h.device)
    return Program(lambda: weighted_average(new, w), (new, w))


def _weighted_delta(h: Harness) -> Program:
    from fed_tgan_torch.parallel.fedavg import weighted_delta_average

    prev, new, w, _ = _agg_inputs(h.device)
    return Program(lambda: weighted_delta_average(prev, new, w),
                   (prev, new, w))


def _robust(h: Harness, aggregator: str, bf16: bool = False) -> Program:
    import torch

    from fed_tgan_torch.parallel.fedavg import robust_aggregate

    args = _agg_inputs(h.device)
    payload = torch.bfloat16 if bf16 else None
    return Program(lambda: robust_aggregate(*args, aggregator=aggregator,
                                            payload_dtype=payload), args)


def _gather(h: Harness) -> Program:
    """A participant's round all-gather (``train/multihost.py``) of one
    1-slot stack's leaves, in a 1-rank gloo world of this process."""
    import torch
    import torch.distributed as dist

    from fed_tgan_torch.parallel import multihost

    if dist.is_initialized():
        raise HarnessError("a process group is already initialized in this "
                           "process: the gather needs a world of its own")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    saved = multihost._group, multihost._backend
    multihost._group, multihost._backend = dist.new_group(ranks=[0]), "gloo"
    leaves = [torch.ones((1, 4, 3), device=h.device),
              torch.ones((1, 4), device=h.device)]

    def call():
        return multihost.gather_leaves(leaves)

    def close():
        multihost._group, multihost._backend = saved
        dist.destroy_process_group()

    return Program(call, leaves, close=close)


# --------------------------------------------------------------- ingest

def _ingest_fit(h: Harness, batch: int, rows: int) -> Program:
    """``batch`` columns of ``rows`` rows: one bucket of the batched fit."""
    import numpy as np

    from fed_tgan_torch.features.bgm import fit_columns

    rng = np.random.default_rng(0)
    cols = [rng.normal(i % 3, 1.0 + i % 2, rows).astype(np.float32)
            for i in range(batch)]
    return Program(lambda: [vars(g) for g in fit_columns(
        cols, device=h.device)], cols)


def _ingest_wd(h: Harness, n: int) -> Program:
    """The WD weights of ``n`` clients' mixtures (2 columns, 10 modes)."""
    import torch

    from fed_tgan_torch.federation.sketch import GRID_POINTS, wd_scores

    c, k, dev = 2, 10, h.device
    args = (torch.zeros((n, c, k), device=dev),
            torch.ones((n, c, k), device=dev),
            torch.full((n, c, k), 1.0 / k, device=dev),
            torch.full((n,), 1.0 / n, device=dev),
            torch.linspace(-3.0, 3.0, GRID_POINTS, device=dev).repeat(c, 1))
    return Program(lambda: wd_scores(*args), args)


# -------------------------------------------------------------- serving

def bucket_name(n_steps: int, conditional: bool, precision: str = "f32",
                lanes: int = 1) -> str:
    """JAX's serve bucket program names (``fed_tgan_tpu/serve/naming.py``):
    ``serve_bucket_<steps>[_cond][_bf16][_x<lanes>]``."""
    return (f"serve_bucket_{n_steps}{'_cond' if conditional else ''}"
            f"{'' if precision == 'f32' else '_' + precision}"
            f"{f'_x{lanes}' if lanes > 1 else ''}")


def _fleet(h: Harness, precision: str, tenants: int):
    """``tenants`` tenants of one small random-weight Adult-layout
    artifact (``serve/demo.py``) in a fleet on the harness's device."""
    import os

    from fed_tgan_torch.obs.ledger import _small_config
    from fed_tgan_torch.serve.demo import build_random_artifact
    from fed_tgan_torch.serve.fleet import FleetRegistry

    root = os.path.join(h.root, f"serve_{precision}")
    if not os.path.isdir(root):
        build_random_artifact(root, seed=0, table="adult",
                              cfg=_small_config(precision))
    fleet = FleetRegistry(device=h.device, log=lambda *a, **k: None)
    for i in range(tenants):
        fleet.load(f"t{i}", root)
    return fleet


def _serve(h: Harness, n_steps: int, conditional: bool,
           precision: str = "f32") -> Program:
    engine = _fleet(h, precision, 1).get("t0").engine
    rows = n_steps * engine.cfg.batch_size
    cond = 0 if conditional else None
    return Program(lambda: engine.sample_decoded(rows, seed=1,
                                                 condition=cond))


def _serve_lanes(h: Harness, n_steps: int, conditional: bool,
                 lanes: int = 2) -> Program:
    from fed_tgan_torch.serve.fleet import (
        FleetService,
        _FleetRequest,
        _Member,
    )

    fleet = _fleet(h, "f32", lanes)
    members = []
    for i in range(lanes):
        rt = fleet.get(f"t{i}")
        snap = rt.engine.snapshot()
        req = _FleetRequest(f"t{i}", n_steps * snap.cfg.batch_size, 5 + i, 0,
                            0 if conditional else None, True)
        members.append(_Member(req, rt, snap, 0, 0))
    svc = FleetService(fleet, max_lanes=lanes, log=lambda *a, **k: None)
    return Program(lambda: svc.lane_pass(members, n_steps))


# ------------------------------------------------------------- registry

#: family -> {program name -> builder(harness) returning a Program}.
#: Contract JSON files are named after the family keys.
ENTRYPOINT_FAMILIES: Dict[str, Dict[str, Callable]] = {
    "train_federated": {
        f"fused_epoch[{v}]": (lambda h, v=v: _epoch(h, v))
        for v in _EPOCH_VARIANTS
    },
    "fused_rounds": {
        **{f"fused_rounds[{k}]": (lambda h, k=k: _fused_rounds(h, k))
           for k in (1, 2, 4)},
        **{f"fused_rounds[{k}@bf16]":
           (lambda h, k=k: _fused_rounds(h, k, "bf16"))
           for k in (1, 2, 4)},
    },
    "cohort_rounds": {
        f"cohort_rounds[n{n}]": (lambda h, n=n: _cohort(h, n))
        for n in (16, 32, 64)
    },
    "parallel_fedavg": {
        "fedavg[weighted_psum]": _weighted,
        "fedavg[weighted_delta_bf16]": _weighted_delta,
        **{f"robust_agg[{a}]": (lambda h, a=a: _robust(h, a))
           for a in ("weighted", "clipped", "trimmed", "median")},
        **{f"robust_agg[{a}@bf16]": (lambda h, a=a: _robust(h, a, True))
           for a in ("weighted", "clipped", "trimmed", "median")},
        "gather_leaves[f32]": _gather,
    },
    "ingest": {
        **{f"ingest_fit[b{b}xr{r}]":
           (lambda h, b=b, r=r: _ingest_fit(h, b, r))
           for b, r in ((8, 128), (64, 128))},
        **{f"ingest_wd[n{n}]": (lambda h, n=n: _ingest_wd(h, n))
           for n in (8, 64)},
    },
    "serve_engine": {
        **{bucket_name(n, c, p): (lambda h, n=n, c=c, p=p: _serve(h, n, c, p))
           for p in ("f32", "bf16") for n in (1, 4) for c in (False, True)},
        **{bucket_name(n, c, lanes=2):
           (lambda h, n=n, c=c: _serve_lanes(h, n, c))
           for n in (1, 4) for c in (False, True)},
    },
}


#: program -> REQUIRED properties, attached to the contract JSON by
#: ``save_contracts`` and re-evaluated against the CURRENT fingerprints on
#: every run (JAX's requirements carried to the port's fields):
#:
#: * ``dtypes_present``: the census must contain these dtypes -- a bf16
#:   program keeps its bf16 compute and its float32 islands;
#: * ``dispatch_scale {vs, rounds}`` (JAX's ``collective_bytes_scale``): a
#:   chunk of K rounds calls the kernels exactly K x the single-round
#:   chunk, and keeps its syncs, copies and collectives: one host copy per
#:   chunk, whatever K;
#: * ``independent_of {vs}`` (JAX's ``collective_bytes_independent``):
#:   kernel calls, syncs, copies and collectives equal the named smallest
#:   sibling's -- a cohort round is O(cohort) whatever the population, an
#:   ingest dispatch is one batch whatever its size.
#:
#: JAX's ``max_collective_bytes_ratio`` (bf16 payload vs its f32 twin) and
#: ``donation_required`` (the serve buckets' donated output scratch) have
#: no counterpart: ROADMAP section C says why.
PROGRAM_REQUIREMENTS: Dict[str, Dict[str, dict]] = {
    "train_federated": {
        f"fused_epoch[{v}@bf16]": {"dtypes_present": ["bf16", "f32"]}
        for v in ("weighted", "gated")
    },
    "fused_rounds": {
        **{f"fused_rounds[{k}]": {
            "dispatch_scale": {"vs": "fused_rounds[1]", "rounds": k},
           } for k in (2, 4)},
        "fused_rounds[1@bf16]": {"dtypes_present": ["bf16", "f32"]},
        **{f"fused_rounds[{k}@bf16]": {
            "dtypes_present": ["bf16", "f32"],
            "dispatch_scale": {"vs": "fused_rounds[1@bf16]", "rounds": k},
           } for k in (2, 4)},
    },
    "cohort_rounds": {
        f"cohort_rounds[n{n}]": {
            "independent_of": {"vs": "cohort_rounds[n16]"},
        } for n in (32, 64)
    },
    "parallel_fedavg": {
        "fedavg[weighted_delta_bf16]": {"dtypes_present": ["bf16", "f32"]},
        **{f"robust_agg[{a}@bf16]": {"dtypes_present": ["bf16", "f32"]}
           for a in ("weighted", "clipped", "trimmed", "median")},
    },
    "ingest": {
        "ingest_fit[b64xr128]": {
            "independent_of": {"vs": "ingest_fit[b8xr128]"}},
        "ingest_wd[n64]": {"independent_of": {"vs": "ingest_wd[n8]"}},
    },
    "serve_engine": {
        bucket_name(n, c, "bf16"): {"dtypes_present": ["bf16", "f32"]}
        for n in (1, 4) for c in (False, True)
    },
}


def record_fingerprints(
    families: Optional[Dict[str, Dict[str, Callable]]] = None,
    device="cpu",
) -> Dict[str, Dict[str, Fingerprint]]:
    """Dispatch every program of ``families`` (default: the registry) on
    ``device`` once to warm it (what a first call builds, later calls
    reuse), then once recorded.  Raises
    :class:`HarnessError` when the device is missing or a program cannot
    be built or run."""
    import torch

    from fed_tgan_torch.device import resolve_device

    try:
        device = resolve_device(device)
    except RuntimeError as exc:
        raise HarnessError(str(exc)) from exc
    out: Dict[str, Dict[str, Fingerprint]] = {}
    h = Harness(device)
    try:
        for family, programs in (families or ENTRYPOINT_FAMILIES).items():
            out[family] = {}
            for name, make in programs.items():
                try:
                    prog = make(h)
                except HarnessError:
                    raise
                except Exception as exc:
                    raise HarnessError(f"{family}/{name}: {exc!r}") from exc
                try:
                    prog.call()
                    with DispatchRecorder(device) as rec:
                        result = prog.call()
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    out[family][name] = rec.fingerprint(prog.inputs, result)
                except Exception as exc:
                    raise HarnessError(f"{family}/{name}: {exc!r}") from exc
                finally:
                    if prog.close is not None:
                        prog.close()
    finally:
        h.close()
    return out
