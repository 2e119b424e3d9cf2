"""Correctness tooling of the port (counterpart of
``fed_tgan_tpu/analysis/``).

* :mod:`fed_tgan_torch.analysis.lint` -- the static lint: the stdlib-AST
  rules J01-J06 (:mod:`~fed_tgan_torch.analysis.rules`: JAX's ids in
  torch idiom -- host syncs in hot loops, draws without a generator,
  rebuilds and value branches in hot code, numpy on device tensors, the
  J05 shim, float64 on the device) and the lockset rules L01-L04
  (:mod:`~fed_tgan_torch.analysis.concurrency`), with a checked-in
  ratcheting baseline.  ``python -m fed_tgan_torch.analysis``.
* :mod:`fed_tgan_torch.analysis.telemetry` -- obslint: the telemetry
  contracts O01-O05 against ``obs/schema.json``.  ``python -m
  fed_tgan_torch.analysis --telemetry``.
* :mod:`fed_tgan_torch.analysis.sanitizers` -- opt-in runtime guards: a
  sync guard around the hot regions, a build counter with budgets, a
  determinism guard and a NaN guard (``--sanitize``,
  ``--sanitize-nans``).
* :mod:`fed_tgan_torch.analysis.lockwatch` -- the runtime deadlock
  sanitizer and lock metrics (``fleet --lockwatch``).
* :mod:`fed_tgan_torch.analysis.contracts` -- the program contracts: every
  contracted entry point dispatched once on small fixed inputs and its
  fingerprint (collectives, boundary, syncs, cross-device copies, dtype
  census, K1/K2 calls) ratcheted against checked-in JSON, the CPU's and
  the card's.  ``python -m fed_tgan_torch.analysis --contracts
  [--backend gpu]``; ``--all`` runs the three prongs.

This ``__init__`` stays import-light (no torch, no numpy) so the lint
gate starts instantly.
"""

from fed_tgan_torch.analysis.lint import (  # noqa: F401
    DEFAULT_BASELINE_PATH,
    Finding,
    LintError,
    apply_baseline,
    load_baseline,
    run_lint,
    save_baseline,
)

__all__ = [
    "DEFAULT_BASELINE_PATH",
    "Finding",
    "LintError",
    "apply_baseline",
    "load_baseline",
    "run_lint",
    "save_baseline",
]
