"""Correctness tooling of the port (counterpart of
``fed_tgan_tpu/analysis/``).

* :mod:`fed_tgan_torch.analysis.lint` -- locklint: the stdlib-AST
  lockset rules L01-L04 (:mod:`~fed_tgan_torch.analysis.concurrency`)
  over the threaded serving plane, with a checked-in ratcheting
  baseline.  ``python -m fed_tgan_torch.analysis``.
* :mod:`fed_tgan_torch.analysis.telemetry` -- obslint: the telemetry
  contracts O01-O05 against ``obs/schema.json``.  ``python -m
  fed_tgan_torch.analysis --telemetry``.
* :mod:`fed_tgan_torch.analysis.sanitizers` -- opt-in runtime guards: a
  sync guard around the hot regions, a build counter with budgets, a
  determinism guard and a NaN guard (``--sanitize``,
  ``--sanitize-nans``).
* :mod:`fed_tgan_torch.analysis.lockwatch` -- the runtime deadlock
  sanitizer and lock metrics (``fleet --lockwatch``).

The JAX package's J01-J06 rules and its lowered-program contracts check
JAX idiom and XLA programs; they have no counterpart here.

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
