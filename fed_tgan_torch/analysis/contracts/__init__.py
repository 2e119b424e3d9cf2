"""Program contracts of the port (counterpart of
``fed_tgan_tpu/analysis/contracts/``).

The lint (J01-J06, L01-L04) sees Python source; this package sees what an
entry point actually dispatches.  Every contracted entry point -- the
trainer's round chunks per variant, the aggregators and the
multi-process all-gather, the ingest fits, the serving chunks and the
fleet's lane dispatch -- is called once on small fixed inputs and its
dispatch recorded into a structured *fingerprint*: collectives with
their payload bytes, the boundary, host syncs and cross-device copies,
the dtype census, and K1/K2 calls.  Fingerprints are checked in as
``*.json`` next to this file (the CPU's, checked in tier-1) and under
``gpu/`` (the card's, with its copies), and enforced as a two-sided
ratchet: a regression (a sync, a copy, a collective, more bytes, more
kernel calls, an f64 op) fails; an improvement passes with a
stale-contract warning until ``--contracts-update`` re-records it.

Run ``python -m fed_tgan_torch.analysis --contracts [--backend gpu]``.

Submodules:

* :mod:`.ir`      -- the dispatch recorder and :class:`~.ir.Fingerprint`
  (torch imported by the recorder only);
* :mod:`.harness` -- every entry point family built from the cost
  ledger's small instances and recorded;
* :mod:`.check`   -- contract persistence, the two-sided diff,
  ``--explain`` with the op delta and call sites, the CLI exit codes.
"""

from fed_tgan_torch.analysis.contracts.ir import (  # noqa: F401
    DispatchRecorder,
    Fingerprint,
)

__all__ = ["DispatchRecorder", "Fingerprint"]
