"""J05 -- unguarded shared mutable state (deprecation shim, as in
``fed_tgan_tpu/analysis/rules/shared_state.py``).

The lexical scan J05 was in the JAX package migrated into the
interprocedural lockset rule **L01** (``analysis/concurrency/``), which
the port already runs.  The id stays registered so ``--rules J05`` and
``# torchlint: disable=J05`` keep parsing, but ``check`` yields nothing.
"""

from __future__ import annotations

from typing import Iterator

RULE_ID = "J05"
HINT = ("J05 is deprecated: the interprocedural lockset rule L01 "
        "(analysis/concurrency/) now carries these findings")


class SharedStateRule:
    """Deprecation shim: registered for id/CLI compatibility, finds
    nothing.  See L01 in ``analysis/concurrency/rules.py``."""

    rule_id = RULE_ID
    title = "unguarded shared state (deprecated -> L01)"
    hint = HINT

    def check(self, mod) -> Iterator:
        return iter(())
