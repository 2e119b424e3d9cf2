"""Budget rules for the canary's promotion gate (counterpart of
``fed_tgan_tpu/obs/slo.py:73-101``).

``budgets.json`` beside this module holds the JAX package's three
``quality/*`` rules as they stand there: a candidate is rejected when its
Avg_JSD or Avg_WD is more than 0.15 worse than the serving model's, or
its ML-efficacy accuracy more than 0.2 lower.  The SLO CLI, the journal
fold and ``check_figures`` are not ported yet (ROADMAP A.20).
"""

from __future__ import annotations

import json
import os
from typing import List

__all__ = ["SLOError", "default_budgets_path", "load_budgets"]


class SLOError(Exception):
    """Malformed budgets."""


def default_budgets_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "budgets.json")


def load_budgets(path: str) -> List[dict]:
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        raise SLOError(f"cannot read budgets {path!r}: {exc}") from exc
    if not isinstance(doc, dict) or not isinstance(doc.get("budgets"), list):
        raise SLOError(f"budgets {path!r}: expected "
                       '{"budgets": [...]} document')
    rules = doc["budgets"]
    for i, rule in enumerate(rules):
        if not isinstance(rule, dict) or "metric" not in rule:
            raise SLOError(f"budgets {path!r}: rule #{i} needs a 'metric'")
        if "min" not in rule and "max" not in rule:
            raise SLOError(f"budgets {path!r}: rule "
                           f"{rule.get('name', i)!r} needs 'min' or 'max'")
    return rules
