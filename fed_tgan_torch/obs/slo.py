"""SLO regression gate: check bench records / journals against budgets
(counterpart of ``fed_tgan_tpu/obs/slo.py:104-348``).

``python -m fed_tgan_torch.obs slo <input> [--budgets FILE]`` reads one
input -- a bench record JSON (single record or a ``{"records": [...]}``
bundle) or a run-journal JSONL -- and checks it against the budget file.
The exit codes are the JAX package's:

- **regression** (a budget violated)  -> exit 1
- **improvement** far inside a budget -> exit 0 + a *stale budget*
  warning telling the owner to re-seed the number
- pass / nothing matched              -> exit 0
- malformed budgets or input          -> exit 2

Budget file shape (``budgets.json`` beside this module is the default)::

    {"schema": 1, "budgets": [
        {"name": "quality-jsd-delta",        # unique label for output
         "select": {"metric_prefix": "...",  # optional (bench inputs)
                    "backend": "gpu"},       # optional backend gate
         "metric": "quality/jsd_delta",      # dotted path / figure key
         "max": 0.15,                        # or "min": <floor>
         "stale_frac": 0.0},                 # optional staleness knobs
        ...]}

The packaged budgets hold the JAX package's rules that are not speed
figures: the canary's three ``quality/*`` rules (which the promotion gate
reads too), the drift rules and ``churn-join-recompiles``.  JAX's speed
ceilings were measured on a CPU or a TPU and are not the card's, so none
is copied.

For bench inputs ``metric`` is a dotted path into the record;
``select.metric_prefix`` restricts the rule to records whose ``metric``
string starts with the prefix, and ``select.backend`` to records whose
top-level ``backend`` field matches (a record without the field counts as
``cpu``, as in the JAX package).  For journal inputs the events are first
folded into flat figures (:func:`journal_figures`):

- ``program_cost``  -> ``program/<name>/flops|bytes_accessed|peak_bytes``
  (last event per program wins)
- ``serve_stages``  -> ``stage/<stage>/p99_ms|p50_ms`` (worst observed)
- ``init_phase``    -> ``init/<phase>/seconds`` (summed)
- ``promotion_promoted`` / ``promotion_rejected`` ->
  ``quality/avg_jsd|avg_wd|jsd_delta|wd_delta|ml_acc_delta`` (worst
  observed)
- ``drift_window``    -> ``drift/windows|alarms_total|evicted_total``
  (counts), ``drift/max_jsd_rise|max_wd_rise|recompute_lag_rounds``
  (worst observed), ``drift/final_live`` (last event wins)
- ``client_joined`` / ``client_left`` -> ``churn/joins_total``,
  ``churn/join_repacks`` (admissions that forced a repack),
  ``churn/leaves_total``

and ``metric`` is looked up as an exact figure key.

Pure stdlib -- never imports torch or numpy.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Tuple

__all__ = ["check_slo", "check_figures", "default_budgets_path",
           "load_budgets", "slo_main"]

#: improvement thresholds that flag a budget as stale (overridable
#: per-rule): a value under ``stale_frac * max`` or over
#: ``stale_mult * min`` means the budget no longer bounds anything.
STALE_FRAC = 0.4
STALE_MULT = 2.5


class SLOError(Exception):
    """Malformed budgets or input -- maps to exit code 2."""


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


# ------------------------------------------------------------------ input


def _load_input(path: str) -> Tuple[str, object]:
    """Classify the input file: ('bench', [records]) or
    ('journal', [events])."""
    try:
        with open(path) as fh:
            text = fh.read()
    except OSError as exc:
        raise SLOError(f"cannot read input {path!r}: {exc}") from exc
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict):
        if isinstance(doc.get("records"), list):
            recs = [r for r in doc["records"] if isinstance(r, dict)]
            if recs:
                return "bench", recs
        if "metric" in doc:
            return "bench", [doc]
        raise SLOError(f"input {path!r}: JSON object is neither a bench "
                       "record nor a records bundle")
    # JSONL journal
    events = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            # torn tail line (crashed writer): skip with a warning, the
            # remaining events are still a valid gate input
            print(f"slo: warning: {path}: skipping truncated journal line "
                  f"({len(line)} bytes)", file=sys.stderr)
            continue
        if isinstance(ev, dict) and "type" in ev:
            events.append(ev)
    if not events:
        raise SLOError(f"input {path!r}: not a bench record and no "
                       "journal events parsed")
    return "journal", events


def journal_figures(events: List[dict]) -> Dict[str, float]:
    """Fold journal events into the flat figure map the rules read."""
    figures: Dict[str, float] = {}
    for ev in events:
        kind = ev.get("type")
        if kind == "program_cost":
            name = ev.get("name")
            if not name:
                continue
            for k in ("flops", "bytes_accessed", "peak_bytes",
                      "argument_bytes", "temp_bytes"):
                if k in ev:
                    figures[f"program/{name}/{k}"] = float(ev[k] or 0)
        elif kind == "serve_stages":
            stages = ev.get("stages")
            if not isinstance(stages, dict):
                continue
            for stage, st in stages.items():
                if not isinstance(st, dict):
                    continue
                for k in ("p50_ms", "p99_ms"):
                    if k in st:
                        key = f"stage/{stage}/{k}"
                        val = float(st[k] or 0)
                        figures[key] = max(figures.get(key, 0.0), val)
        elif kind == "init_phase":
            phase = ev.get("phase")
            if not phase:
                continue
            key = f"init/{phase}/seconds"
            figures[key] = figures.get(key, 0.0) + float(
                ev.get("seconds", 0) or 0)
        elif kind in ("promotion_promoted", "promotion_rejected"):
            # worst observed shadow score / delta across the run; keys
            # match the canary gate's own figure names, so the same
            # quality/* budget rules gate live promotion AND this
            # offline re-check of a journal
            for k in ("avg_jsd", "avg_wd", "jsd_delta", "wd_delta",
                      "ml_acc_delta"):
                if isinstance(ev.get(k), (int, float)):
                    key = f"quality/{k}"
                    val = float(ev[k])
                    figures[key] = max(figures.get(key, val), val)
        elif kind == "drift_window":
            figures["drift/windows"] = figures.get("drift/windows", 0.0) + 1
            figures["drift/alarms_total"] = (
                figures.get("drift/alarms_total", 0.0)
                + float(ev.get("alarms", 0) or 0))
            evicted = ev.get("evicted")
            figures["drift/evicted_total"] = (
                figures.get("drift/evicted_total", 0.0)
                + float(len(evicted) if isinstance(evicted, list) else 0))
            for k in ("max_jsd_rise", "max_wd_rise",
                      "recompute_lag_rounds"):
                if isinstance(ev.get(k), (int, float)):
                    key = f"drift/{k}"
                    val = float(ev[k])
                    figures[key] = max(figures.get(key, val), val)
            if isinstance(ev.get("live"), (int, float)):
                figures["drift/final_live"] = float(ev["live"])
        elif kind == "client_joined":
            figures["churn/joins_total"] = (
                figures.get("churn/joins_total", 0.0) + 1)
            figures["churn/join_repacks"] = (
                figures.get("churn/join_repacks", 0.0)
                + float(bool(ev.get("repacked"))))
        elif kind == "client_left":
            figures["churn/leaves_total"] = (
                figures.get("churn/leaves_total", 0.0) + 1)
    return figures


def _dotted(record: dict, path: str):
    cur: object = record
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


# ------------------------------------------------------------------ check


def _check_rule(rule: dict, value: float, where: str,
                lines: List[str]) -> Tuple[int, int]:
    """Returns (regressions, stale_warnings) for one matched value."""
    name = rule.get("name", rule["metric"])
    reg = stale = 0
    if "max" in rule:
        ceil = float(rule["max"])
        if value > ceil:
            lines.append(f"REGRESSION {name}: {value:g} > max {ceil:g} "
                         f"({where})")
            reg += 1
        elif value < ceil * float(rule.get("stale_frac", STALE_FRAC)):
            lines.append(f"stale budget {name}: {value:g} is far below "
                         f"max {ceil:g} ({where}) -- re-seed the budget "
                         "to lock in the improvement")
            stale += 1
        else:
            lines.append(f"ok {name}: {value:g} <= max {ceil:g} ({where})")
    if "min" in rule:
        floor = float(rule["min"])
        if value < floor:
            lines.append(f"REGRESSION {name}: {value:g} < min {floor:g} "
                         f"({where})")
            reg += 1
        elif value > floor * float(rule.get("stale_mult", STALE_MULT)):
            lines.append(f"stale budget {name}: {value:g} is far above "
                         f"min {floor:g} ({where}) -- re-seed the budget "
                         "to lock in the improvement")
            stale += 1
        else:
            lines.append(f"ok {name}: {value:g} >= min {floor:g} ({where})")
    return reg, stale


def check_figures(figures: Dict[str, float], rules: List[dict],
                  where: str = "journal"
                  ) -> Tuple[int, int, int, List[str]]:
    """Evaluate budget rules against an already-folded figure map.

    The live half of the gate: ``obs watch`` re-folds the journal every
    K rounds and calls this in memory, without re-reading budgets or
    touching disk.  Returns ``(regressions, stale, matched, lines)``.
    """
    lines: List[str] = []
    regressions = stale = matched = 0
    for rule in rules:
        value = figures.get(rule["metric"])
        if value is None:
            continue
        matched += 1
        r, s = _check_rule(rule, value, where, lines)
        regressions += r
        stale += s
    return regressions, stale, matched, lines


def check_slo(input_path: str, budgets_path: str) -> Tuple[int, List[str]]:
    """Check one input against the budget file.

    Returns ``(exit_code, report_lines)``; raises :class:`SLOError`
    (exit 2 territory) on malformed budgets or input.
    """
    rules = load_budgets(budgets_path)
    kind, payload = _load_input(input_path)
    lines: List[str] = []
    regressions = stale = matched = 0
    if kind == "bench":
        records: List[dict] = payload  # type: ignore[assignment]
        for rule in rules:
            select = rule.get("select") or {}
            prefix = select.get("metric_prefix", "")
            want_backend = select.get("backend")
            for rec in records:
                metric = str(rec.get("metric", ""))
                if prefix and not metric.startswith(prefix):
                    continue
                # a record without a backend field counts as "cpu", as
                # in the JAX package
                if want_backend and str(
                        rec.get("backend", "cpu")) != want_backend:
                    continue
                value = _dotted(rec, rule["metric"])
                if not isinstance(value, (int, float)):
                    continue
                matched += 1
                r, s = _check_rule(rule, float(value), metric, lines)
                regressions += r
                stale += s
    else:
        figures = journal_figures(payload)  # type: ignore[arg-type]
        r, s, m, rule_lines = check_figures(figures, rules)
        regressions += r
        stale += s
        matched += m
        lines.extend(rule_lines)
    if not matched:
        lines.append(f"warning: no budget rule matched {input_path!r} "
                     f"({kind} input, {len(rules)} rules)")
    summary = (f"slo: {matched} checked, {regressions} regressions, "
               f"{stale} stale budgets")
    lines.append(summary)
    return (1 if regressions else 0), lines


def slo_main(args) -> int:
    """Entry point for the ``obs slo`` subcommand (argparse namespace
    with ``input`` and ``budgets``)."""
    budgets = args.budgets or default_budgets_path()
    try:
        code, lines = check_slo(args.input, budgets)
    except SLOError as exc:
        print(f"slo: {exc}")
        return 2
    for line in lines:
        print(line)
    return code
