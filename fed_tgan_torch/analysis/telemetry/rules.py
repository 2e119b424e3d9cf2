"""obslint rules O01-O05: cross-check the extraction against the
schema registry, the budget file, and the fault-kind vocabulary
(counterpart of ``fed_tgan_tpu/analysis/telemetry/rules.py``).

- **O01** emit-site contract: event type missing from the registry, or
  a closed emit site missing one of the event's required fields.
- **O02** dead contract: a registry event/field no emitter produces, or
  a report/slo/watch consumer selecting an unknown event type / reading
  a field no emit site writes.  An event whose every field is
  ``external`` (written outside this package: ``backend_probe`` and
  ``backend_plugin_registered``, which only the JAX package's journals
  carry until the port has a backend probe) needs no emit site.
- **O03** metric-name drift: a ``counter/gauge/histogram`` call site
  absent from the catalogue, a name registered under conflicting kinds,
  an uncatalogued label key, or an unbounded label value expression
  (cardinality hazard; the ``*_CAP``-guarded client-label idiom is
  exempt).
- **O04** stale-by-construction budget: a ``budgets.json``
  ``select.metric_prefix`` no bench record writer can match, a
  ``select.backend`` outside the catalogue, or a journal-figure rule
  whose ``metric`` no ``journal_figures`` fold can produce.
- **O05** fault-spec drift: a ``kind:key=value`` fault reference in
  tests/docs/scripts that ``testing/faults.py`` cannot parse, or a
  registry ``fault_kinds`` list out of sync with ``VALID_KINDS``.

Findings reuse the lint runner's ``Finding``/baseline/suppression
machinery;
JSON-file findings (schema.json, budgets.json) are located by scanning
the raw text for the offending key, so they are clickable too.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from fed_tgan_torch.analysis.lint import (
    Finding,
    LintError,
    REPO_ROOT,
    _SUPPRESS_RE,
)
from fed_tgan_torch.analysis.telemetry.extract import (
    Extraction,
    MetricSite,
    extract_repo,
)
from fed_tgan_torch.analysis.telemetry.schema import (
    DEFAULT_SCHEMA_PATH,
    load_schema,
)

__all__ = ["RULE_IDS", "RULE_TITLES", "run_telemetry"]

RULE_IDS = ("O01", "O02", "O03", "O04", "O05")

RULE_TITLES = {
    "O01": "emit site outside the event registry",
    "O02": "dead telemetry contract",
    "O03": "metric-name drift",
    "O04": "stale-by-construction budget selector",
    "O05": "fault-spec drift",
}

_HINTS = {
    "O01": "add the event/field to obs/schema.json (--schema-update "
           "discovers it) or fix the emit site",
    "O02": "remove the dead registry entry / consumer read, or add the "
           "missing emitter",
    "O03": "catalogue the metric in obs/schema.json, or bound the label "
           "with the *_CAP idiom",
    "O04": "fix the budgets.json selector to a prefix a producer can "
           "match, or delete the rule",
    "O05": "use a kind testing/faults.py parses (see VALID_KINDS)",
}


def _rel(path: Path) -> str:
    try:
        return path.resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return path.as_posix()


def _json_line(text: str, needle: str) -> int:
    for i, line in enumerate(text.splitlines(), 1):
        if needle in line:
            return i
    return 1


def _finding(rule: str, path: str, line: int, message: str) -> Finding:
    return Finding(rule=rule, path=path, line=line, message=message,
                   hint=_HINTS[rule])


# ------------------------------------------------------------ matching


def _event_known_fields(ev: dict) -> Set[str]:
    return set(ev["required"]) | set(ev["optional"]) | set(ev["external"])


def _external_only(ev: dict) -> bool:
    """Every field of the event is written outside the static view."""
    return bool(ev["external"]) and not ev["required"] and not ev["optional"]


def _match_metric(metrics: dict, site: MetricSite) -> Optional[str]:
    if not site.dynamic and site.name in metrics:
        return site.name
    for key in metrics:
        if not key.endswith("*"):
            continue
        p = key[:-1]
        if site.name.startswith(p) or (site.dynamic and p.startswith(
                site.name)):
            return key
    return None


def _match_prefix(sel: str, producers: Sequence[str]) -> bool:
    """Bidirectional prefix match: the selector restricts record
    ``metric`` strings, producers are static names/prefixes that gain
    runtime suffixes (bgm/rpp tags), so either side may be longer."""
    for p in producers:
        p = p[:-1] if p.endswith("*") else p
        if p.startswith(sel) or sel.startswith(p):
            return True
    return False


def _match_figure(metric: str, figures: Sequence[str]) -> bool:
    for f in figures:
        if f.endswith("*"):
            if metric.startswith(f[:-1]):
                return True
        elif metric == f:
            return True
    return False


# --------------------------------------------------------------- rules


def _check_emits(ex: Extraction, schema: dict,
                 out: List[Finding]) -> int:
    covered = 0
    events = schema["events"]
    for site in ex.emits:
        ev = events.get(site.event)
        if ev is None:
            out.append(_finding(
                "O01", site.path, site.line,
                f"emit site for unknown event type {site.event!r} "
                f"(not in obs/schema.json)"))
            continue
        covered += 1
        if site.open:
            continue
        missing = sorted(set(ev["required"]) - set(site.fields))
        if missing:
            out.append(_finding(
                "O01", site.path, site.line,
                f"emit site for {site.event!r} missing required "
                f"field(s) {', '.join(missing)}"))
    return covered


def _check_dead_contracts(ex: Extraction, schema: dict,
                          out: List[Finding], repo_wide: bool) -> None:
    events = schema["events"]
    by_event: Dict[str, list] = {}
    for site in ex.emits:
        by_event.setdefault(site.event, []).append(site)
    if repo_wide:
        schema_path = DEFAULT_SCHEMA_PATH
        text = schema_path.read_text() if schema_path.exists() else ""
        rel = _rel(schema_path)
        for name, ev in sorted(events.items()):
            sites = by_event.get(name, [])
            if not sites and _external_only(ev):
                continue
            if not sites:
                out.append(_finding(
                    "O02", rel, _json_line(text, f'"{name}"'),
                    f"registry event {name!r} has no emit site in the "
                    "tree (dead contract)"))
                continue
            if any(s.open for s in sites) or ev["open"]:
                continue
            written = {f for s in sites for f in s.fields}
            dead = sorted((set(ev["required"]) | set(ev["optional"]))
                          - written)
            if dead:
                out.append(_finding(
                    "O02", rel, _json_line(text, f'"{name}"'),
                    f"registry field(s) {', '.join(dead)} of event "
                    f"{name!r} are written by no emit site (move to "
                    f"'external' or delete)"))
    for flt in ex.filters:
        if flt.event not in events:
            out.append(_finding(
                "O02", flt.path, flt.line,
                f"consumer selects unknown event type {flt.event!r}"))
    for read in ex.reads:
        ev = events.get(read.event)
        if ev is None:
            continue  # the filter site already carries the finding
        if ev["open"]:
            continue
        written = {f for s in by_event.get(read.event, ())
                   for f in s.fields}
        if read.field not in _event_known_fields(ev) | written:
            out.append(_finding(
                "O02", read.path, read.line,
                f"consumer reads field {read.field!r} of event "
                f"{read.event!r} that no emit site writes"))


def _check_metrics(ex: Extraction, schema: dict,
                   out: List[Finding]) -> int:
    covered = 0
    metrics = schema["metrics"]
    kind_by_name: Dict[str, MetricSite] = {}
    for site in ex.metrics:
        key = _match_metric(metrics, site)
        if key is None:
            name = site.name + ("*" if site.dynamic else "")
            out.append(_finding(
                "O03", site.path, site.line,
                f"{site.kind} call site {name!r} not in the metric "
                "catalogue"))
        else:
            covered += 1
            entry = metrics[key]
            if entry["kind"] != site.kind:
                out.append(_finding(
                    "O03", site.path, site.line,
                    f"metric {site.name!r} registered as {site.kind} "
                    f"but catalogued as {entry['kind']}"))
            unknown = sorted(set(site.labels) - set(entry["labels"]))
            if unknown:
                out.append(_finding(
                    "O03", site.path, site.line,
                    f"metric {site.name!r} uses uncatalogued label "
                    f"key(s) {', '.join(unknown)}"))
        prev = kind_by_name.get(site.name)
        if prev is not None and prev.kind != site.kind:
            out.append(_finding(
                "O03", site.path, site.line,
                f"metric {site.name!r} registered as {site.kind} here "
                f"but as {prev.kind} at {prev.path}:{prev.line}"))
        else:
            kind_by_name.setdefault(site.name, site)
        for key_ in site.unbounded:
            out.append(_finding(
                "O03", site.path, site.line,
                f"label {key_!r} of metric {site.name!r} takes an "
                "unbounded value expression (cardinality hazard)"))
    return covered


def _check_budgets(ex: Extraction, schema: dict, budgets_path: Path,
                   out: List[Finding]) -> None:
    try:
        text = budgets_path.read_text()
        doc = json.loads(text)
    except (OSError, json.JSONDecodeError) as exc:
        raise LintError(f"bad budgets {budgets_path}: {exc}") from exc
    rules = doc.get("budgets")
    if not isinstance(rules, list):
        raise LintError(f"budgets {budgets_path}: expected "
                        '{"budgets": [...]} document')
    rel = _rel(budgets_path)
    bench = sorted({(b.name + "*" if b.dynamic else b.name)
                    for b in ex.bench_metrics}
                   | set(schema["bench_metrics"]))
    figures = sorted({(f.key + "*" if f.prefix else f.key)
                      for f in ex.figures} | set(schema["figures"]))
    backends = set(schema["backends"])
    for rule in rules:
        if not isinstance(rule, dict):
            continue
        name = str(rule.get("name", rule.get("metric", "?")))
        line = _json_line(text, f'"{name}"')
        select = rule.get("select") or {}
        sel_prefix = select.get("metric_prefix")
        if sel_prefix is not None and not _match_prefix(
                str(sel_prefix), bench):
            out.append(_finding(
                "O04", rel, line,
                f"budget {name!r}: select.metric_prefix "
                f"{sel_prefix!r} matches no known bench metric "
                "producer (stale by construction)"))
        backend = select.get("backend")
        if backend is not None and str(backend) not in backends \
                and not str(backend).startswith("plugin:"):
            out.append(_finding(
                "O04", rel, line,
                f"budget {name!r}: select.backend {backend!r} is not "
                f"a catalogued backend {sorted(backends)}"))
        if sel_prefix is None:
            metric = str(rule.get("metric", ""))
            if metric and not _match_figure(metric, figures):
                out.append(_finding(
                    "O04", rel, line,
                    f"budget {name!r}: figure {metric!r} matches no "
                    "journal_figures fold (stale by construction)"))


def _check_faults(ex: Extraction, schema: dict,
                  out: List[Finding], repo_wide: bool) -> None:
    kinds = set(ex.fault_kinds)
    if not kinds:
        return
    for ref in ex.fault_refs:
        if ref.kind not in kinds:
            out.append(_finding(
                "O05", ref.path, ref.line,
                f"fault spec {ref.spec!r}: kind {ref.kind!r} is not "
                "parseable by testing/faults.py"))
    if repo_wide and set(schema["fault_kinds"]) != kinds:
        schema_path = DEFAULT_SCHEMA_PATH
        text = schema_path.read_text() if schema_path.exists() else ""
        missing = sorted(kinds - set(schema["fault_kinds"]))
        extra = sorted(set(schema["fault_kinds"]) - kinds)
        out.append(_finding(
            "O05", _rel(schema_path), _json_line(text, '"fault_kinds"'),
            "registry fault_kinds out of sync with "
            f"testing/faults.VALID_KINDS (missing {missing}, "
            f"extra {extra})"))


# ----------------------------------------------------------- the run


def _suppressed(lines: Dict[str, List[str]], f: Finding) -> bool:
    src = lines.get(f.path)
    if src is None:
        return False
    for ln in (f.line, f.line - 1):
        if 1 <= ln <= len(src):
            m = _SUPPRESS_RE.search(src[ln - 1])
            if m:
                ids = m.group("ids")
                if ids is None or f.rule in {
                        s.strip() for s in ids.split(",")}:
                    return True
    return False


def run_telemetry(paths: Optional[Sequence] = None,
                  schema_path: Optional[Path] = None,
                  budgets_path: Optional[Path] = None,
                  rules: Optional[Sequence[str]] = None,
                  ) -> Tuple[List[Finding], Dict[str, int]]:
    """Run the O01-O05 telemetry rules.

    ``paths=None`` is the repo-wide gate (enables the registry-side O02
    dead-contract checks, the O04 budget audit against the packaged
    ``obs/budgets.json``, and the O05 registry-sync check).  Explicit
    ``paths`` scope the emit/metric/consumer checks to those files;
    ``budgets_path`` forces the O04 audit against that file either way.
    Returns ``(findings, coverage)`` where coverage counts how many
    discovered emit / metric call sites the registry covers.
    """
    repo_wide = paths is None
    ex = extract_repo(paths)
    schema = load_schema(schema_path)
    raw: List[Finding] = []
    emit_covered = _check_emits(ex, schema, raw)
    _check_dead_contracts(ex, schema, raw, repo_wide)
    metric_covered = _check_metrics(ex, schema, raw)
    if budgets_path is not None or repo_wide:
        from fed_tgan_torch.obs.slo import default_budgets_path
        _check_budgets(ex, schema,
                       Path(budgets_path or default_budgets_path()), raw)
    _check_faults(ex, schema, raw, repo_wide)

    wanted = set(rules) if rules else None
    findings: List[Finding] = []
    seen: Set[str] = set()
    for f in raw:
        if wanted is not None and f.rule not in wanted:
            continue
        if _suppressed(ex.lines, f) or f.key in seen:
            continue
        seen.add(f.key)
        findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    coverage = {
        "emit_sites": len(ex.emits),
        "emit_sites_covered": emit_covered,
        "metric_sites": len(ex.metrics),
        "metric_sites_covered": metric_covered,
    }
    return findings, coverage
