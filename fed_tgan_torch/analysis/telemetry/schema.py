"""The telemetry schema registry: load / generate / merge
``fed_tgan_torch/obs/schema.json``.

The registry is *generated once* (``--schema-update``) from the static
extraction, then hand-curated: required fields get trimmed to what every
producer (and the legacy journals tests replay) actually guarantees,
legacy/externally-merged fields move to ``external``, and events whose
shapes the AST cannot enumerate stay ``open``.  Merging never deletes a
curated entry -- new discoveries land as additions, exactly like the
hlolint ``--contracts-update`` ratchet reset, and the obslint O-rules
plus the runtime validator then hold the tree to the registry.

Registry shape::

    {"version": 1,
     "events": {"<type>": {
         "required": [...],   # every emit must carry these
         "optional": [...],   # statically discovered kw fields
         "external": [...],   # written outside the static view
                              # (legacy journals, merged rank streams)
         "open": bool,        # emitters may attach unlisted fields
         "producers": ["<repo-relative path>", ...]}},
     "metrics": {"<name or prefix*>": {
         "kind": "counter|gauge|histogram",
         "labels": [...], "producers": [...]}},
     "bench_metrics": [...],  # record "metric" literals (prefix if *)
     "figures": [...],        # journal-fold figure keys (prefix if *)
     "backends": [...],       # values select.backend may name
     "fault_kinds": [...]}    # mirror of testing/faults.VALID_KINDS

A trailing ``*`` marks a prefix entry wherever names may carry a
dynamic tail (f-string metric names, bench workload tags).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from fed_tgan_torch.analysis.lint import LintError, PKG_ROOT
from fed_tgan_torch.analysis.telemetry.extract import Extraction

__all__ = [
    "DEFAULT_SCHEMA_PATH",
    "generate_schema",
    "load_schema",
    "save_schema",
]

DEFAULT_SCHEMA_PATH = PKG_ROOT / "obs" / "schema.json"

SCHEMA_DOC_VERSION = 1

_EVENT_KEYS = ("required", "optional", "external", "open", "producers")


def load_schema(path: Optional[Path] = None) -> dict:
    path = Path(path) if path else DEFAULT_SCHEMA_PATH
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise LintError(f"bad schema {path}: {exc}") from exc
    if not isinstance(doc, dict) or not isinstance(doc.get("events"), dict):
        raise LintError(f"schema {path}: expected an object with 'events'")
    for key in ("metrics",):
        if not isinstance(doc.get(key), dict):
            doc[key] = {}
    for key in ("bench_metrics", "figures", "backends", "fault_kinds"):
        if not isinstance(doc.get(key), list):
            doc[key] = []
    for name, ev in doc["events"].items():
        if not isinstance(ev, dict):
            raise LintError(f"schema {path}: event {name!r} must be an "
                            "object")
        for k in ("required", "optional", "external", "producers"):
            ev.setdefault(k, [])
        ev.setdefault("open", False)
    for name, m in doc["metrics"].items():
        if not isinstance(m, dict) or "kind" not in m:
            raise LintError(f"schema {path}: metric {name!r} needs a "
                            "'kind'")
        m.setdefault("labels", [])
        m.setdefault("producers", [])
    return doc


def save_schema(schema: dict, path: Optional[Path] = None) -> Path:
    path = Path(path) if path else DEFAULT_SCHEMA_PATH
    path.write_text(json.dumps(schema, indent=2, sort_keys=True) + "\n")
    return path


def _metric_key(name: str, dynamic: bool) -> str:
    return f"{name}*" if dynamic else name


def generate_schema(ex: Extraction,
                    existing: Optional[dict] = None
                    ) -> Tuple[dict, List[str]]:
    """Merge the extraction into ``existing`` (never deleting curated
    entries); returns ``(schema, added-entry descriptions)``."""
    schema = existing or {
        "version": SCHEMA_DOC_VERSION,
        "comment": ("telemetry contract registry (obslint): journal event "
                    "schemas, metric-name catalogue, budget-selector "
                    "producers.  Generated via `python -m "
                    "fed_tgan_torch.analysis --telemetry --schema-update`, "
                    "then hand-curated; merging adds, never deletes."),
        "events": {}, "metrics": {}, "bench_metrics": [], "figures": [],
        "backends": ["cpu", "gpu", "tpu"], "fault_kinds": [],
    }
    added: List[str] = []

    by_event: Dict[str, list] = {}
    for site in ex.emits:
        by_event.setdefault(site.event, []).append(site)
    for event in sorted(by_event):
        sites = by_event[event]
        closed = [s for s in sites if not s.open]
        union = sorted({f for s in sites for f in s.fields})
        producers = sorted({s.path for s in sites})
        entry = schema["events"].get(event)
        if entry is None:
            required = sorted(
                set.intersection(*[set(s.fields) for s in closed])
            ) if closed else []
            schema["events"][event] = {
                "required": required,
                "optional": sorted(set(union) - set(required)),
                "external": [],
                "open": any(s.open for s in sites),
                "producers": producers,
            }
            added.append(f"event {event}")
        else:
            known = set(entry["required"]) | set(entry["optional"]) \
                | set(entry["external"])
            new_fields = sorted(set(union) - known)
            if new_fields:
                entry["optional"] = sorted(
                    set(entry["optional"]) | set(new_fields))
                added.append(f"event {event} field(s) "
                             f"{', '.join(new_fields)}")
            if sorted(set(entry["producers"]) | set(producers)) \
                    != sorted(entry["producers"]):
                entry["producers"] = sorted(
                    set(entry["producers"]) | set(producers))

    for site in ex.metrics:
        key = _metric_key(site.name, site.dynamic)
        entry = schema["metrics"].get(key)
        if entry is None:
            schema["metrics"][key] = {
                "kind": site.kind,
                "labels": sorted(site.labels),
                "producers": [site.path],
            }
            added.append(f"metric {key}")
        else:
            if set(site.labels) - set(entry["labels"]):
                entry["labels"] = sorted(
                    set(entry["labels"]) | set(site.labels))
                added.append(f"metric {key} label(s) "
                             f"{', '.join(sorted(site.labels))}")
            if site.path not in entry["producers"]:
                entry["producers"] = sorted(
                    set(entry["producers"]) | {site.path})

    bench = sorted({_metric_key(b.name, b.dynamic)
                    for b in ex.bench_metrics})
    new_bench = sorted(set(bench) - set(schema["bench_metrics"]))
    if new_bench:
        schema["bench_metrics"] = sorted(
            set(schema["bench_metrics"]) | set(new_bench))
        added.extend(f"bench metric {b}" for b in new_bench)

    figures = sorted({_metric_key(f.key, f.prefix) for f in ex.figures})
    new_figs = sorted(set(figures) - set(schema["figures"]))
    if new_figs:
        schema["figures"] = sorted(set(schema["figures"]) | set(new_figs))
        added.extend(f"figure {f}" for f in new_figs)

    new_kinds = sorted(set(ex.fault_kinds) - set(schema["fault_kinds"]))
    if new_kinds:
        schema["fault_kinds"] = sorted(
            set(schema["fault_kinds"]) | set(new_kinds))
        added.extend(f"fault kind {k}" for k in new_kinds)
    return schema, added
