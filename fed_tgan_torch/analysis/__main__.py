"""``python -m fed_tgan_torch.analysis`` -- the analysis CLI (counterpart
of ``fed_tgan_tpu/analysis/__main__.py``).

The default mode is the static lint: the rules J01-J06 (JAX's ids in
torch idiom) and the locklint concurrency rules L01-L04 over the
``fed_tgan_torch`` package (or the paths given), without importing torch
or numpy.  ``--telemetry`` switches to obslint (telemetry contracts
O01-O05): the pure-AST extraction of every journal emit site, metric
get-or-create site, obs consumer read, budget selector, and fault-spec
reference is cross-checked against the registry
``fed_tgan_torch/obs/schema.json`` (``--schema-update`` merges the
registry from the tree).  ``--contracts`` switches to the program
contracts: every contracted entry point is dispatched on small fixed
inputs and its fingerprint diffed against the checked-in
``analysis/contracts/*.json`` (``--backend gpu``: on the card, against
``analysis/contracts/gpu/``; ``--contracts-update`` re-records them;
``--explain`` names each regression's op delta and call sites).
``--all`` runs the three prongs (torchlint+locklint, obslint, contracts)
and prints one summary table with an aggregated exit code.

Exit codes: 0 clean (or all findings baselined / contracts honoured),
1 new findings / contract regression, 2 usage, parse or harness error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from fed_tgan_torch.analysis.lint import (
    ALL_RULES,
    DEFAULT_BASELINE_PATH,
    RULES_BY_ID,
    LintError,
    apply_baseline,
    load_baseline,
    run_lint,
    save_baseline,
)


def expand_rule_ids(spec: str) -> list:
    """'J01,L02' -> ['J01', 'L02']; 'L01-L04' expands the numeric range
    within one prefix letter.  Unknown shapes raise KeyError (the same
    path as an unknown id, so the CLI reports it as usage: exit 2)."""
    import re as _re

    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        m = _re.fullmatch(r"([A-Z]+)(\d+)-([A-Z]+)?(\d+)", tok)
        if m:
            prefix, lo, prefix2, hi = m.groups()
            if prefix2 is not None and prefix2 != prefix:
                raise KeyError(tok)
            width = len(m.group(2))
            out.extend(f"{prefix}{n:0{width}d}"
                       for n in range(int(lo), int(hi) + 1))
        else:
            out.append(tok)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fed_tgan_torch.analysis",
        description="torch-aware lint (J01-J06 + locklint L01-L04), "
                    "obslint (--telemetry, O01-O05) and the program "
                    "contracts (--contracts) over fed_tgan_torch",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the package)")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE_PATH,
                    help="baseline JSON of accepted findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignore the baseline")
    ap.add_argument("--baseline-update", action="store_true",
                    help="rewrite the baseline to the current finding set")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule ids to run, ranges allowed "
                         "(e.g. 'L01-L04' or 'J01,J03,L02'; default: all)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--contracts", action="store_true",
                    help="check the program contracts instead of linting "
                         "(dispatches every contracted entry point once "
                         "on small fixed inputs)")
    ap.add_argument("--contracts-update", action="store_true",
                    help="re-record the contract fingerprints from the "
                         "current tree (the explicit ratchet reset)")
    ap.add_argument("--explain", action="store_true",
                    help="with --contracts: name each regression's op "
                         "delta and the Python call sites of its ops")
    ap.add_argument("--contracts-dir", type=Path, default=None,
                    help="contract JSON directory (default: the "
                         "backend's, see --backend)")
    ap.add_argument("--backend", default=None, metavar="{cpu,gpu}",
                    help="with --contracts: where the programs run and "
                         "whose contracts they are held against: cpu (the "
                         "default: the checked-in analysis/contracts/) or "
                         "gpu (the card: analysis/contracts/gpu/); see "
                         "runtime/backend.py")
    ap.add_argument("--family", action="append", default=None,
                    help="with --contracts: only this entry point family "
                         "(repeatable)")
    ap.add_argument("--telemetry", action="store_true",
                    help="check the telemetry contracts (obslint "
                         "O01-O05) against obs/schema.json instead of "
                         "linting")
    ap.add_argument("--schema-update", action="store_true",
                    help="with --telemetry: regenerate/merge the schema "
                         "registry from the current tree (additive; "
                         "curated entries are never deleted)")
    ap.add_argument("--schema", type=Path, default=None,
                    help="with --telemetry: schema registry path "
                         "(default: the checked-in obs/schema.json)")
    ap.add_argument("--budgets", type=Path, default=None,
                    help="with --telemetry: budgets JSON for the O04 "
                         "selector check (default: obs/budgets.json on "
                         "a repo-wide run)")
    ap.add_argument("--all", action="store_true", dest="all_prongs",
                    help="run every analysis prong (torchlint+locklint, "
                         "obslint, program contracts) with one summary "
                         "table and an aggregated exit code")
    return ap


def _contracts_mode(args) -> int:
    # imported lazily: the contracts prong imports torch, the lint prong
    # keeps its torch-free startup
    from fed_tgan_torch.analysis.contracts.check import run_contracts
    from fed_tgan_torch.runtime.backend import (
        contracts_dir_for,
        parse_backend,
    )

    try:
        backend = parse_backend(args.backend) or "cpu"
    except ValueError as exc:
        print(f"contracts: {exc}", file=sys.stderr)
        return 2
    return run_contracts(
        update=args.contracts_update,
        explain=args.explain,
        fmt=args.format,
        contracts_dir=args.contracts_dir or contracts_dir_for(backend),
        device="cuda" if backend == "gpu" else "cpu",
        families=args.family,
    )


def _telemetry_mode(args) -> int:
    from fed_tgan_torch.analysis.telemetry import (
        RULE_IDS,
        extract_repo,
        generate_schema,
        load_schema,
        run_telemetry,
        save_schema,
    )
    from fed_tgan_torch.analysis.telemetry.schema import DEFAULT_SCHEMA_PATH

    if args.schema_update:
        try:
            ex = extract_repo(args.paths or None)
            path = args.schema or DEFAULT_SCHEMA_PATH
            existing = load_schema(path) if path.exists() else None
            schema, added = generate_schema(ex, existing=existing)
            save_schema(schema, path)
        except LintError as exc:
            print(f"obslint: {exc}", file=sys.stderr)
            return 2
        print(f"obslint: schema updated: {len(added)} addition(s) "
              f"-> {path}")
        for entry in added:
            print(f"  + {entry}")
        return 0

    rules = None
    if args.rules:
        rules = expand_rule_ids(args.rules)
        unknown = sorted(set(rules) - set(RULE_IDS))
        if unknown:
            print(f"obslint: unknown rule(s) {', '.join(unknown)} "
                  f"(have {', '.join(RULE_IDS)})", file=sys.stderr)
            return 2

    try:
        findings, coverage = run_telemetry(
            args.paths or None, schema_path=args.schema,
            budgets_path=args.budgets, rules=rules)
    except LintError as exc:
        print(f"obslint: {exc}", file=sys.stderr)
        return 2

    if args.baseline_update:
        path = save_baseline(findings, args.baseline)
        print(f"obslint: baseline updated: {len(findings)} finding(s) "
              f"-> {path}")
        return 0

    try:
        baseline = set() if args.no_baseline else load_baseline(args.baseline)
    except LintError as exc:
        print(f"obslint: {exc}", file=sys.stderr)
        return 2
    new, old, stale = apply_baseline(findings, baseline)
    stale = {k for k in stale
             if k.split(":")[1].startswith("O")}  # locklint keys aren't ours

    cov = (f"schema covers {coverage['emit_sites_covered']}/"
           f"{coverage['emit_sites']} emit site(s), "
           f"{coverage['metric_sites_covered']}/"
           f"{coverage['metric_sites']} metric site(s)")
    if args.format == "json":
        print(json.dumps({
            "findings": [vars(f) for f in findings],
            "new": [f.key for f in new],
            "baselined": [f.key for f in old],
            "stale_baseline": sorted(stale),
            "coverage": coverage,
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        for key in sorted(stale):
            print(f"obslint: stale baseline entry (fixed? run "
                  f"--baseline-update to drop): {key}")
        print(f"obslint: {len(findings)} finding(s): {len(new)} new, "
              f"{len(old)} baselined, {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'}; {cov}")
    return 1 if new else 0


def _all_mode(args) -> int:
    """Every prong, one summary table, aggregated exit code."""
    import argparse as _argparse

    rows = []
    lint_args = _argparse.Namespace(**vars(args))
    lint_args.rules = ""
    rc = _lint_mode(lint_args)
    rows.append(("torchlint+locklint", rc))
    tel_args = _argparse.Namespace(**vars(args))
    tel_args.rules = ""
    tel_args.schema_update = False
    rc = _telemetry_mode(tel_args)
    rows.append(("obslint", rc))
    con_args = _argparse.Namespace(**vars(args))
    con_args.contracts_update = False
    rc = _contracts_mode(con_args)
    rows.append(("program contracts", rc))

    width = max(len(name) for name, _ in rows)
    print("\nanalysis --all summary:")
    for name, rc in rows:
        status = {0: "ok", 1: "FINDINGS", 2: "ERROR"}.get(rc, f"exit {rc}")
        print(f"  {name:<{width}}  {status}")
    codes = [rc for _, rc in rows]
    return 2 if 2 in codes else (1 if 1 in codes else 0)


def _lint_mode(args) -> int:
    rules = None
    if args.rules:
        try:
            rules = [RULES_BY_ID[r] for r in expand_rule_ids(args.rules)]
        except KeyError as exc:
            print(f"torchlint: unknown rule {exc} "
                  f"(have {sorted(RULES_BY_ID)})", file=sys.stderr)
            return 2

    try:
        findings = run_lint(args.paths or None, rules=rules)
    except LintError as exc:
        print(f"torchlint: {exc}", file=sys.stderr)
        return 2

    if args.baseline_update:
        path = save_baseline(findings, args.baseline)
        print(f"torchlint: baseline updated: {len(findings)} finding(s) "
              f"-> {path}")
        return 0

    try:
        baseline = set() if args.no_baseline else load_baseline(args.baseline)
    except LintError as exc:
        print(f"torchlint: {exc}", file=sys.stderr)
        return 2
    new, old, stale = apply_baseline(findings, baseline)
    stale = {k for k in stale
             if not k.split(":")[1].startswith("O")}  # obslint keys

    if args.format == "json":
        print(json.dumps({
            "findings": [vars(f) for f in findings],
            "new": [f.key for f in new],
            "baselined": [f.key for f in old],
            "stale_baseline": sorted(stale),
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        for key in sorted(stale):
            print(f"torchlint: stale baseline entry (fixed? run "
                  f"--baseline-update to drop): {key}")
        print(f"torchlint+locklint: {len(findings)} finding(s): "
              f"{len(new)} new, "
              f"{len(old)} baselined, {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'} "
              f"[rules: {', '.join(r.rule_id for r in (rules or ALL_RULES))}]")
    return 1 if new else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.all_prongs:
        return _all_mode(args)
    if args.contracts or args.contracts_update:
        return _contracts_mode(args)
    if args.telemetry or args.schema_update:
        return _telemetry_mode(args)
    return _lint_mode(args)


if __name__ == "__main__":
    raise SystemExit(main())
