"""``python -m fed_tgan_torch.obs`` -- the observability CLI
(counterpart of ``fed_tgan_tpu/obs/__main__.py:36-100``).

Subcommands:

- ``report <journal.jsonl>... [--format text|json]`` -- summarize one
  or more run journals; several journals (a multi-process run's per-rank
  streams) merge into one federation view keyed by round.
- ``slo <bench-or-journal> [--budgets FILE]`` -- the SLO regression
  gate.  Exit 1 on a regression, 0 on pass (stale budgets warn), 2 on
  malformed input/budgets.
- ``watch <journal|url>... [--follow]`` -- live view over journal files
  or a training process's ``--obs-port`` exporter, with the SLO gate
  re-evaluated every K rounds as an in-run alarm.
- ``ledger [--json] [--family F ...] [--device cuda|cpu]`` -- the cost
  ledger of one small instance of each program family the port
  dispatches (the stacked round chunk in f32 and bf16, an engine chunk,
  a 2-lane fleet dispatch, the monitor's probe): flops, bytes accessed,
  peak device bytes, as JAX's ``ledger`` prints them.

Exit codes: 0 ok, 1 SLO regression/breach, 2 usage / unreadable input.
Importing this module and running ``report``, ``slo`` and ``watch``
needs neither torch nor numpy; ``ledger`` imports torch.
"""

from __future__ import annotations

import argparse

from fed_tgan_torch.obs.report import report_main
from fed_tgan_torch.obs.slo import slo_main
from fed_tgan_torch.obs.watch import watch_main


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fed_tgan_torch.obs",
        description="run-journal tooling for fed_tgan_torch telemetry",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser(
        "report", help="summarize run journal(s) (JSONL; per-rank journals "
                       "merge into one view)")
    rep.add_argument("journal", nargs="+",
                     help="path(s) to journal JSONL file(s)")
    rep.add_argument("--format", choices=("text", "json"), default="text")
    slo = sub.add_parser(
        "slo", help="check a bench record or journal against SLO budgets")
    slo.add_argument("input", help="bench record JSON or journal JSONL")
    slo.add_argument("--budgets", default=None,
                     help="budget file (default: packaged obs/budgets.json)")
    wat = sub.add_parser(
        "watch", help="live view: tail journal file(s) or poll an "
                      "--obs-port exporter URL")
    wat.add_argument("source", nargs="+",
                     help="journal JSONL path(s) or http://host:port of a "
                          "training exporter")
    wat.add_argument("--follow", action="store_true",
                     help="keep tailing until interrupted (default: one "
                          "pass over what exists now)")
    wat.add_argument("--interval", type=float, default=1.0,
                     help="poll interval in seconds (default 1)")
    wat.add_argument("--slo-every", type=int, default=25,
                     help="re-evaluate SLO budgets every K observed "
                          "rounds (default 25)")
    wat.add_argument("--budgets", default=None,
                     help="budget file (default: packaged obs/budgets.json)")
    wat.add_argument("--max-seconds", type=float, default=None,
                     help="stop following after this many seconds "
                          "(testing/automation)")
    led = sub.add_parser(
        "ledger", help="run one small instance of each program family the "
                       "port dispatches and print its device cost ledger")
    led.add_argument("--json", action="store_true",
                     help="emit the ledger as JSON")
    led.add_argument("--family", action="append", default=None,
                     help="restrict to one program family (repeatable)")
    led.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "report":
        return report_main(args.journal, fmt=args.format)
    if args.cmd == "slo":
        return slo_main(args)
    if args.cmd == "watch":
        return watch_main(args)
    from fed_tgan_torch.obs.ledger import ledger_main

    return ledger_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
