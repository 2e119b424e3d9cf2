"""Contract persistence, the two-sided diff, and the CLI policy
(counterpart of ``fed_tgan_tpu/analysis/contracts/check.py``).

One JSON file per entry point family lives next to this module (the CPU's
contracts) or in a backend's subdirectory (``gpu/``: the card's, see
``runtime/backend.py::contracts_dir_for``); each holds the recorded
:class:`~fed_tgan_torch.analysis.contracts.ir.Fingerprint` per program
plus the family's forbidden-dtype list.  The diff is JAX's TWO-SIDED
ratchet:

* **regression** (exit 1): a collective appeared or grew (count or
  payload bytes), the boundary grew, a sync, a cross-device copy or copy
  bytes were added, a kernel variant is called more often, a forbidden
  dtype (f64 by default) crept in, a requirement broke, a contracted
  program vanished from the harness, or a new program has no contract;
* **improvement** (exit 0 + stale-contract warning): the same metrics
  moved the *good* way -- re-record with ``--contracts-update`` so the
  better number becomes the new ceiling;
* **drift** (exit 0, informational): the census of other dtypes, the op
  tally and the sync/copy op names, which move with torch's version.

``--explain`` adds to each regression the op delta and the Python call
sites of the ops the recording saw.  Exit codes: 0 clean/improved, 1
regression, 2 harness unavailable or unreadable contracts.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from fed_tgan_torch.analysis.contracts.harness import (
    ENTRYPOINT_FAMILIES,
    HarnessError,
    PROGRAM_REQUIREMENTS,
    record_fingerprints,
)
from fed_tgan_torch.analysis.contracts.ir import Fingerprint, kernel_calls

__all__ = [
    "CONTRACTS_DIR",
    "ContractError",
    "Issue",
    "check_requirements",
    "diff_contracts",
    "load_contracts",
    "run_contracts",
    "save_contracts",
]

CONTRACTS_DIR = Path(__file__).resolve().parent
DEFAULT_FORBID_DTYPES = ("f64",)

REGRESSION = "regression"
IMPROVEMENT = "improvement"
DRIFT = "drift"

#: the transfer fields a program must not grow
_TRANSFERS = (("n_inputs", "boundary input(s)"),
              ("in_bytes", "boundary input byte(s)"),
              ("n_outputs", "boundary output(s)"),
              ("out_bytes", "boundary output byte(s)"),
              ("syncs", "host sync op(s)"),
              ("copies", "cross-device copy(ies)"),
              ("copy_bytes", "cross-device copy byte(s)"))


class ContractError(RuntimeError):
    """Unreadable / malformed contract file (CLI exit code 2)."""


@dataclass
class Issue:
    severity: str  # regression | improvement | drift
    family: str
    program: str
    metric: str    # e.g. "transfers.syncs"
    old: object
    new: object
    message: str
    sites: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"severity": self.severity, "family": self.family,
                "program": self.program, "metric": self.metric,
                "old": self.old, "new": self.new,
                "message": self.message, "sites": self.sites}

    def render(self, explain: bool = False) -> str:
        head = (f"{self.severity.upper()} {self.family}/{self.program}: "
                f"{self.metric} {self.old} -> {self.new} ({self.message})")
        if explain and self.sites:
            head += "\n    explain:" + "".join(
                f"\n      {s}" for s in self.sites)
        return head


# --------------------------------------------------------------- storage

def _family_path(family: str, contracts_dir: Optional[Path] = None) -> Path:
    return Path(contracts_dir or CONTRACTS_DIR) / f"{family}.json"


def load_contracts(families, contracts_dir: Optional[Path] = None
                   ) -> Dict[str, Optional[dict]]:
    """family -> {"programs": {...}, "forbid_dtypes": [...]} or None when
    the family has no contract file yet."""
    out: Dict[str, Optional[dict]] = {}
    for family in families:
        path = _family_path(family, contracts_dir)
        if not path.exists():
            out[family] = None
            continue
        try:
            data = json.loads(path.read_text())
            data["programs"]  # noqa: B018 -- shape check
        except (OSError, json.JSONDecodeError, KeyError, TypeError) as exc:
            raise ContractError(f"bad contract {path}: {exc!r}") from exc
        out[family] = data
    return out


def save_contracts(current: Dict[str, Dict[str, Fingerprint]],
                   contracts_dir: Optional[Path] = None) -> List[Path]:
    """Write one JSON per family; the requirement blocks come from the
    harness's registry, never from the old JSON (programs it does not name
    get none)."""
    paths = []
    for family, programs in sorted(current.items()):
        reqs = PROGRAM_REQUIREMENTS.get(family, {})
        entries = {}
        for name, fp in sorted(programs.items()):
            entry = fp.to_dict()
            if name in reqs:
                entry["require"] = reqs[name]
            entries[name] = entry
        payload = {
            "version": 1,
            "comment": ("dispatch contract of the port; regenerate with "
                        "python -m fed_tgan_torch.analysis "
                        "--contracts-update [--backend gpu]"),
            "forbid_dtypes": list(DEFAULT_FORBID_DTYPES),
            "programs": entries,
        }
        path = _family_path(family, contracts_dir)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
        paths.append(path)
    return paths


# ------------------------------------------------------------------ diff

def _metric_issue(family, program, metric, old, new, grow_is_bad,
                  what) -> Optional[Issue]:
    if new == old:
        return None
    grew = new > old
    bad = grew == grow_is_bad
    delta = new - old
    return Issue(
        severity=REGRESSION if bad else IMPROVEMENT,
        family=family, program=program, metric=metric, old=old, new=new,
        message=f"{'+' if delta > 0 else ''}{delta} {what}",
    )


def _op_delta(old: dict, new: dict) -> List[str]:
    """``op +n`` for every op whose count moved."""
    out = []
    for op in sorted(set(old) | set(new)):
        d = new.get(op, 0) - old.get(op, 0)
        if d:
            out.append(f"op delta: {op} {'+' if d > 0 else ''}{d}")
    return out


def diff_program(family: str, program: str, stored: dict,
                 current: Fingerprint,
                 forbid_dtypes=DEFAULT_FORBID_DTYPES) -> List[Issue]:
    issues: List[Issue] = []

    def add(iss):
        if iss is not None:
            issues.append(iss)

    # ------------------------------------------------------- collectives
    old_c = stored.get("collectives", {})
    new_c = current.collectives
    for op in sorted(set(old_c) | set(new_c)):
        o = old_c.get(op, {"count": 0, "bytes": 0})
        n = new_c.get(op, {"count": 0, "bytes": 0})
        for f, what in (("count", f"{op} op(s)"),
                        ("bytes", f"{op} payload byte(s)")):
            add(_metric_issue(family, program, f"collectives.{op}.{f}",
                              o.get(f, 0), n.get(f, 0), True, what))

    # --------------------------------------------------------- transfers
    old_t = stored.get("transfers", {})
    for f, what in _TRANSFERS:
        add(_metric_issue(family, program, f"transfers.{f}",
                          old_t.get(f, 0), current.transfers.get(f, 0),
                          True, what))

    # ----------------------------------------------------------- kernels
    old_k = stored.get("kernels", {})
    for k in sorted(set(old_k) | set(current.kernels)):
        add(_metric_issue(family, program, f"kernels.{k}", old_k.get(k, 0),
                          current.kernels.get(k, 0), True, f"{k} call(s)"))

    # ------------------------------------------------------------ dtypes
    old_d = stored.get("dtypes", {})
    for dt in sorted(set(old_d) | set(current.dtypes)):
        o, n = old_d.get(dt, 0), current.dtypes.get(dt, 0)
        if o == n:
            continue
        if dt in forbid_dtypes:
            add(_metric_issue(family, program, f"dtypes.{dt}", o, n, True,
                              f"{dt} op result(s) ({dt} is forbidden "
                              "here)"))
        else:
            add(Issue(severity=DRIFT, family=family, program=program,
                      metric=f"dtypes.{dt}", old=o, new=n,
                      message=f"{dt} census moved (informational)"))

    # ------------------------------------------------ drift: the op tally
    if stored.get("ops", current.ops) != current.ops:
        add(Issue(severity=DRIFT, family=family, program=program,
                  metric="ops", old=stored.get("ops"), new=current.ops,
                  message="op tally moved (informational)"))
    if stored.get("host_ops", {}) != current.host_ops:
        add(Issue(severity=DRIFT, family=family, program=program,
                  metric="host_ops", old=stored.get("host_ops", {}),
                  new=current.host_ops,
                  message="sync/copy ops by name moved (informational)"))

    # explain material: the op delta and the recorded call sites
    delta = _op_delta(stored.get("host_ops", {}), current.host_ops)
    for iss in issues:
        if iss.severity != REGRESSION:
            continue
        if iss.metric.startswith("transfers."):
            iss.sites = delta + current.sites.get(iss.metric, [])
        else:
            kind = ".".join(iss.metric.split(".")[:2])
            iss.sites = list(current.sites.get(kind, []))
    return issues


def _same_dispatch(fp: Fingerprint, base: Fingerprint) -> List[str]:
    """The fields an ``independent_of`` requirement holds equal, where
    they differ."""
    out = []
    for f in ("syncs", "copies"):
        if fp.transfers.get(f, 0) != base.transfers.get(f, 0):
            out.append(f"transfers.{f} {fp.transfers.get(f, 0)} != "
                       f"{base.transfers.get(f, 0)}")
    if fp.collectives != base.collectives:
        out.append(f"collectives {fp.collectives} != {base.collectives}")
    return out


def check_requirements(family: str, program: str, require: dict,
                       programs: Dict[str, Fingerprint]) -> List[Issue]:
    """Evaluate one contract's ``require`` block against the CURRENT
    family fingerprints: a requirement is an absolute property the
    program must keep (``harness.PROGRAM_REQUIREMENTS`` says which)."""
    issues: List[Issue] = []
    fp = programs[program]

    def fail(metric, old, new, message):
        issues.append(Issue(severity=REGRESSION, family=family,
                            program=program, metric=metric, old=old,
                            new=new, message=message))

    for dt in require.get("dtypes_present", ()):
        if fp.dtypes.get(dt, 0) <= 0:
            fail(f"require.dtypes_present.{dt}", "present", "absent",
                 f"required dtype {dt} vanished from the dispatch "
                 "(precision policy no longer applied?)")
    for key in ("dispatch_scale", "independent_of"):
        req = require.get(key)
        if not req:
            continue
        vs = req["vs"]
        if vs not in programs:
            fail(f"require.{key}", vs, "missing",
                 "the baseline program of the requirement is no longer "
                 "recorded")
            continue
        base = programs[vs]
        if key == "dispatch_scale":
            k = int(req["rounds"])
            want = k * kernel_calls(base)
            if kernel_calls(fp) != want:
                fail("require.dispatch_scale", f"== {want} kernel calls "
                     f"({k} x {vs})", kernel_calls(fp),
                     f"a chunk of {k} rounds must call the kernels exactly "
                     f"{k}x the single-round chunk")
            diff = _same_dispatch(fp, base)
            if diff:
                fail("require.dispatch_scale", f"== {vs}", "; ".join(diff),
                     "a chunk of rounds keeps one host copy and the single "
                     "round's syncs and collectives, whatever its length")
        else:
            diff = _same_dispatch(fp, base)
            if fp.kernels != base.kernels:
                diff.append(f"kernels {fp.kernels} != {base.kernels}")
            if diff:
                fail("require.independent_of", f"== {vs}", "; ".join(diff),
                     "the dispatch must not grow with the population or "
                     "the batch (something dispatched per client?)")
    return issues


def diff_contracts(current: Dict[str, Dict[str, Fingerprint]],
                   stored: Dict[str, Optional[dict]]) -> List[Issue]:
    issues: List[Issue] = []
    for family, programs in sorted(current.items()):
        fam = stored.get(family)
        if fam is None:
            issues.append(Issue(
                severity=REGRESSION, family=family, program="*",
                metric="contract", old="missing",
                new=f"{len(programs)} program(s)",
                message="no contract file; record one with "
                        "--contracts-update"))
            continue
        recorded = fam.get("programs", {})
        forbid = tuple(fam.get("forbid_dtypes", DEFAULT_FORBID_DTYPES))
        for name in sorted(set(recorded) | set(programs)):
            if name not in programs:
                issues.append(Issue(
                    severity=REGRESSION, family=family, program=name,
                    metric="contract", old="recorded", new="missing",
                    message="contracted entry point no longer recorded by "
                            "the harness (renamed? update the contract)"))
            elif name not in recorded:
                issues.append(Issue(
                    severity=REGRESSION, family=family, program=name,
                    metric="contract", old="missing", new="present",
                    message="new entry point without a contract; record "
                            "it with --contracts-update"))
            else:
                issues.extend(diff_program(family, name, recorded[name],
                                           programs[name], forbid))
                require = recorded[name].get("require")
                if require:
                    issues.extend(check_requirements(
                        family, name, require, programs))
    return issues


# ------------------------------------------------------------ run policy

def run_contracts(update: bool = False, explain: bool = False,
                  fmt: str = "text",
                  contracts_dir: Optional[Path] = None,
                  entrypoints: Optional[Dict[str, Dict[str, Callable]]]
                  = None,
                  device="cpu",
                  families: Optional[List[str]] = None,
                  out: Callable[[str], None] = print) -> int:
    """Record, diff (or re-record), report.  Returns the exit code.
    ``families`` restricts the registry (or ``entrypoints``) to those
    family names."""
    registry = entrypoints if entrypoints is not None else ENTRYPOINT_FAMILIES
    if families:
        unknown = sorted(set(families) - set(registry))
        if unknown:
            out(f"contracts: unknown family(ies) {', '.join(unknown)} "
                f"(have {', '.join(sorted(registry))})")
            return 2
        registry = {f: registry[f] for f in families}
    try:
        current = record_fingerprints(registry, device=device)
    except HarnessError as exc:
        out(f"contracts: harness unavailable: {exc}")
        return 2

    if update:
        paths = save_contracts(current, contracts_dir)
        n = sum(len(p) for p in current.values())
        out(f"contracts: recorded {n} program fingerprint(s) across "
            f"{len(current)} family(ies) -> "
            + ", ".join(str(p) for p in paths))
        return 0

    try:
        stored = load_contracts(current, contracts_dir)
    except ContractError as exc:
        out(f"contracts: {exc}")
        return 2
    issues = diff_contracts(current, stored)
    regressions = [i for i in issues if i.severity == REGRESSION]
    improvements = [i for i in issues if i.severity == IMPROVEMENT]
    drift = [i for i in issues if i.severity == DRIFT]

    if fmt == "json":
        out(json.dumps({
            "families": {fam: sorted(progs) for fam, progs in
                         current.items()},
            "programs": {fam: {name: fp.to_dict()
                               for name, fp in sorted(progs.items())}
                         for fam, progs in current.items()},
            "issues": [i.to_dict() for i in issues],
            "regressions": len(regressions),
            "improvements": len(improvements),
        }, indent=2))
        return 1 if regressions else 0

    for i in regressions:
        out(i.render(explain=explain))
    for i in improvements:
        out(i.render() + "\n    stale contract: re-record the better "
            "number with --contracts-update")
    for i in drift:
        out(i.render())
    n_prog = sum(len(p) for p in current.values())
    out(f"contracts: {n_prog} program(s) across {len(current)} "
        f"family(ies): {len(regressions)} regression(s), "
        f"{len(improvements)} improvement(s) (stale contracts), "
        f"{len(drift)} census drift(s)")
    return 1 if regressions else 0
