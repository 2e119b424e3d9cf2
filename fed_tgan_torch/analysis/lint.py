"""The lint runner (counterpart of ``fed_tgan_tpu/analysis/lint.py``): walk
files, run the rules J01-J06 (JAX's ids, in torch idiom:
:mod:`fed_tgan_torch.analysis.rules`) and the locklint rules L01-L04,
diff the baseline.

Pure stdlib + AST: importing this module imports neither torch nor numpy,
so the gate runs in milliseconds.  Findings are keyed
``relpath:rule:line``; the checked-in ``baseline.json`` holds accepted
findings, so only *new* findings fail the gate (shrink it as code is
fixed; it grows only through an explicit ``--baseline-update``).

Inline escape hatch for an intentional pattern, with its reason::

    self._cache.clear()  # torchlint: disable=L01
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from fed_tgan_torch.analysis.rules import ALL_RULES, RULES_BY_ID

PKG_ROOT = Path(__file__).resolve().parent.parent  # .../fed_tgan_torch
REPO_ROOT = PKG_ROOT.parent
DEFAULT_BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"

_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*disable(?:=(?P<ids>[A-Z0-9,\s]+))?")

#: the locklint prong alone (the doctor's locklint check)
LOCK_RULES = tuple(r for r in ALL_RULES if r.rule_id.startswith("L"))


class LintError(RuntimeError):
    """Unreadable / unparsable input (CLI exit code 2)."""


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative posix path
    line: int
    message: str
    hint: str = ""

    @property
    def key(self) -> str:
        return f"{self.path}:{self.rule}:{self.line}"

    def render(self, with_hint: bool = True) -> str:
        text = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if with_hint and self.hint:
            text += f"\n    hint: {self.hint}"
        return text


@dataclass
class ModuleInfo:
    path: str
    relpath: str
    source: str
    lines: List[str]
    tree: ast.Module


def iter_py_files(paths: Optional[Sequence] = None) -> List[Path]:
    roots = [Path(p) for p in paths] if paths else [PKG_ROOT]
    files: List[Path] = []
    for root in roots:
        if root.is_dir():
            files.extend(sorted(
                p for p in root.rglob("*.py")
                if "__pycache__" not in p.parts))
        elif root.suffix == ".py":
            files.append(root)
        else:
            raise LintError(f"not a python file or directory: {root}")
    return files


def _relpath(path: Path) -> str:
    try:
        return path.resolve().relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return path.as_posix()


def parse_module(path: Path) -> ModuleInfo:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError) as exc:
        raise LintError(f"{path}: {exc}") from exc
    return ModuleInfo(path=str(path), relpath=_relpath(path),
                      source=source, lines=source.splitlines(), tree=tree)


def _suppressed(mod: ModuleInfo, rule: str, line: int) -> bool:
    for ln in (line, line - 1):
        if 1 <= ln <= len(mod.lines):
            m = _SUPPRESS_RE.search(mod.lines[ln - 1])
            if m:
                ids = m.group("ids")
                if ids is None:
                    return True
                if rule in {s.strip() for s in ids.split(",")}:
                    return True
    return False


def lint_module(mod: ModuleInfo, rules=None) -> List[Finding]:
    out: List[Finding] = []
    for rule in (rules or ALL_RULES):
        for rule_id, line, message, hint in rule.check(mod):
            if not _suppressed(mod, rule_id, line):
                out.append(Finding(rule=rule_id, path=mod.relpath,
                                   line=line, message=message, hint=hint))
    return out


def run_lint(paths: Optional[Sequence] = None, rules=None) -> List[Finding]:
    """Lint ``paths`` (default: the whole ``fed_tgan_torch`` package)."""
    findings: List[Finding] = []
    seen: Set[str] = set()
    for path in iter_py_files(paths):
        for f in lint_module(parse_module(path), rules=rules):
            if f.key not in seen:
                seen.add(f.key)
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------- baseline

def load_baseline(path: Optional[Path] = None) -> Set[str]:
    path = Path(path) if path else DEFAULT_BASELINE_PATH
    if not path.exists():
        return set()
    try:
        data = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        raise LintError(f"bad baseline {path}: {exc}") from exc
    return set(data.get("findings", {}))


def save_baseline(findings: Iterable[Finding],
                  path: Optional[Path] = None) -> Path:
    path = Path(path) if path else DEFAULT_BASELINE_PATH
    payload = {
        "version": 1,
        "comment": ("accepted findings of the port's lints; shrink via "
                    "fixes, grow only via --baseline-update"),
        "findings": {f.key: f.message for f in findings},
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return path


def apply_baseline(findings: Sequence[Finding], baseline: Set[str]
                   ) -> Tuple[List[Finding], List[Finding], Set[str]]:
    """-> (new_findings, baselined_findings, stale_baseline_keys)."""
    new = [f for f in findings if f.key not in baseline]
    old = [f for f in findings if f.key in baseline]
    stale = baseline - {f.key for f in findings}
    return new, old, stale
