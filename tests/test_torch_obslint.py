"""The port's obslint (``fed_tgan_torch/analysis/telemetry/``, rules
O01-O05) and the runtime journal schema sanitizer, against the JAX
package's.

Fixture twins live in ``tests/torch_lint_fixtures/`` (the JAX twins with
the port's imports, plus the port's event-keeping wrappers
``self._event("type", ...)`` and ``self._emit({"type": ...})``) and are
checked against their own registry (``obslint_schema.json``).  On the
JAX package's own twins the port's rules find what JAX's find.
"""
import json
import re
from pathlib import Path

import pytest

import fed_tgan_torch.obs.journal as journal_mod
from fed_tgan_torch.analysis.__main__ import main as lint_main
from fed_tgan_torch.analysis.telemetry import (
    DEFAULT_SCHEMA_PATH,
    RULE_IDS,
    RULE_TITLES,
    extract_repo,
    load_schema,
    run_telemetry,
)
from fed_tgan_torch.analysis.telemetry.rules import _check_dead_contracts
from fed_tgan_torch.obs.journal import EVENT_TYPES, RunJournal
from fed_tgan_tpu.analysis.telemetry import run_telemetry as jax_telemetry

FIXTURES = Path(__file__).parent / "torch_lint_fixtures"
FIXTURE_SCHEMA = FIXTURES / "obslint_schema.json"
JAX_FIXTURES = Path(__file__).parent / "lint_fixtures"

_EXPECT_RE = re.compile(r"# EXPECT: (O\d\d)")


def _expected(path: Path):
    out = set()
    for lineno, line in enumerate(path.read_text().splitlines(), start=1):
        for rule in _EXPECT_RE.findall(line):
            out.add((rule, lineno))
    return out


def _run(paths, schema=FIXTURE_SCHEMA, **kw):
    findings, _cov = run_telemetry(paths=paths, schema_path=schema, **kw)
    return findings


# --------------------------------------------------------- fixture twins

TWINS = ["o01", "o02", "o03", "o05"]


@pytest.mark.parametrize("stem", TWINS)
def test_bad_twin_exact_findings(stem):
    bad = FIXTURES / f"{stem}_bad.py"
    findings = _run([bad])
    assert {(f.rule, f.line) for f in findings} == _expected(bad)
    for f in findings:
        assert f.hint and f.rule in RULE_TITLES


@pytest.mark.parametrize("stem", TWINS)
def test_good_twin_zero_findings(stem):
    assert _run([FIXTURES / f"{stem}_good.py"]) == []


@pytest.mark.parametrize("name", [
    "o01_bad", "o01_good", "o02_bad", "o02_good", "o03_bad", "o03_good",
    "o05_bad", "o05_good"])
def test_findings_equal_jax_obslint(name):
    """On the JAX package's twins (its imports, its registry) the copied
    rules give JAX's findings."""
    path = JAX_FIXTURES / f"{name}.py"
    schema = JAX_FIXTURES / "obslint_schema.json"
    jax, _ = jax_telemetry(paths=[path], schema_path=schema)
    port = _run([path], schema=schema)
    key = lambda f: (f.rule, f.line, f.message)
    assert [key(f) for f in port] == [key(f) for f in jax]


def test_o04_bad_budgets():
    findings = _run([FIXTURES / "o01_good.py"],
                    budgets_path=FIXTURES / "o04_bad_budgets.json")
    assert [f.rule for f in findings] == ["O04"] * 3
    blob = " ".join(f.message for f in findings)
    assert "ghost-bench" in blob and "bad-backend" in blob
    assert "ghost-figure" in blob


def test_o04_good_budgets():
    assert _run([FIXTURES / "o01_good.py"],
                budgets_path=FIXTURES / "o04_good_budgets.json") == []


def test_inline_suppression(tmp_path):
    src = (FIXTURES / "o03_bad.py").read_text()
    sup = tmp_path / "suppressed.py"
    sup.write_text(src.replace("# EXPECT: O03", "# torchlint: disable=O03"))
    assert _run([sup]) == []


def test_external_only_event_needs_no_emit_site():
    """An event whose every field is ``external`` (the backend events,
    which only the JAX package's journals carry) is not a dead
    contract; the same event with a required field is."""
    ex = extract_repo([FIXTURES / "o01_good.py"])
    schema = load_schema(FIXTURE_SCHEMA)
    schema["events"]["legacy_only"] = {
        "required": [], "optional": [], "external": ["ok"], "open": False,
        "producers": []}
    out = []
    _check_dead_contracts(ex, schema, out, repo_wide=True)
    assert not any("legacy_only" in f.message for f in out)
    schema["events"]["legacy_only"]["required"] = ["ok"]
    out = []
    _check_dead_contracts(ex, schema, out, repo_wide=True)
    assert any("'legacy_only' has no emit site" in f.message for f in out)


# ------------------------------------------------------- the package gate

def test_repo_wide_clean_and_fully_covered():
    findings, cov = run_telemetry()
    assert findings == [], [f.key for f in findings]
    assert cov["emit_sites"] > 0 and cov["metric_sites"] > 0
    assert cov["emit_sites_covered"] == cov["emit_sites"]
    assert cov["metric_sites_covered"] == cov["metric_sites"]


def test_every_port_event_site_is_found():
    """The extraction sees the port's emit idioms: the sanitizers'
    ``compile``, the elastic layer's and the init cache's dict events,
    the trainer's ``self._event`` and ``client_joined``."""
    events = {(s.event, s.path.split("fed_tgan_torch/")[-1])
              for s in extract_repo().emits}
    for want in (("compile", "analysis/sanitizers.py"),
                 ("drift_window", "federation/elastic.py"),
                 ("init_cache", "federation/init_cache.py"),
                 ("aggregate", "train/federated.py"),
                 ("client_joined", "train/federated.py")):
        assert want in events, want
    schema = load_schema(DEFAULT_SCHEMA_PATH)
    for name in ("backend_probe", "backend_plugin_registered"):
        ev = schema["events"][name]
        assert ev["external"] and not ev["required"] and not ev["optional"]


def test_event_types_derived_from_schema():
    schema = load_schema(DEFAULT_SCHEMA_PATH)
    assert EVENT_TYPES == frozenset(schema["events"])
    assert "schema_violation" in EVENT_TYPES
    assert "backend_plugin_registered" in EVENT_TYPES


def test_docstring_catalogue_in_sync():
    doc = journal_mod.__doc__
    for name in load_schema(DEFAULT_SCHEMA_PATH)["events"]:
        assert name in doc, f"event {name!r} missing from journal docstring"


# ----------------------------------------------- the runtime sanitizer

def _read_events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_every_event_type_round_trips_clean(tmp_path):
    schema = load_schema(DEFAULT_SCHEMA_PATH)
    jpath = tmp_path / "all_events.jsonl"
    j = RunJournal(jpath, run_id="rt", validate=True)
    for name, spec in sorted(schema["events"].items()):
        j.emit(name, **{f: 0 for f in spec["required"]})
    j.close()
    assert j.schema_violations == 0
    types = [e["type"] for e in _read_events(jpath)]
    assert set(types) == set(schema["events"])


def test_validator_flags_missing_and_unknown_field(tmp_path):
    j = RunJournal(tmp_path / "j.jsonl", run_id="rt", validate=True)
    j.emit("round", last=3)            # missing required 'first'
    j.emit("round", first=1, bogus_zz=2)   # unknown field on closed event
    j.emit("backend_probe", ok=True, timeout_s=3)  # external fields
    j.close()
    problems = {(e["problem"], e.get("field"))
                for e in _read_events(tmp_path / "j.jsonl")
                if e["type"] == "schema_violation"}
    assert problems == {("missing_field", "first"),
                        ("unknown_field", "bogus_zz")}


def test_validator_dedups_and_open_events(tmp_path):
    j = RunJournal(tmp_path / "j.jsonl", run_id="rt", validate=True)
    for _ in range(5):
        j.emit("totally_unknown_zz", x=1)
    j.emit("program_cost", name="p", anything_goes=1, whatever=2)
    j.close()
    assert j.schema_violations == 1


def test_validate_false_disarms(tmp_path):
    j = RunJournal(tmp_path / "j.jsonl", run_id="rt", validate=False)
    j.emit("totally_unknown_zz", x=1)
    j.close()
    assert j.schema_violations == 0
    assert all(e["type"] != "schema_violation"
               for e in _read_events(tmp_path / "j.jsonl"))


# ------------------------------------------------------------------- CLI

def test_cli_exit_codes(capsys):
    bad = str(FIXTURES / "o01_bad.py")
    good = str(FIXTURES / "o01_good.py")
    schema = ["--schema", str(FIXTURE_SCHEMA)]
    assert lint_main(["--telemetry", good, "--no-baseline"] + schema) == 0
    assert lint_main(["--telemetry", bad, "--no-baseline"] + schema) == 1
    out = capsys.readouterr().out
    assert "O01" in out and "o01_bad.py" in out
    assert lint_main(["--telemetry", bad, "--no-baseline",
                      "--rules", "O99"]) == 2
    assert lint_main(["--telemetry", good, "--no-baseline",
                      "--schema", str(FIXTURES / "no_such_schema.json")]) == 2
    # the package, against its checked-in registry and baseline
    assert lint_main(["--telemetry"]) == 0
    assert lint_main([]) == 0
    assert lint_main(["--all"]) == 0
    assert "locklint" in capsys.readouterr().out


def test_cli_json_format(capsys):
    assert lint_main(["--telemetry", str(FIXTURES / "o03_bad.py"),
                      "--no-baseline", "--schema", str(FIXTURE_SCHEMA),
                      "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in payload["findings"]} == {"O03"}
    assert payload["coverage"]["metric_sites"] > 0


def test_cli_baseline_ratchet(tmp_path):
    bad = str(FIXTURES / "o05_bad.py")
    bl = tmp_path / "bl.json"
    schema = ["--schema", str(FIXTURE_SCHEMA)]
    assert lint_main(["--telemetry", bad, "--baseline", str(bl),
                      "--baseline-update"] + schema) == 0
    keys = set(json.loads(bl.read_text())["findings"])
    assert keys and all(":O05:" in k for k in keys)
    assert lint_main(["--telemetry", bad, "--baseline", str(bl)]
                     + schema) == 0


def test_cli_schema_update_roundtrip(tmp_path, capsys):
    schema_path = tmp_path / "schema.json"
    paths = [str(FIXTURES / "o01_good.py"), str(FIXTURES / "o03_good.py")]
    assert lint_main(["--telemetry", "--schema-update",
                      "--schema", str(schema_path)] + paths) == 0
    assert "schema updated" in capsys.readouterr().out
    assert lint_main(["--telemetry", "--schema-update",
                      "--schema", str(schema_path)] + paths) == 0
    assert "0 addition(s)" in capsys.readouterr().out
    assert lint_main(["--telemetry", "--no-baseline",
                      "--schema", str(schema_path)] + paths) == 0


def test_rule_registry_complete():
    assert RULE_IDS == ("O01", "O02", "O03", "O04", "O05")
    assert set(RULE_TITLES) == set(RULE_IDS)
