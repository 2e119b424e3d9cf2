"""The port's static lint J01-J06 (``fed_tgan_torch/analysis/rules/``):
the torch-idiom fixture twins, findings and hints, the escape comment,
the CLI's rule selection and exit codes, and the repo gate.

- every bad twin ``tests/torch_lint_fixtures/j0N_bad.py`` gives exactly
  the (rule, line) pairs its ``# EXPECT:`` markers state (J05's findings
  are L01's, as in the JAX package), every good twin none;
- ``# torchlint: disable=<id>`` silences that rule on its line or the
  line below, another id or JAX's ``# jaxlint:`` spelling does not;
- the registry holds JAX's J01-J06 ids beside L01-L04, and the package
  has no finding outside the checked-in baseline.
"""

import re
from pathlib import Path

import pytest

from fed_tgan_torch.analysis.__main__ import main as lint_main
from fed_tgan_torch.analysis.lint import (
    DEFAULT_BASELINE_PATH,
    apply_baseline,
    load_baseline,
    run_lint,
)
from fed_tgan_torch.analysis.rules import ALL_RULES, RULES_BY_ID
from fed_tgan_tpu.analysis.rules import RULES_BY_ID as JAX_RULES

FIXTURES = Path(__file__).parent / "torch_lint_fixtures"
_EXPECT_RE = re.compile(r"# EXPECT: ([JL]\d\d)")
J_IDS = ("J01", "J02", "J03", "J04", "J05", "J06")


def _expected(path: Path) -> set:
    return {(m.group(1), i)
            for i, line in enumerate(path.read_text().splitlines(), 1)
            for m in [_EXPECT_RE.search(line)] if m}


@pytest.mark.parametrize("rule_id", ["j01", "j02", "j03", "j04", "j05",
                                     "j06"])
def test_bad_twin_exact_findings(rule_id):
    path = FIXTURES / f"{rule_id}_bad.py"
    expected = _expected(path)
    assert expected, f"{path.name} carries no EXPECT markers"
    assert {(f.rule, f.line) for f in run_lint(paths=[path])} == expected


@pytest.mark.parametrize("rule_id", ["j01", "j02", "j03", "j04", "j05",
                                     "j06"])
def test_good_twin_zero_findings(rule_id):
    findings = run_lint(paths=[FIXTURES / f"{rule_id}_good.py"])
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("rule_id", ["J01", "J02", "J03", "J04", "J06"])
def test_each_rule_alone_finds_its_twin(rule_id):
    """Run alone, a rule finds exactly its own markers of its bad twin."""
    path = FIXTURES / f"{rule_id.lower()}_bad.py"
    got = {(f.rule, f.line)
           for f in run_lint(paths=[path], rules=[RULES_BY_ID[rule_id]])}
    assert got == _expected(path)


def test_findings_carry_hint_and_key():
    f = run_lint(paths=[FIXTURES / "j01_bad.py"])[0]
    assert f.rule == "J01" and f.hint
    assert f.key == f"{f.path}:{f.rule}:{f.line}"
    assert f"{f.path}:{f.line}" in f.render()


def test_inline_suppression(tmp_path):
    src = FIXTURES / "j02_bad.py"
    sup = tmp_path / "suppressed.py"
    sup.write_text(src.read_text().replace("# EXPECT: J02",
                                           "# torchlint: disable=J02"))
    assert run_lint(paths=[sup]) == []
    wrong = tmp_path / "wrong_rule.py"
    wrong.write_text(src.read_text().replace("# EXPECT: J02",
                                             "# torchlint: disable=J01"))
    assert len(run_lint(paths=[wrong])) == len(_expected(src))
    jax_style = tmp_path / "jax_escape.py"
    jax_style.write_text(src.read_text().replace("# EXPECT: J02",
                                                 "# jaxlint: disable=J02"))
    assert len(run_lint(paths=[jax_style])) == len(_expected(src))


def test_suppression_on_the_line_above(tmp_path):
    """The escape comment with its reason on the line above a finding."""
    p = tmp_path / "above.py"
    p.write_text("import torch\n\n\ndef f(x: torch.Tensor, n):\n"
                 "    for _ in range(n):\n"
                 "        # torchlint: disable=J01 -- the loop's one read\n"
                 "        y = x.item()\n    return y\n")
    assert run_lint(paths=[p]) == []
    p.write_text(p.read_text().replace("# torchlint: disable=J01 -- the "
                                       "loop's one read", "# a comment"))
    assert [(f.rule, f.line) for f in run_lint(paths=[p])] == [("J01", 7)]


def test_rule_registry_keeps_jax_ids():
    ids = [r.rule_id for r in ALL_RULES]
    assert ids == list(J_IDS) + ["L01", "L02", "L03", "L04"]
    assert set(J_IDS) <= set(JAX_RULES)
    assert all(r.hint and r.title for r in ALL_RULES)
    # J05 is JAX's deprecation shim: registered, finds nothing
    assert list(RULES_BY_ID["J05"].check(None)) == []


def test_cli_rule_selection_and_exit_codes(capsys):
    for i in (1, 2, 3, 4, 6):
        bad = str(FIXTURES / f"j0{i}_bad.py")
        good = str(FIXTURES / f"j0{i}_good.py")
        assert lint_main([bad, "--no-baseline", "--rules", "J01-J06"]) == 1
        assert lint_main([good, "--no-baseline", "--rules", "J01-J06"]) == 0
        # the L rules find nothing in the J twins
        assert lint_main([bad, "--no-baseline", "--rules", "L01-L04"]) == 0
    assert lint_main([str(FIXTURES / "j02_bad.py"), "--no-baseline",
                      "--rules", "J99"]) == 2
    out = capsys.readouterr().out
    assert "J02" in out and "torchlint+locklint:" in out


def test_cli_baseline_ratchet(tmp_path, capsys):
    bad = str(FIXTURES / "j06_bad.py")
    base = tmp_path / "baseline.json"
    assert lint_main([bad, "--baseline", str(base)]) == 1
    assert lint_main([bad, "--baseline", str(base),
                      "--baseline-update"]) == 0
    assert lint_main([bad, "--baseline", str(base)]) == 0
    assert "baselined" in capsys.readouterr().out


def test_repo_gate_has_no_unbaselined_finding():
    """The package under J01-J06 + L01-L04 against the shipped baseline:
    zero new findings, and no stale entry."""
    findings = run_lint()
    new, _old, stale = apply_baseline(findings,
                                      load_baseline(DEFAULT_BASELINE_PATH))
    assert new == [], "\n".join(f.render() for f in new)
    assert not {k for k in stale if not k.split(":")[1].startswith("O")}
