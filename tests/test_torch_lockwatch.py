"""The port's locklint and lockwatch (``fed_tgan_torch/analysis/lint.py``,
``concurrency/``, ``lockwatch.py``) against the JAX package's.

- static: the L01-L04 fixture twins and the fleet shed deadlock of
  ``tests/lint_fixtures/`` (read as text, never imported) give the
  port's rules exactly their ``# EXPECT`` findings, the same as JAX's
  rules; the inline escape is ``# torchlint: disable=LXX``; the CLI's
  rule ranges and exit codes; the package gate against its baseline;
- runtime: JAX's lockwatch unit tests (re-entry, cycles, hold and wait
  histograms, the registry export, zero cost when uninstalled,
  ``Condition``/``Queue`` compatibility) on the port's copy, and the
  fleet's ``submit`` -> ``_shed`` re-entry shape raising instead of
  hanging (a copy of the fixture's class, defined here).
"""

import re
import threading
import time
from pathlib import Path

import pytest

from fed_tgan_torch.analysis import lockwatch
from fed_tgan_torch.analysis.__main__ import expand_rule_ids
from fed_tgan_torch.analysis.__main__ import main as lint_main
from fed_tgan_torch.analysis.lint import (
    DEFAULT_BASELINE_PATH,
    RULES_BY_ID,
    apply_baseline,
    load_baseline,
    run_lint,
)
from fed_tgan_tpu.analysis.lint import run_lint as jax_run_lint
from fed_tgan_tpu.analysis.rules import RULES_BY_ID as JAX_RULES

FIXTURES = Path(__file__).parent / "lint_fixtures"
_EXPECT_RE = re.compile(r"# EXPECT: ([JL]\d\d)")
L_IDS = ("L01", "L02", "L03", "L04")


def _expected(path: Path):
    out = set()
    for i, line in enumerate(path.read_text().splitlines(), 1):
        m = _EXPECT_RE.search(line)
        if m:
            out.add((m.group(1), i))
    return out


def _found(path: Path) -> set:
    return {(f.rule, f.line) for f in run_lint(paths=[path])}


# ------------------------------------------------------- static fixtures

@pytest.mark.parametrize("rule_id", ["l01", "l02", "l03", "l04"])
def test_bad_twin_exact_findings(rule_id):
    path = FIXTURES / f"{rule_id}_bad.py"
    expected = _expected(path)
    assert expected, f"{path.name} carries no EXPECT markers"
    assert _found(path) == expected


@pytest.mark.parametrize("rule_id", ["l01", "l02", "l03", "l04"])
def test_good_twin_zero_findings(rule_id):
    findings = run_lint(paths=[FIXTURES / f"{rule_id}_good.py"])
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("name", [
    "l01_bad", "l01_good", "l02_bad", "l02_good", "l03_bad", "l03_good",
    "l04_bad", "l04_good", "j05_bad", "fleet_shed_deadlock"])
def test_findings_equal_jax_locklint(name):
    """The copied rules find what JAX's L01-L04 find, with the same
    messages, on every concurrency fixture."""
    path = FIXTURES / f"{name}.py"
    jax = jax_run_lint(paths=[path], rules=[JAX_RULES[r] for r in L_IDS])
    port = run_lint(paths=[path])
    assert [(f.rule, f.line, f.message) for f in port] == [
        (f.rule, f.line, f.message) for f in jax]


def test_fleet_shed_deadlock_static():
    """The fleet's shape (submit holds _adm_lock -> _shed re-acquires) is
    flagged by L02 at the re-acquire site."""
    path = FIXTURES / "fleet_shed_deadlock.py"
    assert _found(path) == _expected(path)
    (finding,) = run_lint(paths=[path])
    assert finding.rule == "L02" and "_adm_lock" in finding.message


def test_inline_suppression(tmp_path):
    src = FIXTURES / "l02_bad.py"
    p = tmp_path / "suppressed.py"
    p.write_text(src.read_text().replace("# EXPECT: L02",
                                         "# torchlint: disable=L02"))
    assert run_lint(paths=[p]) == []
    wrong = tmp_path / "wrong_rule.py"
    wrong.write_text(src.read_text().replace("# EXPECT: L02",
                                             "# torchlint: disable=L01"))
    assert len(run_lint(paths=[wrong])) == len(_expected(src))
    # the JAX package's escape is not the port's
    jax_style = tmp_path / "jax_escape.py"
    jax_style.write_text(src.read_text().replace("# EXPECT: L02",
                                                 "# jaxlint: disable=L02"))
    assert len(run_lint(paths=[jax_style])) == len(_expected(src))


# ------------------------------------------------------------------- CLI

def test_rule_range_expansion():
    assert expand_rule_ids("L01-L04") == ["L01", "L02", "L03", "L04"]
    assert expand_rule_ids("L01-04") == ["L01", "L02", "L03", "L04"]
    assert expand_rule_ids(" L03 , L01-L02 ") == ["L03", "L01", "L02"]
    with pytest.raises(KeyError):
        expand_rule_ids("L01-J04")


def test_cli_exit_codes(capsys):
    bad = str(FIXTURES / "l03_bad.py")
    good = str(FIXTURES / "l03_good.py")
    assert lint_main([good, "--no-baseline", "--rules", "L01-L04"]) == 0
    assert lint_main([bad, "--no-baseline", "--rules", "L01-L04"]) == 1
    assert lint_main([bad, "--no-baseline", "--rules", "L01,L02"]) == 0
    # the J rules (JAX's ids in torch idiom) find nothing in a locklint
    # fixture; an unknown id is a usage error
    assert lint_main([bad, "--no-baseline", "--rules", "J01-J06"]) == 0
    assert lint_main([bad, "--no-baseline", "--rules", "L99"]) == 2
    assert lint_main([bad, "--no-baseline", "--rules", "L01-J04"]) == 2
    assert sorted(RULES_BY_ID) == [f"J0{i}" for i in range(1, 7)] + list(
        L_IDS)
    capsys.readouterr()


def test_cli_baseline_ratchet(tmp_path, capsys):
    bad = str(FIXTURES / "l01_bad.py")
    base = tmp_path / "baseline.json"
    assert lint_main([bad, "--baseline", str(base)]) == 1
    assert lint_main([bad, "--baseline", str(base),
                      "--baseline-update"]) == 0
    assert lint_main([bad, "--baseline", str(base)]) == 0
    out = capsys.readouterr().out
    assert "locklint:" in out and "baselined" in out


def test_repo_locklint_gate():
    """The package under L01-L04 against the shipped baseline: zero new
    findings."""
    findings = run_lint()
    new, _old, _stale = apply_baseline(findings,
                                       load_baseline(DEFAULT_BASELINE_PATH))
    assert new == [], "\n".join(f.render() for f in new)


# -------------------------------------------------------------- lockwatch

def test_lockwatch_reentry_raises():
    with lockwatch.watch():
        lk = threading.Lock()
        lockwatch.set_name(lk, "reentry_demo")
        with lk:
            with pytest.raises(lockwatch.DeadlockError):
                lk.acquire()
    reps = lockwatch.reports("reentry")
    assert reps and reps[0].locks == ("reentry_demo",)


def test_lockwatch_rlock_reentry_is_fine():
    with lockwatch.watch():
        rl = threading.RLock()
        with rl:
            with rl:
                pass
    assert lockwatch.reports() == []


def test_lockwatch_cycle_detection():
    with lockwatch.watch(on_deadlock="record"):
        a, b = threading.Lock(), threading.Lock()
        lockwatch.set_name(a, "A")
        lockwatch.set_name(b, "B")
        with a:
            with b:
                pass

        def reverse():
            with b:
                with a:
                    pass

        t = threading.Thread(target=reverse)
        t.start()
        t.join()
    cycles = lockwatch.reports("cycle")
    assert len(cycles) == 1
    cyc = cycles[0].locks
    assert cyc[0] == cyc[-1] and set(cyc) == {"A", "B"}


def test_lockwatch_cycle_raise_policy():
    with lockwatch.watch(on_deadlock="raise"):
        a, b = threading.Lock(), threading.Lock()
        lockwatch.set_name(a, "RA")
        lockwatch.set_name(b, "RB")
        with a:
            with b:
                pass
        box = []

        def reverse():
            try:
                with b:
                    with a:
                        pass
            except lockwatch.DeadlockError as exc:
                box.append(exc)

        t = threading.Thread(target=reverse)
        t.start()
        t.join()
        assert box, "closing the cycle should raise under on_deadlock=raise"


def test_lockwatch_hold_histograms_and_naming():
    with lockwatch.watch():
        lk = threading.Lock()
        lockwatch.set_name(lk, "timed")
        for _ in range(3):
            with lk:
                time.sleep(0.01)
        s = lockwatch.summary()
    assert s["timed"]["acquisitions"] == 3
    assert s["timed"]["hold_p99_ms"] >= 5.0
    assert s["timed"]["hold_p50_ms"] <= s["timed"]["hold_max_ms"]


def test_lockwatch_contention_tracked():
    with lockwatch.watch():
        lk = threading.Lock()
        lockwatch.set_name(lk, "contended")

        def holder():
            with lk:
                time.sleep(0.05)

        t = threading.Thread(target=holder)
        t.start()
        time.sleep(0.01)
        with lk:
            pass
        t.join()
        s = lockwatch.summary()["contended"]
    assert s["contentions"] >= 1
    assert s["wait_p99_ms"] > 0


def test_lockwatch_registry_export_incremental():
    from fed_tgan_torch.obs.registry import MetricsRegistry

    with lockwatch.watch():
        lk = threading.Lock()
        lockwatch.set_name(lk, "exported")
        with lk:
            pass
    reg = MetricsRegistry()
    lockwatch.export_to_registry(reg)
    h = reg.get('fed_tgan_lock_hold_seconds{lock="exported"}')
    assert h is not None and h.count == 1
    lockwatch.export_to_registry(reg)  # no double count
    assert h.count == 1
    assert 'lock="exported"' in reg.render_prometheus()


def test_lockwatch_uninstalled_is_zero_cost():
    assert not lockwatch.installed()
    assert threading.Lock is lockwatch._REAL_LOCK
    assert threading.RLock is lockwatch._REAL_RLOCK
    with lockwatch.watch():
        lk = threading.Lock()
        assert isinstance(lk, lockwatch.WatchedLock)
    before = lockwatch.summary()
    with lk:
        pass
    assert lockwatch.summary() == before


def test_lockwatch_condition_and_queue_compatible():
    import queue

    with lockwatch.watch():
        q = queue.Queue()
        q.put("x")
        assert q.get(timeout=1) == "x"
        cv = threading.Condition()
        hits = []

        def waiter():
            with cv:
                cv.wait(timeout=2)
                hits.append(1)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cv:
            cv.notify()
        t.join()
    assert hits == [1]
    assert lockwatch.reports() == []


class _MiniFleetService:
    """The fleet's admission shape in the deadlocking form
    (``tests/lint_fixtures/fleet_shed_deadlock.py``): ``submit`` holds
    ``_adm_lock`` and calls ``_shed``, which takes it again."""

    def __init__(self, max_inflight: int):
        self._adm_lock = threading.Lock()
        self._inflight = {}
        self.max_inflight = max_inflight
        self.shed = 0

    def submit(self, key) -> bool:
        with self._adm_lock:
            if len(self._inflight) >= self.max_inflight:
                self._shed()
                return False
            self._inflight[key] = True
            return True

    def _shed(self) -> None:
        with self._adm_lock:
            self.shed += 1

    def finish(self, key) -> None:
        with self._adm_lock:
            self._inflight.pop(key, None)


def test_fleet_shed_deadlock_dynamic():
    """With lockwatch armed, the over-capacity submit raises
    DeadlockError at the ``_shed`` re-acquire instead of hanging."""
    with lockwatch.watch():
        svc = _MiniFleetService(max_inflight=1)
        assert svc.submit("a") is True
        with pytest.raises(lockwatch.DeadlockError):
            svc.submit("b")
        reps = lockwatch.reports("reentry")
    assert reps and "test_torch_lockwatch" in reps[0].locks[0]
    svc2 = _MiniFleetService(max_inflight=1)
    assert svc2.submit("a") is True
    svc2.finish("a")
    assert svc2.submit("b") is True


def test_port_locks_carry_curated_names():
    """The fleet's admission lock and the row pool's lock are named for
    the budgets (``fleet_adm``, ``row_pool``) when watched."""
    from fed_tgan_torch.serve.pool import RowPool

    with lockwatch.watch():
        pool = RowPool(fleet=None)
    assert pool._lock.name == "row_pool"
    from fed_tgan_torch.serve import fleet as fleet_mod

    src = Path(fleet_mod.__file__).read_text()
    assert 'lockwatch.set_name(self._adm_lock, "fleet_adm")' in src
