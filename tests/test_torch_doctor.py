"""The port's doctor (``python -m fed_tgan_torch.doctor``) and the cost
ledger CLI (``python -m fed_tgan_torch.obs ledger``) on the CPU.

- ``--device cpu``: every one of the 25 checks prints ``OK`` and the
  exit code is 0 (the counterpart of JAX's
  ``test_doctor_cli_all_green_on_cpu``); the backend and kernel checks say
  why they do not apply, ``launch-pod`` parses the launcher's plan;
- the default device is the card: without CUDA the backend probe and the
  device check FAIL, nothing else runs and the exit code is 1;
- ``--wait-healthy`` (JAX's ``wait_healthy`` through its seams): it
  returns at the first healthy probe, defers under load, holds the quiet
  window after a failure, gives up at its deadline and always ignores the
  probe's stamp;
- ``obs ledger --device cpu [--json]``: one entry per program family with
  flops and bytes above 0 (peak bytes are 0 on the CPU), JAX's table
  header; an unknown family or a missing card exits 2.
"""

import json
import re

import pytest
import torch

from fed_tgan_torch import doctor
from fed_tgan_torch.obs.__main__ import main as obs_main
from fed_tgan_torch.obs.ledger import FAMILIES

torch.set_num_threads(2)

CHECKS = ("runtime", "backend", "device", "kernels", "transport",
          "robust-agg", "precision", "rounds-per-program", "cohort",
          "onboarding", "elastic", "observability", "observatory",
          "cost-ledger", "serving", "fleet", "front-door", "canary",
          "locklint", "obslint", "static-analysis", "program-contracts",
          "analysis-all", "backend-seam", "launch-pod")


def test_doctor_all_green_on_cpu(capsys):
    assert doctor.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if re.match(r"(OK  |FAIL) ", ln)]
    assert [ln.split()[1].rstrip(":") for ln in lines] == list(CHECKS)
    assert all(ln.startswith("OK  ") for ln in lines), out
    assert len(CHECKS) == 25
    assert f"{len(CHECKS)}/{len(CHECKS)} checks passed" in out
    by_name = {ln.split()[1].rstrip(":"): ln for ln in lines}
    assert "does not apply on the CPU" in by_name["kernels"]
    assert "does not apply: --device cpu runs no probe" in by_name["backend"]
    assert "torch-free parent" in by_name["launch-pod"]
    assert "gloo/gloo/gloo = choose_backend's" in by_name["backend-seam"]
    assert "parallel_fedavg through the cpu backend = its contracts" in \
        by_name["backend-seam"]
    assert "rules J01-J06 + L01-L04" in by_name["static-analysis"]
    assert "42 program(s) across 6 family(ies): 0 regression(s)" in \
        by_name["program-contracts"]
    assert "3 prong(s) ok: torchlint+locklint, obslint, program " \
        "contracts" in by_name["analysis-all"]


def _planted_contracts(tmp_path, family: str):
    """A copy of the CPU contracts where ``family``'s first program looks
    one sync better than it is: the current dispatch regresses."""
    import shutil

    from fed_tgan_torch.analysis.contracts.check import CONTRACTS_DIR

    for p in CONTRACTS_DIR.glob("*.json"):
        shutil.copy(p, tmp_path / p.name)
    path = tmp_path / f"{family}.json"
    data = json.loads(path.read_text())
    first = sorted(data["programs"])[0]
    data["programs"][first]["transfers"]["in_bytes"] -= 4
    path.write_text(json.dumps(data))
    return first


def test_static_analysis_fails_on_a_planted_finding(tmp_path, capsys):
    from pathlib import Path

    bad = Path(__file__).parent / "torch_lint_fixtures" / "j01_bad.py"
    assert not doctor.check_static_analysis(
        "cpu", paths=[bad], baseline=tmp_path / "none.json")
    out = capsys.readouterr().out
    assert out.startswith("FAIL static-analysis: 6 non-baselined finding(s)")
    assert "j01_bad.py:J01:14" in out


def test_program_contracts_fail_on_a_planted_regression(tmp_path, capsys):
    first = _planted_contracts(tmp_path, "ingest")
    assert not doctor.check_program_contracts(
        "cpu", contracts_dir=tmp_path, families=("ingest",))
    out = capsys.readouterr().out
    assert out.startswith(f"FAIL program-contracts: REGRESSION ingest/"
                          f"{first}: transfers.in_bytes")
    assert "--contracts --explain" in out
    (tmp_path / "ingest.json").write_text("{")
    assert not doctor.check_program_contracts(
        "cpu", contracts_dir=tmp_path, families=("ingest",))
    out = capsys.readouterr().out
    assert out.startswith("FAIL program-contracts: exit 2 (the harness "
                          "cannot run or a contract is unreadable)")
    assert "bad contract" in out


def test_analysis_all_fails_on_a_planted_regression(tmp_path, capsys):
    _planted_contracts(tmp_path, "ingest")
    assert not doctor.check_analysis_all(
        "cpu", contracts_dir=tmp_path, families=("ingest",))
    out = capsys.readouterr().out
    assert out.startswith("FAIL analysis-all: exit 1: program contracts "
                          "FINDINGS")


def test_backend_seam_contract_half_fails_on_a_planted_change(tmp_path,
                                                             capsys):
    first = _planted_contracts(tmp_path, "parallel_fedavg")
    assert not doctor.check_backend_seam("cpu", contracts_dir=tmp_path)
    out = capsys.readouterr().out
    assert out.startswith("FAIL backend-seam: 1/11 parallel_fedavg "
                          "program(s) differ from the cpu contracts: "
                          f"{first}")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA")
def test_doctor_never_falls_back_to_the_cpu(capsys):
    assert doctor.main([]) == 1
    out = capsys.readouterr().out
    assert "FAIL backend: backend probe crashed" in out
    assert "FAIL device: CUDA is not available" in out
    assert "1/3 checks passed" in out and "serving" not in out


def _waiter(probes, loads=None, timeout_min=0.0, quiet_min=45.0):
    """Run ``wait_healthy`` on scripted probes and loads with a fake clock;
    returns its verdict, the sleeps and the log."""
    clock = [0.0]
    sleeps, logs = [], []
    probes, loads = list(probes), list(loads or [])

    def sleep(s):
        sleeps.append(s)
        clock[0] += s

    import unittest.mock as mock

    with mock.patch.object(doctor.time, "monotonic", lambda: clock[0]):
        ok = doctor.wait_healthy(
            timeout_min=timeout_min, quiet_min=quiet_min,
            _probe=lambda: probes.pop(0), _sleep=sleep, _log=logs.append,
            _load=lambda: loads.pop(0) if loads else 0.0)
    return ok, sleeps, logs


def test_wait_healthy_returns_at_the_first_healthy_probe():
    ok, sleeps, logs = _waiter([(False, "hung CUDA init"), (True, "")],
                               quiet_min=2.0)
    assert ok and sleeps == [120.0]
    assert "probe failed (hung CUDA init); quiet window 2.0 min" in logs[0]
    assert logs[-1] == "doctor: CUDA backend healthy"


def test_wait_healthy_defers_under_load_and_gives_up_at_its_deadline():
    busy = max(1.0, 0.75 * (doctor.os.cpu_count() or 1))
    ok, sleeps, logs = _waiter([(False, "x")] * 5, loads=[busy, 0.0, 0.0],
                               timeout_min=3.0, quiet_min=0.5)
    assert not ok
    assert "host busy" in logs[0] and sleeps[0] == 120.0
    assert sleeps[1:] == [30.0, 30.0]  # the quiet windows, then the deadline
    assert logs[-1] == "doctor: wait-healthy timed out"


def test_wait_healthy_ignores_the_probe_stamp(monkeypatch, capsys):
    from fed_tgan_torch.runtime import backend

    seen = []

    def probe(**kw):
        seen.append(kw)
        return True, ""

    monkeypatch.setattr(backend, "probe_backend_responsive", probe)
    monkeypatch.setattr(doctor.os, "getloadavg", lambda: (0.0, 0.0, 0.0))
    assert doctor.main(["--wait-healthy", "--wait-timeout-min", "2",
                        "--probe-timeout", "7"]) == 0
    assert seen == [{"timeout_s": 7, "ignore_cache": True}]
    assert doctor.main(["--wait-healthy", "--device", "cpu"]) == 0
    assert "the CPU needs no probe" in capsys.readouterr().out
    assert len(seen) == 1


def test_ledger_every_family_costed_on_cpu(capsys):
    assert obs_main(["ledger", "--device", "cpu", "--json"]) == 0
    entries = json.loads(capsys.readouterr().out)
    assert {e["family"] for e in entries.values()} == set(FAMILIES)
    assert {"train_step[stack2@f32]", "train_step[stack2@bf16]"} <= set(
        entries)
    for name, e in entries.items():
        assert e["flops"] > 0 and e["bytes_accessed"] > 0, name
        assert e["peak_bytes"] == 0  # no device memory on the CPU
    assert obs_main(["ledger", "--device", "cpu", "--family",
                     "serve_engine"]) == 0
    table = capsys.readouterr().out.splitlines()
    assert table[0].split() == ["program", "family", "Mflops", "MB",
                                "accessed", "peak", "MB", "donated", "MB"]
    assert len(table) == 2 and table[1].startswith("serve_chunk[")


def test_ledger_refusals(capsys):
    assert obs_main(["ledger", "--device", "cpu", "--family", "nope"]) == 2
    assert "unknown families ['nope']" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert obs_main(["ledger", "--family", "monitor"]) == 2
        assert "CUDA" in capsys.readouterr().out
