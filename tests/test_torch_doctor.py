"""The port's doctor (``python -m fed_tgan_torch.doctor``) and the cost
ledger CLI (``python -m fed_tgan_torch.obs ledger``) on the CPU.

- ``--device cpu``: every check prints ``OK`` and the exit code is 0 (the
  counterpart of JAX's ``test_doctor_cli_all_green_on_cpu``); the kernel
  check says why it does not apply;
- the default device is the card: without CUDA the device check FAILs,
  nothing else runs and the exit code is 1;
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

CHECKS = ("runtime", "device", "kernels", "transport", "robust-agg",
          "precision", "rounds-per-program", "cohort", "onboarding",
          "elastic", "observability", "observatory", "cost-ledger",
          "serving", "fleet", "front-door", "canary", "locklint", "obslint")


def test_doctor_all_green_on_cpu(capsys):
    assert doctor.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if re.match(r"(OK  |FAIL) ", ln)]
    assert [ln.split()[1].rstrip(":") for ln in lines] == list(CHECKS)
    assert all(ln.startswith("OK  ") for ln in lines), out
    assert f"{len(CHECKS)}/{len(CHECKS)} checks passed" in out
    kernels = next(ln for ln in lines if ln.split()[1] == "kernels:")
    assert "does not apply on the CPU" in kernels


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA")
def test_doctor_never_falls_back_to_the_cpu(capsys):
    assert doctor.main([]) == 1
    out = capsys.readouterr().out
    assert "FAIL device: CUDA is not available" in out
    assert "1/2 checks passed" in out and "serving" not in out


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
