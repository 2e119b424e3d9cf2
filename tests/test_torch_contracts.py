"""The port's program contracts (``fed_tgan_torch/analysis/contracts/``)
on the CPU.

- the recorder on toy dispatches: a host sync with its op and call site,
  the dtype census (f64 included), the boundary, K1/K2 calls with the
  census suspended inside the wrappers (no launch counted on the CPU),
  the all-gather of a 1-rank world with its payload bytes;
- the two-sided diff against JAX's ``diff_contracts`` on the same
  fingerprint pairs: the same issue kinds (severity, program, metric, old,
  new);
- the requirements (``dtypes_present``, ``dispatch_scale``,
  ``independent_of``) on synthetic fingerprints;
- ``run_contracts`` on a toy family in temporary directories: exit 0
  clean, 1 on a planted ``.item()`` (``--explain`` names
  ``_local_scalar_dense`` and its line in this file) and on a planted f64
  op, 0 with the stale warning on an improvement, 1 on a missing or
  extra program, 2 on an unreadable contract or a harness that cannot
  run; the CLI's exit codes on one real family;
- the checked-in contracts: every JAX program name has its port program,
  each family's requirement blocks are the harness's, the card's
  contracts call the kernels as the CPU's do; the repo gate
  ``python -m fed_tgan_torch.analysis --contracts`` exits 0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fed_tgan_torch.analysis.__main__ import main as analysis_main
from fed_tgan_torch.analysis.contracts import check, harness
from fed_tgan_torch.analysis.contracts.ir import (
    DispatchRecorder,
    Fingerprint,
    boundary,
)
from fed_tgan_torch.ops import activate_cuda
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.backend import (
    BackendNotPortedError,
    contracts_dir_for,
)
from fed_tgan_tpu.analysis.contracts import check as jax_check
from fed_tgan_tpu.analysis.contracts.ir import Fingerprint as JaxFingerprint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_CONTRACTS = REPO / "fed_tgan_tpu" / "analysis" / "contracts"
FAMILIES = ("train_federated", "fused_rounds", "cohort_rounds",
            "parallel_fedavg", "ingest", "serve_engine")


# ------------------------------------------------------------- recorder

def test_recorder_counts_a_sync_with_its_site():
    x = torch.arange(4.0)
    with DispatchRecorder("cpu") as rec:
        v = x.sum().item()  # the sync
    fp = rec.fingerprint((x,), [v])
    assert fp.transfers["syncs"] == 1
    assert fp.host_ops == {"_local_scalar_dense": 1}
    assert (fp.transfers["n_inputs"], fp.transfers["in_bytes"]) == (1, 16)
    assert (fp.transfers["n_outputs"], fp.transfers["copies"]) == (0, 0)
    assert fp.dtypes == {"f32": 1} and fp.ops == 2
    (site,) = fp.sites["transfers.syncs"]
    assert site.startswith("_local_scalar_dense @ tests/"
                           "test_torch_contracts.py:")
    assert "x.sum().item()" in site


def test_recorder_dtype_census_and_f64():
    with DispatchRecorder("cpu") as rec:
        a = torch.ones(3, dtype=torch.float64) * 2
        b = (torch.ones(2, dtype=torch.bfloat16) > 0).to(torch.int64)
    fp = rec.fingerprint((), (a, b))
    assert fp.dtypes["f64"] == 2 and fp.dtypes["bf16"] == 1
    assert fp.dtypes["i1"] == 1 and fp.dtypes["i64"] == 1
    assert (fp.transfers["n_outputs"], fp.transfers["out_bytes"]) == (2, 40)
    assert fp.sites["dtypes.f64"]


def test_recorder_counts_kernel_calls_and_suspends_the_census():
    spec = SegmentSpec.from_output_info(((1, "tanh"), (3, "softmax")))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((6, spec.dim), generator=gen, requires_grad=True)
    u = torch.rand((6, spec.dim), generator=gen)
    launches = (activate_cuda.fused_apply_activate.launches,
                activate_cuda.fused_activate_bwd.launches)
    with DispatchRecorder("cpu") as rec:
        activate_cuda.fused_apply_activate(x, spec, u).sum().backward()
        activate_cuda.fused_apply_activate(x.detach().bfloat16(), spec, u)
    fp = rec.fingerprint()
    assert fp.kernels == {"K1[f32]": 1, "K2[f32]": 1, "K1[bf16]": 1}
    # the plain versions' ops stay out of the census: what is left is the
    # sum, its backward, the detach and the cast
    assert fp.ops < 12 and "i64" not in fp.dtypes
    assert activate_cuda.observer is None
    # on the CPU no kernel launches: the counts stay the launches alone
    assert (activate_cuda.fused_apply_activate.launches,
            activate_cuda.fused_activate_bwd.launches) == launches


def test_boundary_counts_tensors_and_arrays():
    import numpy as np

    obj = {"a": torch.zeros(3), "b": [np.zeros(2, np.float32), 7, None],
           "c": (torch.zeros(2, dtype=torch.bfloat16),)}
    assert boundary(obj) == (3, 12 + 8 + 4)


def test_fingerprint_round_trip():
    fp = Fingerprint(collectives={"all_gather": {"count": 1, "bytes": 64}},
                     transfers={"syncs": 1, "n_inputs": 2},
                     dtypes={"f32": 3}, kernels={"K1[f32]": 2}, ops=9,
                     host_ops={"_local_scalar_dense": 1},
                     sites={"transfers.syncs": ["x"]})
    back = Fingerprint.from_dict(json.loads(json.dumps(fp.to_dict())))
    assert back.to_dict() == fp.to_dict() and back.sites == {}


def test_gather_program_records_its_collective():
    cur = harness.record_fingerprints(
        {"fam": {"gather": harness.ENTRYPOINT_FAMILIES[
            "parallel_fedavg"]["gather_leaves[f32]"]}}, device="cpu")
    fp = cur["fam"]["gather"]
    assert fp.collectives == {"all_gather": {"count": 1, "bytes": 64}}
    assert fp.transfers["n_inputs"] == 2 and fp.transfers["syncs"] == 0
    assert not torch.distributed.is_initialized()


# ----------------------------------------------------- the diff vs JAX's

def _fp(coll=None, n_in=1, in_bytes=16, dtypes=None):
    return {"collectives": coll or {},
            "transfers": {"n_inputs": n_in, "in_bytes": in_bytes,
                          "n_outputs": 1, "out_bytes": 8},
            "dtypes": dtypes or {"f32": 4}}


PAIRS = {
    "same": (_fp(), _fp()),
    "collective_added": (_fp(), _fp({"all_gather": {"count": 1,
                                                    "bytes": 64}})),
    "collective_dropped": (_fp({"all_reduce": {"count": 2, "bytes": 32}}),
                           _fp({"all_reduce": {"count": 1, "bytes": 16}})),
    "payload_grew": (_fp({"all_gather": {"count": 1, "bytes": 64}}),
                     _fp({"all_gather": {"count": 1, "bytes": 128}})),
    "boundary_grew": (_fp(), _fp(n_in=2, in_bytes=32)),
    "boundary_shrank": (_fp(n_in=3), _fp(n_in=1, in_bytes=8)),
    "f64_crept_in": (_fp(), _fp(dtypes={"f32": 4, "f64": 2})),
    "f64_left": (_fp(dtypes={"f32": 4, "f64": 2}), _fp()),
    "census_drift": (_fp(), _fp(dtypes={"f32": 5, "bf16": 1})),
}


def _kinds(issues) -> set:
    return {(i.severity, i.family, i.program, i.metric, str(i.old),
             str(i.new)) for i in issues}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_diff_matches_jax_diff_contracts(case):
    old, new = PAIRS[case]
    stored = {"fam": {"forbid_dtypes": ["f64"], "programs": {"p": old}}}
    port = check.diff_contracts({"fam": {"p": Fingerprint.from_dict(new)}},
                                stored)
    jax = jax_check.diff_contracts(
        {"fam": {"p": JaxFingerprint.from_dict(new)}}, stored)
    assert _kinds(port) == _kinds(jax)
    assert (case == "same") == (port == [])


def test_missing_and_extra_programs_match_jax():
    stored = {"fam": {"programs": {"gone": _fp(), "kept": _fp()}},
              "absent": None}
    cur = {"fam": {"kept": _fp(), "new": _fp()}, "absent": {"p": _fp()}}
    port = check.diff_contracts(
        {f: {n: Fingerprint.from_dict(d) for n, d in ps.items()}
         for f, ps in cur.items()}, stored)
    jax = jax_check.diff_contracts(
        {f: {n: JaxFingerprint.from_dict(d) for n, d in ps.items()}
         for f, ps in cur.items()}, stored)
    assert _kinds(port) == _kinds(jax)
    assert {i.severity for i in port} == {"regression"} and len(port) == 3


def test_port_fields_are_ratcheted_both_ways():
    old = {**_fp(), "kernels": {"K1[f32]": 2},
           "transfers": {**_fp()["transfers"], "syncs": 0, "copies": 1,
                         "copy_bytes": 64}}
    worse = Fingerprint.from_dict(old)
    worse.kernels = {"K1[f32]": 3}
    worse.transfers = {**old["transfers"], "syncs": 1}
    better = Fingerprint.from_dict(old)
    better.transfers = {**old["transfers"], "copies": 0, "copy_bytes": 0}
    stored = {"fam": {"programs": {"p": old}}}
    bad = check.diff_contracts({"fam": {"p": worse}}, stored)
    assert {(i.severity, i.metric) for i in bad} == {
        ("regression", "kernels.K1[f32]"), ("regression", "transfers.syncs")}
    good = check.diff_contracts({"fam": {"p": better}}, stored)
    assert {(i.severity, i.metric) for i in good} == {
        ("improvement", "transfers.copies"),
        ("improvement", "transfers.copy_bytes")}


def test_requirements():
    def fp(k1, syncs=0, dtypes=None, coll=None):
        return Fingerprint(kernels={"K1[f32]": k1, "K2[f32]": k1 // 2},
                           transfers={"syncs": syncs, "copies": 1},
                           dtypes=dtypes or {"f32": 1},
                           collectives=coll or {})

    progs = {"r1": fp(4), "r2": fp(8), "r2_unrolled": fp(8, syncs=2),
             "r2_short": fp(6), "bf16": fp(4, dtypes={"f32": 1}),
             "n64": fp(4, coll={"all_gather": {"count": 1, "bytes": 8}})}
    scale = {"dispatch_scale": {"vs": "r1", "rounds": 2}}
    assert check.check_requirements("f", "r2", scale, progs) == []
    for bad in ("r2_unrolled", "r2_short"):
        (iss,) = check.check_requirements("f", bad, scale, progs)
        assert iss.metric == "require.dispatch_scale"
    indep = {"independent_of": {"vs": "r1"}}
    assert check.check_requirements("f", "r1", indep, progs) == []
    (iss,) = check.check_requirements("f", "n64", indep, progs)
    assert "collectives" in str(iss.new)
    (iss,) = check.check_requirements("f", "bf16", {"dtypes_present": [
        "bf16", "f32"]}, progs)
    assert iss.metric == "require.dtypes_present.bf16"
    (iss,) = check.check_requirements("f", "r2", {"independent_of": {
        "vs": "gone"}}, progs)
    assert iss.new == "missing"


# ------------------------------------------------ run_contracts on a toy

PLANT = {"sync": False, "f64": False}


def _toy(h):
    x = torch.arange(8.0)

    def call():
        y = x * 2
        if PLANT["sync"]:
            y.sum().item()  # the planted sync
        if PLANT["f64"]:
            y = y.double()
        return y

    return harness.Program(call, (x,))


def _broken(h):
    raise RuntimeError("cannot build")


TOY = {"toy": {"prog": _toy}}


@pytest.fixture
def plant():
    PLANT.update(sync=False, f64=False)
    yield PLANT
    PLANT.update(sync=False, f64=False)


def _run(tmp_path, lines, entrypoints=TOY, **kw):
    return check.run_contracts(contracts_dir=tmp_path,
                               entrypoints=entrypoints, out=lines.append,
                               **kw)


def test_toy_clean_regression_explain_and_improvement(tmp_path, plant):
    lines = []
    assert _run(tmp_path, lines) == 1  # no contract file yet
    assert "no contract file" in lines[0]
    assert _run(tmp_path, lines, update=True) == 0
    assert json.loads((tmp_path / "toy.json").read_text())["programs"]
    lines.clear()
    assert _run(tmp_path, lines) == 0
    assert "0 regression(s)" in lines[-1]

    plant["sync"] = True
    lines.clear()
    assert _run(tmp_path, lines, explain=True) == 1
    text = "\n".join(lines)
    assert "REGRESSION toy/prog: transfers.syncs 0 -> 1" in text
    assert "op delta: _local_scalar_dense +1" in text
    assert "tests/test_torch_contracts.py:" in text
    assert "y.sum().item()  # the planted sync" in text

    plant.update(sync=False, f64=True)
    lines.clear()
    assert _run(tmp_path, lines, explain=True) == 1
    text = "\n".join(lines)
    assert "dtypes.f64 0 -> 1" in text and "forbidden" in text
    assert "_to_copy @ tests/test_torch_contracts.py:" in text

    # record the worse program, then remove the sync: an improvement
    plant.update(sync=True, f64=False)
    assert _run(tmp_path, lines, update=True) == 0
    plant["sync"] = False
    lines.clear()
    assert _run(tmp_path, lines) == 0
    assert any("IMPROVEMENT toy/prog: transfers.syncs 1 -> 0" in ln
               and "stale contract" in ln for ln in lines)


def test_toy_missing_and_new_programs(tmp_path, plant):
    lines = []
    assert _run(tmp_path, lines, update=True) == 0
    assert _run(tmp_path, lines, entrypoints={"toy": {
        "prog": _toy, "extra": _toy}}) == 1
    assert any("new entry point without a contract" in ln for ln in lines)
    assert _run(tmp_path, lines, entrypoints={"toy": {"other": _toy}}) == 1
    assert any("no longer recorded" in ln for ln in lines)


def test_toy_exit_2(tmp_path, plant):
    lines = []
    (tmp_path / "toy.json").write_text("{not json")
    assert _run(tmp_path, lines) == 2
    assert "bad contract" in lines[-1]
    assert _run(tmp_path, lines, entrypoints={"toy": {"p": _broken}}) == 2
    assert "harness unavailable: toy/p: RuntimeError('cannot build')" \
        in lines[-1]
    assert _run(tmp_path, lines, families=["nope"]) == 2


def test_cli_exit_codes_on_one_family(tmp_path, capsys):
    fam = ["--contracts", "--family", "parallel_fedavg", "--contracts-dir",
           str(tmp_path)]
    assert analysis_main(fam) == 1  # no contract recorded there yet
    assert analysis_main(fam[:-2] + ["--contracts-update",
                                     "--contracts-dir", str(tmp_path)]) == 0
    assert analysis_main(fam) == 0
    path = tmp_path / "parallel_fedavg.json"
    data = json.loads(path.read_text())
    data["programs"]["gather_leaves[f32]"]["collectives"]["all_gather"][
        "bytes"] = 32  # the recorded payload was 64 B: now it grew
    path.write_text(json.dumps(data))
    assert analysis_main(fam + ["--explain"]) == 1
    out = capsys.readouterr().out
    assert "collectives.all_gather.bytes 32 -> 64" in out
    assert "allgather_ @ fed_tgan_torch/parallel/multihost.py:" in out
    path.write_text("[]")
    assert analysis_main(fam) == 2
    assert analysis_main(fam + ["--backend", "tpu"]) == 2
    assert analysis_main(["--contracts", "--family", "nope"]) == 2


# ------------------------------------------------- the checked-in files

def _names(directory: Path, family: str) -> dict:
    return json.loads((directory / f"{family}.json").read_text())["programs"]


@pytest.mark.parametrize("family", FAMILIES)
def test_every_jax_program_has_a_port_program(family):
    port = _names(check.CONTRACTS_DIR, family)
    assert set(_names(JAX_CONTRACTS, family)) <= set(port)
    reqs = harness.PROGRAM_REQUIREMENTS.get(family, {})
    assert {n: p["require"] for n, p in port.items() if "require" in p} \
        == reqs
    assert set(port) == set(harness.ENTRYPOINT_FAMILIES[family])


@pytest.mark.parametrize("family", FAMILIES)
def test_card_contracts_call_the_kernels_as_the_cpu_does(family):
    cpu = _names(check.CONTRACTS_DIR, family)
    gpu = _names(contracts_dir_for("gpu"), family)
    assert set(gpu) == set(cpu)
    assert {n: p["kernels"] for n, p in gpu.items()} == \
        {n: p["kernels"] for n, p in cpu.items()}
    assert all(p["dtypes"].get("f64", 0) == 0 for p in gpu.values())


def test_contracts_dir_for():
    assert contracts_dir_for("cpu") == check.CONTRACTS_DIR
    assert contracts_dir_for("gpu") == check.CONTRACTS_DIR / "gpu"
    assert contracts_dir_for(None) == check.CONTRACTS_DIR / "gpu"
    with pytest.raises(BackendNotPortedError):
        contracts_dir_for("tpu")


def test_repo_gate_contracts():
    """``python -m fed_tgan_torch.analysis --contracts`` on the CPU, in a
    fresh interpreter with 2 threads: every program honours its
    contract."""
    proc = subprocess.run(
        [sys.executable, "-m", "fed_tgan_torch.analysis", "--contracts"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "42 program(s) across 6 family(ies): 0 regression(s), 0 " \
        "improvement(s)" in proc.stdout
