"""``BENCHMARK.json`` and the files it names: every cell, configuration,
traffic mix, metric reader and limit is there, and the cell files agree
with it."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_are_unique_and_valid():
    names = [c["name"] for c in SPEC["configs"]] + [
        w["name"] for w in SPEC["workloads"]] + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        got = [x["name"] for x in SPEC[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    cell = json.loads((ROOT / "benchmark" / "workloads"
                       / f"{w['name']}.json").read_text())
    assert (cell["config"], cell["traffic"], cell["why"]) == (
        w["config"], w["traffic"], w["why"])
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
    cfg = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    conf = json.loads((ROOT / cfg["file"]).read_text())
    assert conf["name"] == cfg["name"] and conf["reduced"] == cfg["reduced"]
    assert conf["precision"] == "f32" and conf["allow_tf32"] is False
    # every number the check compares has a limit
    numbers = {"loss_gap", "client_loss_gap", "moment_gap", "change_gap"}
    if w["traffic"] == "snapshot":
        numbers.add("snapshot_cells_pct")
    assert set(cell["limits"]) == numbers


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_flags_are_the_clis(w):
    """The configuration's and the traffic's flags parse with the CLI's
    own parser and state the configuration's numbers."""
    import sys

    sys.path.insert(0, str(ROOT))
    from benchmark.program import cli_args

    conf = json.loads((ROOT / "benchmark" / "configs"
                       / f"{w['config']}.json").read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    args = cli_args(conf, traffic, 2**31 + 5)
    assert args.mode == "fedavg" and args.seed == 2**31 + 5
    assert bool(args.sample_every) == (w["traffic"] == "snapshot")
    bad = dict(conf, flags=[*conf["flags"], "--n-clients",
                            str(conf["n_clients"] + 1)])
    with pytest.raises(ValueError, match="n_clients"):
        cli_args(bad, traffic, 1)


def test_metric_readers_and_moves():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
