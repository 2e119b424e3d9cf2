"""The port's training CLI against ``fed_tgan_tpu.cli`` with the same argv
on the same raw Intrusion-shaped CSV (600 rows, 3 clients).

- ``--mode fedavg``, 2 rounds: the same snapshot file names, header and
  row counts, the same harmonized meta, and final Avg_JSD / Avg_WD within
  0.05 of the JAX run's (the two packages draw different random streams,
  so only the distribution of the result is shared);
- ``--mode standalone``: the same meta and encoders;
- a flag of a feature not ported yet exits with code 2.
"""

import csv
import json
import pickle
import re

import numpy as np
import pytest
import torch

from fed_tgan_torch import cli as port_cli
from fed_tgan_torch.serve.demo import write_intrusion_csv
from fed_tgan_tpu import cli as jax_cli

torch.set_num_threads(1)
METRIC_TOL = 0.05


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_intrusion_csv(
        str(tmp_path_factory.mktemp("data") / "intr.csv"), 600, 0)


def argv(data, out, *extra):
    return ["--datapath", data, "--dataset", "intrusion", "--n-clients", "3",
            "-epochs", "2", "--sample-every", "1", "--sample-rows", "120",
            "--batch-size", "50", "--embedding-dim", "16", "--eval",
            "--out-dir", str(out), "--seed", "1", *extra]


def final_metrics(text):
    m = re.search(r"final Avg_JSD=([\d.]+) Avg_WD=([\d.]+)", text)
    return float(m.group(1)), float(m.group(2))


def snapshot_shapes(out):
    res = out / "Intrusion_result"
    shapes = {}
    for p in sorted(res.iterdir()):
        rows = list(csv.reader(open(p)))
        shapes[p.name] = (tuple(rows[0]), len(rows) - 1)
    return shapes


def test_fedavg_cli_matches_jax(data, tmp_path, capsys):
    assert jax_cli.main(argv(data, tmp_path / "jax")) == 0
    jout = capsys.readouterr().out
    assert port_cli.main(argv(data, tmp_path / "port", "--device", "cpu",
                              "--save-model")) == 0
    out = capsys.readouterr().out
    assert snapshot_shapes(tmp_path / "port") == snapshot_shapes(
        tmp_path / "jax")
    assert list(snapshot_shapes(tmp_path / "port")) == [
        "Intrusion_synthesis_epoch_0.csv", "Intrusion_synthesis_epoch_1.csv"]
    models, jmodels = tmp_path / "port" / "models", tmp_path / "jax" / "models"
    assert (json.load(open(models / "Intrusion.json"))
            == json.load(open(jmodels / "Intrusion.json")))
    assert (models / "synthesizer_torch" / "weights.npz").exists()
    np.testing.assert_allclose(final_metrics(out), final_metrics(jout),
                               atol=METRIC_TOL)
    for name in ("timestamp_experiment.csv", "timing_phases.csv"):
        assert (open(tmp_path / "port" / name).read().count("\n")
                == open(tmp_path / "jax" / name).read().count("\n"))


def test_standalone_cli_matches_jax(data, tmp_path, capsys):
    extra = ["--mode", "standalone", "--save-model", "-epochs", "1"]
    assert jax_cli.main(argv(data, tmp_path / "jax", *extra)) == 0
    assert port_cli.main(argv(data, tmp_path / "port", *extra,
                              "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert "final Avg_JSD=" in out
    models, jmodels = tmp_path / "port" / "models", tmp_path / "jax" / "models"
    assert (json.load(open(models / "Intrusion.json"))
            == json.load(open(jmodels / "Intrusion.json")))
    with open(jmodels / "label_encoders_Intrusion.pickle", "rb") as f:
        jenc = pickle.load(f)
    enc = json.load(open(models / "label_encoders_Intrusion.json"))
    assert [(e["column_name"], e["classes"]) for e in enc] == [
        (e["column_name"], e["label_encoder"].classes_.tolist())
        for e in jenc]
    rows = list(csv.reader(open(
        tmp_path / "port" / "Intrusion_result"
        / "Intrusion_synthesis_standalone.csv")))
    assert len(rows) == 121 and len(rows[0]) == 42


@pytest.mark.parametrize("flag,item", [
    (["--cohort", "2"], "A.17"), (["--rounds-per-program", "4"], "A.17"),
    (["--faults", "nan_update:rank=1"], "A.14"),
    (["--elastic-capacity", "8"], "A.16"), (["--precision", "bf16"], "A.15"),
    (["--mode", "mdgan"], "A.17"), (["--monitor-every", "1"], "A.11")])
def test_unported_flags_exit_2(data, tmp_path, capsys, flag, item):
    assert port_cli.main(argv(data, tmp_path, "--device", "cpu", *flag)) == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


def test_batch_size_must_be_a_multiple_of_pac(data, tmp_path):
    with pytest.raises(SystemExit):
        port_cli.main(argv(data, tmp_path, "--batch-size", "55"))
