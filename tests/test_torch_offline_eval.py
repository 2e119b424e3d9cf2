"""The port's offline evaluation against the JAX package's on the same
files.

- ``similarity_report`` and ``python -m fed_tgan_torch.eval.similarity``
  write CSVs byte-equal to ``fed_tgan_tpu.eval.similarity``'s: with
  ``--timing``, with snapshots sparser than the rounds, with an empty
  timing file (a note, no ``time_stamp``), with no categorical column
  (``Avg_JSD`` NaN, an empty cell), and with no snapshot at all (exit 2,
  the same message);
- a categorical column that is int in the real file and float in a
  snapshot (one missing cell) is compared as pandas compares it;
- ``scripts/torch_crosscheck_monitor.py`` prints the JAX script's JSON
  line on the same two CSVs, and its empty join ends as JAX's does;
- ``ml_utility`` and ``utility_difference`` equal JAX's (atol 0) on an
  Adult-shaped table of 400 rows, and so does the ``--json`` CLI;
- without sklearn the utility CLI exits 2 naming it.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from fed_tgan_torch.data.csvio import read_csv, write_csv
from fed_tgan_torch.datasets import PRESETS
from fed_tgan_torch.eval import similarity as port_sim
from fed_tgan_torch.eval import utility as port_util
from fed_tgan_torch.serve.demo import adult_like_table
from fed_tgan_tpu.eval import similarity as jax_sim
from fed_tgan_tpu.eval import utility as jax_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATEGORICAL = ["kind", "code"]


def _script(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(rng, n: int, shift: float) -> dict:
    return {
        "x": np.round(rng.normal(shift, 1.0, n), 4),
        "count": rng.integers(0, 50, n),
        "kind": rng.choice(["a", "b", "c"], n, p=[0.5, 0.3, 0.2]),
        "code": rng.integers(1, 4, n),
    }


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A real table and six rounds' snapshots (epochs 0-5), as a run
    writes them; snapshot 3's ``code`` column has a missing cell, so it
    reads as float there and as int in the real table.  ``num`` is the
    same run's numeric columns alone."""
    root = tmp_path_factory.mktemp("offline")
    rng = np.random.default_rng(3)
    for name in ("toy", "num"):
        (root / f"{name}_result").mkdir()
    numeric = ("x", "count")
    real = _table(rng, 200, 0.0)
    write_csv(real, str(root / "real.csv"))
    write_csv({c: real[c] for c in numeric}, str(root / "num_real.csv"))
    for e in range(6):
        t = _table(rng, 150, 0.1 * e)
        if e == 3:
            t["code"] = t["code"].astype(object)
            t["code"][7] = ""
        write_csv(t, str(root / "toy_result" / f"toy_synthesis_epoch_{e}.csv"))
        write_csv({c: t[c] for c in numeric},
                  str(root / "num_result" / f"num_synthesis_epoch_{e}.csv"))
    with open(root / "timing.csv", "w") as f:
        f.write("".join(f"{0.5 + 0.125 * e!r}\n" for e in range(6)))
    open(root / "empty.csv", "w").close()
    return root


def _sparse(run_dir, tmp_path):
    """Snapshots of epochs 0, 2 and 5 only (``--sample-every``)."""
    out = tmp_path / "sparse"
    out.mkdir()
    for e in (0, 2, 5):
        name = f"toy_synthesis_epoch_{e}.csv"
        (out / name).write_bytes((run_dir / "toy_result" / name).read_bytes())
    return out


@pytest.mark.parametrize("case", ["timing", "sparse", "empty_timing",
                                  "no_categorical"])
def test_report_cli_bytes_equal_jax(run_dir, tmp_path, capsys, case):
    name = "num" if case == "no_categorical" else "toy"
    result = (_sparse(run_dir, tmp_path) if case == "sparse"
              else run_dir / f"{name}_result")
    real = run_dir / ("num_real.csv" if name == "num" else "real.csv")
    args = ["--real", str(real), "--result-dir", str(result), "--name", name]
    if name == "toy":
        args += ["--categorical", *CATEGORICAL]
    if case in ("timing", "sparse"):
        args += ["--timing", str(run_dir / "timing.csv")]
    if case == "empty_timing":
        args += ["--timing", str(run_dir / "empty.csv")]
    assert jax_sim._main(args + ["-o", str(tmp_path / "jax.csv")]) == 0
    jax_out = capsys.readouterr().out
    assert port_sim._main(args + ["-o", str(tmp_path / "port.csv")]) == 0
    out = capsys.readouterr().out
    want = (tmp_path / "jax.csv").read_bytes()
    assert (tmp_path / "port.csv").read_bytes() == want
    header = want.split(b"\n", 1)[0]
    assert (b"time_stamp" in header) == (case in ("timing", "sparse"))
    note = "is empty; omitting time_stamp column"
    assert (note in out) == (note in jax_out) == (case == "empty_timing")
    if case == "no_categorical":
        assert b",," in want  # Avg_JSD NaN: an empty cell


def test_report_default_path_and_function(run_dir, capsys):
    """Without ``-o`` the report lands in the result directory;
    ``similarity_report`` itself (epoch times given) is JAX's frame."""
    result = run_dir / "toy_result"
    args = ["--real", str(run_dir / "real.csv"), "--result-dir", str(result),
            "--name", "toy", "--categorical", *CATEGORICAL]
    path = result / "toy_statistical_similarity_analysis.csv"
    assert jax_sim._main(args) == 0
    want = path.read_bytes()
    path.unlink()
    assert port_sim._main(args) == 0
    assert path.read_bytes() == want
    assert f"wrote {path}" in capsys.readouterr().out
    path.unlink()
    fakes = [str(result / f"toy_synthesis_epoch_{e}.csv") for e in (1, 3)]
    times = [0.25, 1.0 / 3.0]
    df = jax_sim.similarity_report(str(run_dir / "real.csv"), fakes,
                                   CATEGORICAL, times)
    report = port_sim.similarity_report(str(run_dir / "real.csv"), fakes,
                                        CATEGORICAL, times)
    assert port_sim.report_csv_bytes(report) == df.to_csv(
        index=False).encode()


def test_int_in_real_float_in_snapshot_compares_as_pandas(run_dir):
    """``code`` reads as int in the real table and as float in snapshot
    3: the categories compare as ``"1"`` against ``"1.0"``, so no real
    category has fake mass and the column's JSD is NaN, in both packages
    (and the snapshot's Avg_JSD with it)."""
    real = str(run_dir / "real.csv")
    fake = str(run_dir / "toy_result" / "toy_synthesis_epoch_3.csv")
    assert read_csv(real)["code"].dtype == np.int64
    assert read_csv(fake)["code"].dtype == np.float64
    _, _, per = port_sim.statistical_similarity(
        read_csv(real), read_csv(fake), CATEGORICAL)
    _, _, jper = jax_sim.statistical_similarity(
        pd.read_csv(real), pd.read_csv(fake), CATEGORICAL)
    assert list(per) == list(jper)
    np.testing.assert_array_equal(list(per.values()), list(jper.values()))
    assert np.isnan(per["code"]) and not np.isnan(per["kind"])


@pytest.fixture(scope="module")
def module_clis(adult, tmp_path_factory):
    """Both module CLIs run as ``python -m`` would run them, in one fresh
    interpreter where sklearn cannot be imported: the similarity report
    over a directory with no snapshot, then the utility CLI.  Returns
    ``{name: (exit code, stdout, stderr)}``."""
    paths, target, _ = adult
    empty = str(tmp_path_factory.mktemp("empty"))
    runs = {"similarity": ["--real", "r.csv", "--result-dir", empty,
                           "--name", "toy"],
            "utility": ["--real-train", paths["train"], "--real-test",
                        paths["test"], "--synthetic", paths["synthetic"],
                        "--target", target]}
    code = ("import contextlib, io, json, runpy, sys, warnings\n"
            "warnings.simplefilter('always')\n"
            "sys.modules['sklearn'] = None\n"
            "res = {}\n"
            f"for name, argv in {runs!r}.items():\n"
            "    out, err = io.StringIO(), io.StringIO()\n"
            "    sys.argv = [name] + argv\n"
            "    with contextlib.redirect_stdout(out), "
            "contextlib.redirect_stderr(err), "
            "warnings.catch_warnings(record=True) as caught:\n"
            "        try:\n"
            "            runpy.run_module(f'fed_tgan_torch.eval.{name}', "
            "run_name='__main__')\n"
            "            rc = 0\n"
            "        except SystemExit as exc:\n"
            "            rc = exc.code\n"
            "    res[name] = (rc, out.getvalue(), err.getvalue() + ''.join("
            "f'{w.category.__name__}: {w.message}' for w in caught))\n"
            "print(json.dumps(res))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return empty, runs, json.loads(proc.stdout.strip().splitlines()[-1])


def test_no_snapshots_exits_2_through_python_m(module_clis):
    """``python -m fed_tgan_torch.eval.similarity`` with no snapshot:
    exit 2, JAX's message, and no runpy warning (the package's exports
    are lazy)."""
    empty, runs, res = module_clis
    rc, out, err = res["similarity"]
    assert rc == 2
    assert out == f"no toy_synthesis_epoch_*.csv under {empty}\n"
    assert "RuntimeWarning" not in err
    assert jax_sim._main(runs["similarity"]) == 2


def test_crosscheck_matches_jax(run_dir, tmp_path, capsys):
    """The port's cross-check script prints the JAX script's JSON line on
    the same monitor log and report; an empty join exits with JAX's
    message."""
    result = run_dir / "toy_result"
    report = tmp_path / "report.csv"
    assert port_sim._main(["--real", str(run_dir / "real.csv"),
                           "--result-dir", str(result), "--name", "toy",
                           "--categorical", *CATEGORICAL,
                           "-o", str(report)]) == 0
    capsys.readouterr()
    monitor = tmp_path / "monitor_similarity.csv"
    rng = np.random.default_rng(5)
    rows = [f"{e},{rng.uniform(0.1, 0.3)!r},{rng.uniform(0.02, 0.1)!r}"
            for e in (0, 2, 3, 4, 6)]
    monitor.write_text("Epoch_No.,Avg_JSD,Avg_WD\n" + "\n".join(rows) + "\n")
    port = _script(os.path.join(REPO, "scripts",
                                "torch_crosscheck_monitor.py"), "port_xc")
    jax = _script(os.path.join(REPO, "scripts", "crosscheck_monitor.py"),
                  "jax_xc")
    got = port.crosscheck(str(monitor), str(report))
    assert got == jax.crosscheck(str(monitor), str(report))
    # round 3's offline Avg_JSD is NaN: skipped, as pandas skips it
    assert got["rounds_compared"] == 4 and got["final_round"] == 4
    assert port.main(["--monitor-csv", str(monitor), "--similarity-csv",
                      str(report)]) == 0
    assert json.loads(capsys.readouterr().out) == got
    monitor.write_text("Epoch_No.,Avg_JSD,Avg_WD\n9,0.1,0.1\n")
    with pytest.raises(SystemExit) as ours:
        port.crosscheck(str(monitor), str(report))
    with pytest.raises(SystemExit) as theirs:
        jax.crosscheck(str(monitor), str(report))
    assert str(ours.value) == str(theirs.value)


@pytest.fixture(scope="module")
def adult(tmp_path_factory):
    """Adult-shaped train (250 rows) and test (150) CSVs, and a
    "synthetic" table: the train rows with every column permuted on its
    own (each value in the real vocabulary, the joint broken)."""
    root = tmp_path_factory.mktemp("adult")
    table = adult_like_table(400, 11)
    rng = np.random.default_rng(0)
    train = {c: v[:250] for c, v in table.items()}
    parts = {"train": train, "test": {c: v[250:] for c, v in table.items()},
             "synthetic": {c: v[rng.permutation(250)]
                           for c, v in train.items()}}
    paths = {}
    for name, t in parts.items():
        paths[name] = str(root / f"{name}.csv")
        write_csv(t, paths[name])
    preset = PRESETS["adult"]
    return paths, preset.target_column, list(preset.categorical_columns)


def test_ml_utility_equals_jax(adult):
    paths, target, cat = adult
    train, test, fake = (read_csv(paths[k])
                         for k in ("train", "test", "synthetic"))
    jtrain, jtest, jfake = (pd.read_csv(paths[k])
                            for k in ("train", "test", "synthetic"))
    got = port_util.ml_utility(port_util._concat(train, test), fake, test,
                               target, cat)
    want = jax_util.ml_utility(pd.concat([jtrain, jtest]), jfake, jtest,
                               target, cat)
    assert got == want
    assert len(got) == len(port_util.MODELS) and all(
        0.0 <= v <= 1.0 for row in got for v in row)


def test_utility_cli_json_equals_jax(adult, capsys):
    """``--json`` of both CLIs on the same CSVs (the synthetic table's
    columns in another order: the CLI orders them as the train table's),
    each ``utility_difference`` of the three tables."""
    paths, target, cat = adult
    fake = read_csv(paths["synthetic"])
    shuffled = os.path.join(os.path.dirname(paths["synthetic"]),
                            "synthetic_shuffled.csv")
    write_csv({c: fake[c] for c in reversed(list(fake))}, shuffled)
    args = ["--real-train", paths["train"], "--real-test", paths["test"],
            "--synthetic", shuffled, "--target", target, "--categorical",
            *cat, "--json"]
    assert jax_util._main(args) == 0
    want = capsys.readouterr().out
    assert port_util._main(args) == 0
    assert capsys.readouterr().out == want
    res = json.loads(want)
    assert res["delta_f1"] == float(np.mean(res["difference"], axis=0)[1])


def test_utility_cli_without_sklearn_exits_2(module_clis):
    rc, out, err = module_clis[2]["utility"]
    assert rc == 2, err
    assert "needs sklearn" in err and out == ""
    assert "Traceback" not in err
