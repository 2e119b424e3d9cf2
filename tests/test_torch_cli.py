"""The port's training CLI against ``fed_tgan_tpu.cli`` with the same argv
on the same raw Intrusion-shaped CSV (600 rows, 3 clients).

- ``--mode fedavg``, 2 rounds: the same snapshot file names, header and
  row counts, the same harmonized meta, and final Avg_JSD / Avg_WD within
  0.05 of the JAX run's (the two packages draw different random streams,
  so only the distribution of the result is shared);
- ``--mode standalone``: the same meta and encoders;
- ``--monitor-every``/``--save-every`` then ``--resume``: the run goes on
  from its checkpoint and extends the monitor CSV;
- the reference's drop-in flags ``-E_interval`` and ``-report`` are
  accepted and ignored, ``-date_dic``, ``-rank``, ``-world_size`` and
  ``-port`` accepted with JAX's single-process meaning (``-rank 0
  -world_size 3`` trains 2 clients with JAX's weights);
- ``--similarity sketch --init-cache`` restores a warm init, and
  ``--elastic-capacity`` runs join/leave/drift faults;
- ``--precision bf16`` trains, checkpoints and resumes in bf16;
- the flags of the last ported features run: ``--snapshot-format
  parquet`` (``.parquet`` snapshots holding the plain run's values) and
  ``--bgm-backend sklearn`` (finite snapshots); ``--journal``,
  ``--obs-port``, ``--profile-dir`` and ``--profile-rounds`` run, and so
  do ``--sanitize`` and ``--sanitize-nans`` (the plain run's bytes) and
  ``serve``'s and ``fleet``'s ``--sanitize`` and ``fleet --lockwatch``;
- the multi-process launch (``-ip``): ``--init-only``, ``--params-out``,
  the transport fault kinds and the ``fed_tgan_torch.distributed`` alias
  run a world of rank 0 and 2 participants (``launch_world`` of
  ``tests/test_torch_world.py``).
"""

import csv
import json
import os
import pickle
import re
import urllib.request

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


ONE_ROUND = ("-epochs", "1")


@pytest.fixture(scope="module")
def plain_run(data, tmp_path_factory):
    """The fedavg CLI's snapshots without any flag of the cases below."""
    out = tmp_path_factory.mktemp("plain")
    assert port_cli.main(argv(data, out, "--device", "cpu", *ONE_ROUND)) == 0
    result = out / "Intrusion_result"
    return {p.name: p.read_bytes() for p in result.iterdir()}


@pytest.mark.parametrize("flag,item", [
    pytest.param(["--snapshot-format", "parquet"], "A.21", id="flag0-A.21"),
    pytest.param(["--sanitize-nans"], "A.20", id="flag1-A.20"),
    pytest.param(["--sanitize"], "A.20", id="flag2-A.20"),
    pytest.param(["--bgm-backend", "sklearn"], "A.24", id="flag6-A.24")])
def test_unported_flags_exit_2(data, tmp_path, capsys, plain_run, flag,
                               item):
    """The flags that exited 2 naming their ROADMAP item until it was
    ported now run.  A.20's (``--sanitize``, ``--sanitize-nans``): the run
    exits 0 with the sanitizers' report (builds, syncs) and its snapshots
    are the plain run's bytes.  A.21's ``--snapshot-format parquet``: the
    snapshots are ``.parquet`` files holding the plain run's CSV cells
    (the same training, the same draws).  A.24's ``--bgm-backend
    sklearn``: the run exits 0 with finite snapshots."""
    rc = port_cli.main(argv(data, tmp_path, "--device", "cpu", *ONE_ROUND,
                            *flag))
    out = capsys.readouterr()
    assert rc == 0, out.err
    assert "ROADMAP" not in out.err
    result = tmp_path / "Intrusion_result"
    if item == "A.21":
        import pyarrow.parquet as pq

        assert sorted(p.name for p in result.iterdir()) == [
            n.replace(".csv", ".parquet") for n in sorted(plain_run)]
        for name, blob in plain_run.items():
            rows = list(csv.reader(blob.decode().splitlines()))
            table = pq.read_table(str(result / name.replace(
                ".csv", ".parquet"))).to_pydict()
            assert list(table) == rows[0]
            for j, column in enumerate(rows[0]):
                assert [" " if v is None else repr(v) if isinstance(
                    v, float) else str(v) for v in table[column]] == [
                        r[j] for r in rows[1:]], column
        return
    if item == "A.24":
        from fed_tgan_torch.data.csvio import read_csv

        shapes = snapshot_shapes(tmp_path)
        assert list(shapes) == list(plain_run)
        for name in shapes:
            cells = read_csv(str(result / name))
            for column in ("duration", "src_bytes", "dst_bytes"):
                assert np.isfinite(cells[column]).all(), column
        return
    assert "sanitize: " in out.out and "synchronizing call(s)" in out.out
    assert "SANITIZE:" not in out.out
    result = tmp_path / "Intrusion_result"
    assert {p.name: p.read_bytes() for p in result.iterdir()} == plain_run


def test_observability_flags_run(data, tmp_path, capsys):
    """``--journal``, ``--obs-port``, ``--profile-dir`` and
    ``--profile-rounds`` (refused with exit 2 until ROADMAP A.20's first
    part) run: the journal holds the rounds and the contributions, the
    exporter's URL is printed, the last round is traced into the profile
    directory (``device_trace`` ok) and the run ends as it would without
    them."""
    from fed_tgan_torch.obs import read_journal

    jpath = tmp_path / "j" / "run.jsonl"
    prof = tmp_path / "prof"
    assert port_cli.main(argv(data, tmp_path, "--device", "cpu",
                              "--journal", str(jpath), "--obs-port", "0",
                              "--profile-dir", str(prof),
                              "--profile-rounds", "1")) == 0
    out = capsys.readouterr().out
    assert "obs: live telemetry on http://127.0.0.1:" in out
    assert "final Avg_JSD=" in out and "2 rounds in" in out
    types = [e["type"] for e in read_journal(str(jpath))]
    assert types.count("round") == types.count("client_contribution") == 2
    traces = [e for e in read_journal(str(jpath))
              if e["type"] == "device_trace"]
    assert [e["ok"] for e in traces] == [True]
    assert len(os.listdir(prof)) == 1
    assert len(os.listdir(tmp_path / "Intrusion_result")) == 2


def _shards(data, tmp_path, n=2):
    from fed_tgan_torch.data.csvio import read_csv, write_csv
    from fed_tgan_torch.data.sharding import shard_table

    paths = []
    for i, part in enumerate(shard_table(read_csv(data), n, "iid", seed=1)):
        paths.append(str(tmp_path / f"shard{i + 1}.csv"))
        write_csv(part, paths[-1])
    return paths


def _world_argv(out, *extra):
    return ["--dataset", "intrusion", "-epochs", "1", "--sample-rows", "60",
            "--batch-size", "50", "--embedding-dim", "16", "--device", "cpu",
            "--seed", "1", "--out-dir", str(out), *extra]


@pytest.mark.parametrize("case", ["init_only", "params_out", "rank0_alone",
                                  "parquet"])
def test_multihost_launch_flags_run(data, tmp_path, capsys, case):
    """The flags the multi-process launch took from ROADMAP A.18 (until
    then refused with exit 2): ``--init-only`` stops a world of rank 0
    and 2 participants after the init protocol (meta and encoders
    written, no snapshot); ``--params-out`` writes each participant's
    final generator; ``-ip -rank 0`` without ``-world_size`` exits 2 with
    JAX's line.  A.21's ``--snapshot-format parquet``: rank 0 writes the
    round's snapshot as parquet (the layout's columns, the requested
    rows, finite numbers)."""
    from test_torch_world import launch_world

    if case == "rank0_alone":
        assert port_cli.main(argv(data, tmp_path, "--device", "cpu", "-ip",
                                  "1.2.3.4", "-rank", "0")) == 2
        assert ("multihost rank 0 needs -world_size"
                in capsys.readouterr().out)
        return
    out = tmp_path / "out"
    extra = {"init_only": ["--init-only"],
             "parquet": ["--snapshot-format", "parquet"]}.get(
                 case, ["--params-out", str(out / "params")])
    res = launch_world(str(tmp_path), _world_argv(out, *extra),
                       _shards(data, tmp_path))
    assert [rc for rc, _, _ in res] == [0, 0, 0], res
    assert "multihost init complete: 2 clients" in res[0][1]
    assert (out / "models" / "Intrusion.json").is_file()
    assert (out / "models" / "label_encoders_Intrusion.json").is_file()
    if case == "parquet":
        import pyarrow.parquet as pq

        from fed_tgan_torch.datasets import INTRUSION_SELECTED

        result = out / "Intrusion_result"
        assert os.listdir(result) == ["Intrusion_synthesis_epoch_0.parquet"]
        table = pq.read_table(str(result / os.listdir(result)[0]))
        assert table.column_names == list(INTRUSION_SELECTED)
        assert table.num_rows == 60
        for name in ("duration", "src_bytes"):
            assert np.isfinite(table.column(name).to_numpy()).all()
    elif case == "init_only":
        assert not (out / "Intrusion_result").exists()
        assert all("init complete" in r[1] and "training complete" not in
                   r[1] for r in res[1:])
    else:
        params = [torch.load(out / "params" / f"params_rank{r}.pt")
                  for r in (1, 2)]
        assert params[0]["ema"] is None
        assert all(torch.equal(params[0]["generator"][k],
                               params[1]["generator"][k])
                   for k in params[0]["generator"])
        assert (out / "Intrusion_result"
                / "Intrusion_synthesis_epoch_0.csv").is_file()


def test_distributed_alias_takes_the_reference_flags(data, tmp_path):
    """``python -m fed_tgan_torch.distributed`` is the CLI under the
    reference's module name: a world launched through it with the
    reference's flags (``-rank``, ``-ip``, ``-port``, ``-world_size``,
    ``-epochs``, ``-datapath``) runs its init."""
    import subprocess
    import sys

    from test_torch_world import world_env, next_port

    shards = _shards(data, tmp_path)
    port = str(next_port())
    env = world_env()
    base = [sys.executable, "-m", "fed_tgan_torch.distributed", "-ip",
            "127.0.0.1", "-port", port, "-epochs", "1", "--init-only",
            "--device", "cpu", "--out-dir", str(tmp_path / "out")]
    procs = [subprocess.Popen(base + ["-rank", "0", "-world_size", "3"],
                              env=env, stdout=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(base + ["-rank", str(r), "-datapath",
                                       shards[r - 1]], env=env,
                               stdout=subprocess.PIPE, text=True)
              for r in (1, 2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert "multihost init complete: 2 clients" in outs[0]


def test_precision_bf16_runs_a_round_and_resumes_in_it(data, tmp_path,
                                                       capsys):
    """``--precision bf16`` (refused until the precision slice) trains a
    bf16 federation to exit 0, its checkpoint and artifact carry the
    precision, and a resume keeps the checkpoint's precision whatever the
    flag says, as the JAX CLI does."""
    out = tmp_path / "out"
    common = ["--device", "cpu", "--save-every", "1", "--save-model"]
    assert port_cli.main(argv(data, out, "--precision", "bf16",
                              *common)) == 0
    assert "final Avg_JSD=" in capsys.readouterr().out
    host = json.load(open(out / "checkpoint" / "host.json"))
    assert host["cfg"]["precision"] == "bf16"
    art = json.load(open(out / "models" / "synthesizer_torch"
                         / "config.json"))
    assert art["cfg"]["precision"] == "bf16"
    resumed = [a if a != "2" or prev != "-epochs" else "3"
               for prev, a in zip([None] + argv(data, out), argv(data, out))]
    assert port_cli.main(resumed + common + ["--resume"]) == 0
    assert "at round 2" in capsys.readouterr().out
    host = json.load(open(out / "checkpoint" / "host.json"))
    assert host["cfg"]["precision"] == "bf16"
    assert host["completed_epochs"] == 3


def test_reference_drop_in_flags_are_accepted(data, tmp_path, capsys):
    """``-E_interval`` and ``-report`` are accepted and ignored, as the
    reference and the JAX CLI do; so are the reference's single-dash
    ``-date_dic``, ``-rank 0`` and ``-port`` without ``-ip`` (one
    process), and JAX's ``--backend cpu`` (``--device cpu``) and
    ``--n-virtual-devices``."""
    assert port_cli.main(argv(data, tmp_path, "-epochs", "1", "-E_interval",
                              "5", "-report", "-date_dic", "-rank", "0",
                              "-port", "5", "--backend", "cpu",
                              "--n-virtual-devices", "2")) == 0
    assert "final Avg_JSD=" in capsys.readouterr().out


def test_rank0_world_size3_trains_two_clients_as_jax(data, tmp_path, capsys):
    """``-rank 0 -world_size 3`` without ``-ip`` trains ``W - 1 = 2``
    clients in one process, with the JAX CLI's aggregation weights on the
    same CSV (printed to 4 decimals; the two fits agree within 1e-3); a
    rank other than 0 has nothing to start and exits 0."""
    common = ["--datapath", data, "--dataset", "intrusion", "-rank", "0",
              "-world_size", "3", "-epochs", "1", "--sample-rows", "60",
              "--batch-size", "50", "--embedding-dim", "16", "--seed", "1"]
    pat = re.compile(r"(\d+) clients, rows per shard.*?aggregation weights: "
                     r"(\[[^\]]*\])", re.S)

    def clients_and_weights(text):
        m = pat.search(text)
        return int(m.group(1)), np.asarray(json.loads(m.group(2)))

    assert jax_cli.main(common + ["--out-dir", str(tmp_path / "jax"),
                                  "--backend", "cpu"]) == 0
    jn, jw = clients_and_weights(capsys.readouterr().out)
    assert port_cli.main(common + ["--out-dir", str(tmp_path / "port"),
                                   "--device", "cpu"]) == 0
    n, w = clients_and_weights(capsys.readouterr().out)
    assert n == jn == 2
    np.testing.assert_allclose(w, jw, atol=1e-3)
    assert port_cli.main(common[:4] + ["-rank", "1"]) == 0
    assert "rank 1 has no separate process" in capsys.readouterr().out
    assert port_cli.main(common + ["--backend", "tpu"]) == 2
    assert "--backend tpu" in capsys.readouterr().err


def test_sketch_with_init_cache_runs_and_restores(data, tmp_path, capsys):
    """``--similarity sketch --init-cache DIR`` exits 0; a second run
    restores the init from the cache and writes the same snapshot bytes."""
    cache = str(tmp_path / "cache")
    snaps = []
    for run in ("cold", "warm"):
        out = tmp_path / run
        assert port_cli.main(argv(data, out, "--device", "cpu", "-epochs",
                                  "1", "--similarity", "sketch",
                                  "--init-cache", cache)) == 0
        text = capsys.readouterr().out
        assert "final Avg_JSD=" in text
        assert ("cache_restore" in text) == (run == "warm")
        snaps.append(open(out / "Intrusion_result"
                          / "Intrusion_synthesis_epoch_0.csv", "rb").read())
    assert snaps[0] == snaps[1]


CHURN = ("join:round=2,count=2;leave:client=1,round=2;"
         "drift:client=0,round=2,shift=2.0")


def test_elastic_churn_runs_and_refuses_a_resume(data, tmp_path, capsys):
    """``--elastic-capacity 8`` with join/leave/drift faults exits 0: the
    population grows 3 -> 5 and client 1 leaves (the checkpoint says so);
    resuming with a churn plan exits 2, as JAX's CLI does."""
    from fed_tgan_torch.testing.faults import ENV_VAR, install_plan

    out = tmp_path / "out"
    extra = ["--device", "cpu", "-epochs", "3", "--elastic-capacity", "8",
             "--drift-every", "1", "--save-every", "1", "--watchdog"]
    try:  # the CLI installs its plan process-wide, and exports it
        assert port_cli.main(argv(data, out, *extra, "--faults", CHURN)) == 0
        text = capsys.readouterr().out
        assert "final Avg_JSD=" in text and "3 rounds in" in text
        host = json.load(open(out / "checkpoint" / "host.json"))
        assert host["capacity"] == 8 and host["dropped_clients"] == [1]
        assert len(host["init"]["rows_per_client"]) == 5
        assert port_cli.main(argv(data, out, *extra, "--resume",
                                  "--faults", CHURN)) == 2
        assert "cannot drive a resumed run" in capsys.readouterr().err
    finally:
        install_plan(None)
        os.environ.pop(ENV_VAR, None)


@pytest.mark.parametrize("spec", [
    "delay_msg:ms=5", "sever_conn:rank=1,after=1",
    "kill_client:rank=1,round=1;delay_msg:ms=5"])
def test_transport_fault_kinds_run(data, tmp_path, capsys, spec):
    """The fault kinds ROADMAP A.18 ported (until then refused with exit
    2): ``delay_msg`` and ``sever_conn`` act on the transport of a world
    run through the init protocol (the severed rank 1 reconnects and the
    world exits 0); with ``kill_client`` the plan drives the in-process
    trainer, which drops the client, and the delay rides along."""
    from fed_tgan_torch.testing.faults import ENV_VAR, install_plan
    from test_torch_world import launch_world

    if spec.startswith("kill_client"):
        try:
            assert port_cli.main(argv(data, tmp_path, "--device", "cpu",
                                      "--faults", spec)) == 0
        finally:
            install_plan(None)
            os.environ.pop(ENV_VAR, None)
        assert (tmp_path / "Intrusion_result").is_dir()
        return
    out = tmp_path / "out"
    res = launch_world(str(tmp_path), _world_argv(out, "--init-only",
                                                  "--faults", spec),
                       _shards(data, tmp_path))
    assert [rc for rc, _, _ in res] == [0, 0, 0], res
    if spec.startswith("sever_conn"):
        assert "rank 1 reconnected and resynced" in res[1][2]


def test_save_every_then_resume_extends_the_monitor_csv(data, tmp_path,
                                                        capsys):
    out = tmp_path / "out"
    common = ["--device", "cpu", "--monitor-every", "1", "--save-every",
              "1", "--ckpt-keep", "2", "--watchdog"]
    assert port_cli.main(argv(data, out, *common)) == 0
    first = capsys.readouterr().out
    assert "on-device monitor" in first and "note:" not in first
    rows = list(csv.reader(open(out / "monitor_similarity.csv")))
    assert rows[0] == ["Epoch_No.", "Avg_JSD", "Avg_WD"]
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    assert (out / "checkpoint").is_dir() and (out / "checkpoint.1").is_dir()
    resumed = [a if a != "2" or prev != "-epochs" else "4"
               for prev, a in zip([None] + argv(data, out), argv(data, out))]
    assert port_cli.main(resumed + common + ["--resume"]) == 0
    text = capsys.readouterr().out
    assert "resumed from" in text and "at round 2" in text
    assert "final Avg_JSD=" in text
    rows = list(csv.reader(open(out / "monitor_similarity.csv")))
    assert [r[0] for r in rows[1:]] == ["0", "1", "2", "3"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])
    assert sorted(p.name for p in (out / "Intrusion_result").iterdir()) == [
        f"Intrusion_synthesis_epoch_{e}.csv" for e in range(4)]
    assert open(out / "timestamp_experiment.csv").read().count("\n") == 4


def test_watchdog_without_save_every_notes_it(data, tmp_path, capsys):
    assert port_cli.main(argv(data, tmp_path, "--device", "cpu",
                              "--watchdog")) == 0
    assert ("note: --watchdog without --save-every has no checkpoint to "
            "roll back to; an alarm aborts cleanly") in capsys.readouterr().out


def test_batch_size_must_be_a_multiple_of_pac(data, tmp_path):
    with pytest.raises(SystemExit):
        port_cli.main(argv(data, tmp_path, "--batch-size", "55"))


@pytest.mark.parametrize("command,flag,item", [
    pytest.param("serve", ["--sanitize"], "A.20", id="serve-flag0-A.20"),
    pytest.param("fleet", ["--sanitize"], "A.20", id="fleet-flag1-A.20"),
    pytest.param("fleet", ["--lockwatch"], "A.20", id="fleet-flag2-A.20")])
def test_unported_serving_flags_exit_2(tmp_path, capsys, monkeypatch,
                                       command, flag, item):
    """``serve --sanitize``, ``fleet --sanitize`` and ``fleet --lockwatch``
    (refused with exit 2 until ROADMAP A.20's second part) run: requests
    over two chunk sizes are answered with the bytes of an engine built
    without the flag, and after the drain the report follows (builds and
    syncs and the budget for ``--sanitize``, each lock's hold p99 for
    ``--lockwatch``) with exit 0."""
    from fed_tgan_torch.__main__ import main
    from fed_tgan_torch.serve import fleet, service
    from fed_tgan_torch.serve.demo import build_random_artifact
    from fed_tgan_torch.serve.engine import SamplingEngine
    from fed_tgan_torch.serve.registry import open_model
    from fed_tgan_torch.train.steps import TrainConfig

    cfg = TrainConfig(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),
                      batch_size=40, pac=4)
    art = build_random_artifact(str(tmp_path / "art"), seed=4, cfg=cfg)
    got = {}

    def serve_then_drain(name, svc):
        base = (f"{svc.url}/sample" if command == "serve"
                else f"{svc.url}/t/a/sample")
        for rows in (40, 120, 120):
            with urllib.request.urlopen(f"{base}?rows={rows}&seed=5",
                                        timeout=60) as r:
                got[rows] = r.read()
        svc.shutdown(drain=True)

    monkeypatch.setattr(service, "wait_for_interrupt", serve_then_drain)
    monkeypatch.setattr(fleet, "wait_for_interrupt", serve_then_drain)
    target = art if command == "serve" else f"a={art}"
    assert main([command, target, "--device", "cpu", "--port", "0",
                 "--quiet", *flag]) == 0
    out = capsys.readouterr().out
    engine = SamplingEngine(open_model(art, device="cpu"))
    assert got == {rows: engine.sample_csv_bytes(rows, seed=5)
                   for rows in (40, 120)}
    assert "SANITIZE:" not in out and "LOCKWATCH:" not in out
    if flag == ["--sanitize"]:
        assert "sanitize: " in out and "synchronizing call(s)" in out
    else:
        assert "lockwatch: fleet_adm:" in out and "hold p99" in out
    assert not torch.are_deterministic_algorithms_enabled()


def test_serving_commands_take_the_jax_flags_and_defaults():
    """``serve`` and ``fleet`` take the JAX commands' flags with their
    defaults (``fed_tgan_tpu/serve/service.py:479-520``,
    ``serve/fleet.py:1218-1300``), plus ``--device``."""
    import argparse

    from fed_tgan_torch.serve import fleet, service

    def defaults(main_fn):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, args=None, namespace=None):
            ns = real(self, args, namespace)
            seen.update(vars(ns))
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main_fn(["x=y"] if main_fn is fleet.fleet_main else ["x"])
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen

    serve = defaults(service.serve_main)
    assert {k: serve[k] for k in (
        "max_batch", "queue_size", "workers", "coalesce_window",
        "request_timeout", "reload_interval", "promote", "quiet", "device",
        "port")} == {
        "max_batch": 8, "queue_size": 64, "workers": 1,
        "coalesce_window": 0.0, "request_timeout": 120.0,
        "reload_interval": 5.0, "promote": "immediate", "quiet": False,
        "device": "cuda", "port": 7799}
    fl = defaults(fleet.fleet_main)
    assert {k: fl[k] for k in (
        "max_batch", "queue_size", "max_lanes", "queue_share", "quota_rps",
        "quota_burst", "cache_entries", "cache_mb", "workers",
        "coalesce_window", "http", "row_pool_chunks", "row_pool_chunk_rows",
        "request_timeout", "reload_interval", "promote", "lockwatch",
        "device")} == {
        "max_batch": 16, "queue_size": 128, "max_lanes": 8,
        "queue_share": 0.5, "quota_rps": 0.0, "quota_burst": None,
        "cache_entries": 64, "cache_mb": 256.0, "workers": 1,
        "coalesce_window": 0.0, "http": "asyncio", "row_pool_chunks": 8,
        "row_pool_chunk_rows": 2048, "request_timeout": 120.0,
        "reload_interval": 5.0, "promote": "immediate", "lockwatch": False,
        "device": "cuda"}


@pytest.mark.parametrize("extra", [
    ["--population", "3", "--cohort", "2"],
    ["--aggregation", "buffered", "--faults",
     "straggle:rank=2,delay=1,round=1,until=1"],
    ["--ema-decay", "0.9", "--save-model"],
    ["--rounds-per-program", "2", "--sample-every", "0"],
    ["--mode", "mdgan", "--save-model", "--save-every", "1"],
], ids=["cohort", "buffered", "ema", "rounds_per_program", "mdgan"])
def test_round_scale_flags_run(data, tmp_path, capsys, extra):
    """The round-scale flags train to exit 0 (each refused with exit 2
    before this slice), with an evaluated last snapshot."""
    from fed_tgan_torch.testing.faults import ENV_VAR, install_plan

    try:
        assert port_cli.main(argv(data, tmp_path, "--device", "cpu",
                                  *extra)) == 0
    finally:
        install_plan(None)
        os.environ.pop(ENV_VAR, None)
    out = capsys.readouterr().out
    assert "final Avg_JSD=" in out and "2 rounds in" in out
    assert (tmp_path / "Intrusion_result"
            / "Intrusion_synthesis_epoch_1.csv").exists()
    if "--save-model" in extra:
        assert (tmp_path / "models" / "synthesizer_torch").is_dir()
    if "mdgan" in extra:
        host = json.load(open(tmp_path / "checkpoint" / "host.json"))
        assert host["kind"] == "mdgan_torch"


@pytest.mark.parametrize("extra", [
    ["--ema-decay", "1.0"], ["--rounds-per-program", "0"],
    ["--ema-decay", "0.5", "--mode", "mdgan"], ["--population", "4"],
    ["--cohort", "-1"], ["--cohort", "2", "--mode", "mdgan"],
    ["--aggregation", "buffered", "--mode", "standalone"],
    ["--cohort", "2", "-ip", "127.0.0.1", "-rank", "1"],
    ["--aggregation", "buffered", "-ip", "127.0.0.1", "-rank", "0",
     "-world_size", "3"],
])
def test_round_scale_parser_errors_match_jax(data, tmp_path, capsys, extra):
    """Both CLIs refuse the same argv with exit 2 and the same error."""
    errors = []
    for main in (port_cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(argv(data, tmp_path, *extra))
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error: ", 1)[1] == errors[1].split(
        "error: ", 1)[1]


def test_rounds_per_program_notes_a_capping_cadence(data, tmp_path, capsys):
    """K above the hook cadence prints the JAX CLI's note and still runs
    (``fed_tgan_tpu/cli.py:1248-1270``); a churn plan under ``--mode
    mdgan`` exits 2 with JAX's message."""
    assert port_cli.main(argv(data, tmp_path, "--device", "cpu",
                              "--rounds-per-program", "4")) == 0
    out = capsys.readouterr().out
    assert ("note: hook cadence (every 1 rounds) is below "
            "--rounds-per-program 4; hooks force program boundaries, "
            "capping the effective fusion") in out
    from fed_tgan_torch.testing.faults import ENV_VAR, install_plan

    try:
        assert port_cli.main(argv(data, tmp_path / "b", "--device", "cpu",
                                  "--mode", "mdgan", "--faults",
                                  "join:round=2,count=1")) == 2
    finally:
        install_plan(None)
        os.environ.pop(ENV_VAR, None)
    assert "needs --mode fedavg" in capsys.readouterr().out
