"""The port package stands alone: it never imports jax or the JAX package,
and neither its serving path nor its trainer needs pandas, pyarrow or
sklearn."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import fed_tgan_torch
from fed_tgan_torch.device import resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "fed_tgan_tpu", "pandas", "pyarrow", "sklearn")
# the run-level scripts of the port (the pod launcher, the soaks, trace
# attribution) and the monitor's cross-check
RUN_LEVEL_SCRIPTS = tuple(os.path.join(REPO, "scripts", f"torch_{name}.py")
                          for name in ("launch_pod", "soak",
                                       "trace_attribution",
                                       "crosscheck_monitor"))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        fed_tgan_torch.__path__, prefix="fed_tgan_torch."))


def _sources():
    root = os.path.join(REPO, "fed_tgan_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield from RUN_LEVEL_SCRIPTS


def test_every_port_module_imports_with_jax_blocked():
    """A fresh interpreter where importing jax, the JAX package, pandas,
    pyarrow or sklearn fails imports every port module and chip_smoke.py."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(mod)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_fastcsv_formats_with_jax_pandas_and_pyarrow_blocked():
    """The compiled CSV formatter builds, loads and writes in a fresh
    interpreter where jax, the JAX package, pandas, pyarrow and sklearn
    cannot be imported."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from fed_tgan_torch.data import fastcsv\n"
        "from fed_tgan_torch.data.csvio import csv_bytes\n"
        "cols = {'x': np.array([0.1, -2.0]), 'c': np.array(['a,b', 'c'], "
        "dtype=object)}\n"
        "assert csv_bytes(cols) == b'x,c\\n0.1,\"a,b\"\\n-2.0,c\\n'\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_obs_cli_runs_without_torch_or_numpy(tmp_path):
    """``python -m fed_tgan_torch.obs report|slo|watch`` in a fresh
    interpreter where torch, numpy, jax and the JAX package cannot be
    imported: the observability CLI is stdlib only."""
    from fed_tgan_torch.obs import RunJournal

    path = str(tmp_path / "journal.jsonl")
    with RunJournal(path, run_id="bare") as j:
        j.emit("round", round=0, first=0, rounds_per_program=1,
               per_round_s=0.5, finite=True)
        j.emit("client_contribution", round=0, first=0, rounds_per_program=1,
               clients=[0, 1], weights=[0.5, 0.5], loss_d=[0.1, 0.2],
               loss_g=[0.3, 0.4], quarantined=[0, 0], strikes=[0, 0])
    blocked = ("torch", "numpy", "jax", "jaxlib", "fed_tgan_tpu")
    for cmd, want in (("report", "clients: 2 tracked over 1 round(s)"),
                      ("slo", "slo: 0 checked"), ("watch", "[watch] round 0")):
        code = (
            "import runpy, sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = ['obs', {cmd!r}, {path!r}]\n"
            "runpy.run_module('fed_tgan_torch.obs', run_name='__main__')\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, (cmd, proc.stderr)
        assert want in proc.stdout, (cmd, proc.stdout)


def test_sources_never_import_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|fed_tgan_tpu)\b",
                     re.MULTILINE)
    offenders = [(p, m.group(0).strip()) for p in _sources()
                 for m in pat.finditer(open(p).read())]
    assert offenders == []


def test_port_package_lists_every_slice_module():
    mods = set(_port_modules())
    for name in ("device", "interop", "data.schema", "data.encoders",
                 "data.decode", "data.csvio", "features.transformer",
                 "features.bgm", "ops.segments", "ops.activate_cuda",
                 "ops.decode", "models.ctgan", "models.losses",
                 "train.sampler", "train.steps", "train.standalone",
                 "runtime.checkpoint", "serve.registry", "serve.engine",
                 "serve.service", "serve.demo", "__main__", "cli",
                 "datasets", "data.ingest", "data.sharding",
                 "federation.init", "parallel.fedavg", "train.federated",
                 "train.snapshots", "eval.similarity", "testing.faults",
                 "train.monitor", "train.watchdog", "data.fastcsv",
                 "obs.registry", "serve.metrics", "serve.fleet",
                 "serve.pool", "serve.frontdoor", "obs.slo",
                 "serve.canary", "federation.sketch", "data.dates",
                 "runtime.precision", "federation.init_cache",
                 "federation.streaming", "federation.elastic",
                 "train.mdgan", "runtime.transport", "federation.distributed",
                 "parallel.multihost", "train.multihost", "distributed",
                 "analysis", "analysis.__main__", "analysis.lint",
                 "analysis.contracts", "analysis.contracts.ir",
                 "analysis.contracts.harness", "analysis.contracts.check",
                 "analysis.rules", "analysis.rules.base",
                 "analysis.rules.host_sync", "analysis.rules.prng_reuse",
                 "analysis.rules.recompile", "analysis.rules.numpy_in_jit",
                 "analysis.rules.shared_state",
                 "analysis.rules.dtype_promotion",
                 "analysis.sanitizers", "analysis.lockwatch",
                 "analysis.concurrency.model", "analysis.concurrency.rules",
                 "analysis.concurrency.ast_helpers",
                 "analysis.telemetry.extract", "analysis.telemetry.rules",
                 "analysis.telemetry.schema", "ops.diagnostics", "doctor",
                 "runtime.backend", "eval.utility", "features.zoo"):
        assert f"fed_tgan_torch.{name}" in mods


def test_analysis_cli_runs_without_torch_or_numpy():
    """``python -m fed_tgan_torch.analysis`` (the lint: J01-J06 + L01-L04)
    and ``--telemetry`` (obslint) in a fresh interpreter where torch,
    numpy, jax, the JAX package, pandas, pyarrow and sklearn cannot be
    imported: both are stdlib AST analyses, clean against their
    checked-in baselines."""
    blocked = ("torch", "numpy") + BLOCKED
    for args, want in (([], "finding(s): 0 new"),
                       (["--telemetry"], "obslint: 0 finding(s)")):
        code = (
            "import runpy, sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = ['analysis', *{args!r}]\n"
            "runpy.run_module('fed_tgan_torch.analysis', run_name='__main__')\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (args, proc.stdout, proc.stderr)
        assert want in proc.stdout, (args, proc.stdout)


def test_analysis_prongs_import_without_torch_or_numpy():
    """The lint's rules and the contracts' fingerprint and diff import in
    an interpreter where torch, numpy, jax and the JAX package cannot be
    imported: only the contracts' recorder and harness need torch, and
    they import it when they run."""
    blocked = ("torch", "numpy") + BLOCKED
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import fed_tgan_torch.analysis.rules\n"
        "import fed_tgan_torch.analysis.contracts.check as c\n"
        "import fed_tgan_torch.analysis.contracts.harness\n"
        "print(len(c.diff_contracts({}, {})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "0", proc.stderr


def test_trainer_runs_with_jax_sklearn_and_pandas_blocked():
    """A few training steps and a sample on the CPU in a fresh interpreter
    where jax, the JAX package, pandas, pyarrow and sklearn cannot be
    imported: the trainer's path needs none of them."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from fed_tgan_torch.serve.demo import intrusion_like_table\n"
        "from fed_tgan_torch.train.standalone import StandaloneSynthesizer\n"
        "from fed_tgan_torch.train.steps import TrainConfig\n"
        "m, cat, _, _ = intrusion_like_table(120, 0)\n"
        "cfg = TrainConfig(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),"
        " batch_size=40)\n"
        "s = StandaloneSynthesizer(cfg, device='cpu').fit(m, cat, epochs=1)\n"
        "assert s.sample(50).shape == (50, 42)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_stacked_ragged_round_runs_with_jax_sklearn_and_pandas_blocked():
    """Two stacked rounds of 4 Dirichlet clients of the Adult-shaped table
    (4, 0, 3 and 1 steps a round) on the CPU in a fresh interpreter where
    jax, the JAX package, pandas, pyarrow and sklearn cannot be imported;
    two runs from one seed end equal."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from fed_tgan_torch.data.ingest import TablePreprocessor\n"
        "from fed_tgan_torch.data.sharding import shard_table\n"
        "from fed_tgan_torch.datasets import ADULT, preprocessor_kwargs\n"
        "from fed_tgan_torch.federation.init import federated_initialize\n"
        "from fed_tgan_torch.serve.demo import adult_like_table\n"
        "from fed_tgan_torch.train.federated import FederatedTrainer\n"
        "from fed_tgan_torch.train.steps import TrainConfig\n"
        "kw = preprocessor_kwargs(ADULT)\n"
        "shards = shard_table(adult_like_table(400, 11), 4, 'dirichlet',\n"
        "                     label_column='income', alpha=0.5, seed=9)\n"
        "init = federated_initialize([TablePreprocessor(table=t, **kw)\n"
        "                             for t in shards], device='cpu')\n"
        "cfg = TrainConfig(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),\n"
        "                  batch_size=40, pac=4,\n"
        "                  allow_zero_step_clients=True)\n"
        "runs = [FederatedTrainer(init, cfg, seed=3, device='cpu').fit(2)\n"
        "        for _ in range(2)]\n"
        "assert runs[0].steps.tolist() == [4, 0, 3, 1]\n"
        "assert (runs[0].last_metrics[1] == 0).all()\n"
        "assert torch.equal(runs[0].stack.generator.params,\n"
        "                   runs[1].stack.generator.params)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_federated_cli_runs_with_jax_sklearn_and_pandas_blocked(tmp_path):
    """``python -m fed_tgan_torch --mode fedavg`` for one round on the CPU
    in a fresh interpreter where jax, the JAX package, pandas, pyarrow and
    sklearn cannot be imported: CSV ingest, init, the round, a snapshot,
    the monitor, a checkpoint under the watchdog and a fault plan, the
    artifact and the evaluation need none of them."""
    data = str(tmp_path / "intr.csv")
    argv = ["--mode", "fedavg", "--datapath", data, "--dataset", "intrusion",
            "--n-clients", "2", "-epochs", "1", "--sample-rows", "60",
            "--batch-size", "40", "--embedding-dim", "8", "--eval",
            "--save-model", "--out-dir", str(tmp_path / "out"), "--quiet",
            "--device", "cpu", "--monitor-every", "1", "--save-every", "1",
            "--watchdog", "--faults", "crash_checkpoint:save=9"]
    code = (
        "import sys, runpy\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from fed_tgan_torch.serve.demo import write_intrusion_csv\n"
        f"write_intrusion_csv({data!r}, 160, 0)\n"
        f"sys.argv = ['fed_tgan_torch'] + {argv!r}\n"
        "runpy.run_module('fed_tgan_torch', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "final Avg_JSD=" in proc.stdout
    snap = tmp_path / "out" / "Intrusion_result" / "Intrusion_synthesis_epoch_0.csv"
    assert open(snap).read().count("\n") == 61
    assert (tmp_path / "out" / "models" / "synthesizer_torch").is_dir()
    assert (tmp_path / "out" / "checkpoint" / "COMPLETE").exists()
    assert open(tmp_path / "out" / "monitor_similarity.csv").read().count(
        "\n") == 2


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
    with pytest.raises(ValueError):
        resolve_device("meta")


def _default_device_builders():
    import numpy as np

    from fed_tgan_torch.models.ctgan import (
        StackedDiscriminator,
        StackedGenerator,
    )
    from fed_tgan_torch.ops.segments import SegmentSpec
    from fed_tgan_torch.train import steps
    from fed_tgan_torch.train.sampler import CondSampler, RowSampler

    spec = SegmentSpec.from_output_info([(1, "tanh"), (3, "softmax")])
    data = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 1]]
    cfg = steps.TrainConfig(embedding_dim=4, gen_dims=(8,), dis_dims=(8,),
                            batch_size=10, pac=5)
    return {
        "init_models": lambda: steps.init_models(spec, cfg).generator,
        "stacked_generator": lambda: StackedGenerator(2, 4, (8,), 4).params,
        "stacked_discriminator":
            lambda: StackedDiscriminator(2, 4, (8,), 5).params,
        "cond_sampler": lambda: CondSampler.from_data(data, spec).p_train,
        "row_sampler": lambda: RowSampler.from_data(data, spec).row_pool,
    }


@pytest.mark.parametrize("name", ["init_models", "cond_sampler",
                                  "row_sampler", "stacked_generator",
                                  "stacked_discriminator"])
def test_trainer_builders_default_to_the_card(name):
    """The trainer's building blocks run on the card unless the caller
    names the CPU: without CUDA, the default raises."""
    build = _default_device_builders()[name]
    if torch.cuda.is_available():
        out = build()
        dev = (next(out.parameters()).device if isinstance(out, torch.nn.Module)
               else out.device)
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_federated_entry_points_default_to_the_card(capsys):
    """Federated init, the federated trainer and the training CLI run on
    the card unless the caller names the CPU: without CUDA, the library
    entry points raise and the CLI (every rank of a world too) exits 3
    after its backend probe, naming ``--backend cpu``."""
    import numpy as np

    from fed_tgan_torch import cli
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize
    from fed_tgan_torch.train.federated import FederatedTrainer
    from fed_tgan_torch.train.mdgan import MDGANTrainer
    from fed_tgan_torch.train.steps import TrainConfig

    table = {"x": np.arange(40.0),
             "c": np.array(["a", "b"] * 20, dtype=object)}
    pre = TablePreprocessor(table=table, categorical_columns=["c"])
    init = federated_initialize([pre], device="cpu")
    cfg = TrainConfig(embedding_dim=4, gen_dims=(8,), dis_dims=(8,),
                      batch_size=10, pac=5)
    if torch.cuda.is_available():
        assert FederatedTrainer(init, cfg).data[0].is_cuda
        assert MDGANTrainer(init, cfg).data[0].is_cuda
        assert federated_initialize([pre]).weights.shape == (1,)
        return
    from fed_tgan_torch.parallel.multihost import participant_device

    for call in (lambda: federated_initialize([pre]),
                 lambda: FederatedTrainer(init, cfg),
                 lambda: MDGANTrainer(init, cfg),
                 lambda: participant_device(1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    for argv, who in ((["--datapath", "none.csv"], ""),
                      (["-ip", "127.0.0.1", "-rank", "0", "-world_size",
                        "3"], "rank 0: "),
                      (["-ip", "127.0.0.1", "-rank", "1", "-datapath",
                        "none.csv"], "rank 1: ")):
        assert cli.main(argv) == 3
        out = capsys.readouterr().out
        assert out.startswith(f"{who}CUDA backend unusable"), out
        assert "--backend cpu" in out


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("command", ["serve", "fleet", "sample-client"])
def test_serving_commands_help_with_jax_sklearn_and_pandas_blocked(command):
    """``serve``, ``fleet`` and ``sample-client --help`` run in a fresh
    interpreter where jax, the JAX package, pandas, pyarrow and sklearn
    cannot be imported."""
    code = (
        "import sys, runpy\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['fed_tgan_torch', {command!r}, '--help']\n"
        "runpy.run_module('fed_tgan_torch', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"python -m fed_tgan_torch {command}" in proc.stdout


def test_fleet_serves_with_jax_sklearn_and_pandas_blocked(tmp_path):
    """Two tenants behind the asyncio front door on the CPU, one lane
    dispatch, a row pool and a hot reload, in a fresh interpreter where
    jax, the JAX package, pandas, pyarrow and sklearn cannot be
    imported."""
    code = (
        "import sys, urllib.request\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from fed_tgan_torch.serve.demo import build_random_artifact\n"
        "from fed_tgan_torch.serve.fleet import FleetRegistry, FleetService\n"
        "from fed_tgan_torch.serve.pool import RowPool\n"
        "from fed_tgan_torch.train.steps import TrainConfig\n"
        "cfg = TrainConfig(embedding_dim=8, gen_dims=(16,), batch_size=20)\n"
        "fleet = FleetRegistry(device='cpu', log=lambda *a: None)\n"
        "for i, name in enumerate(('a', 'b')):\n"
        f"    fleet.load(name, build_random_artifact({str(tmp_path)!r} + name,"
        " seed=i, cfg=cfg))\n"
        "svc = FleetService(fleet, http_mode='asyncio', row_pool=RowPool("
        "fleet), reload_interval_s=0, log=lambda *a: None).start()\n"
        "get = lambda t: urllib.request.urlopen(svc.url + '/t/' + t + "
        "'/sample?rows=30&seed=2', timeout=60).read()\n"
        "assert get('a') != get('b')\n"
        "svc.shutdown()\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_serving_entry_points_default_to_the_card(tmp_path):
    """The registry, the fleet, the canary's scorer and the ``serve`` /
    ``fleet`` commands run on the card unless the caller names the CPU:
    without CUDA, they raise."""
    from fed_tgan_torch.__main__ import main
    from fed_tgan_torch.serve.canary import compute_reference_stats, score_frame
    from fed_tgan_torch.serve.demo import demo_frame
    from fed_tgan_torch.serve.demo import build_random_artifact
    from fed_tgan_torch.serve.fleet import FleetRegistry
    from fed_tgan_torch.serve.registry import ModelRegistry
    from fed_tgan_torch.train.steps import TrainConfig

    art = build_random_artifact(str(tmp_path), cfg=TrainConfig(
        embedding_dim=8, gen_dims=(16,), batch_size=20))
    frame = demo_frame(rows=40, seed=0)
    stats = compute_reference_stats(frame, ["color", "flag"])
    if torch.cuda.is_available():
        assert ModelRegistry(art).get().synth.device.type == "cuda"
        return
    for call in (lambda: ModelRegistry(art).get(),
                 lambda: score_frame(stats, frame),
                 lambda: FleetRegistry().load("a", art),
                 lambda: main(["serve", art, "--port", "0"]),
                 lambda: main(["fleet", f"a={art}", "--port", "0"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_first_parallel_log_after_import_is_accurate():
    """Importing the package settles MKL's vector math before any parallel
    call: in fresh interpreters started together (a loaded host), the
    first ``torch.log`` over a (1000, 282) float32 tensor (the CPU
    activation's Gumbel noise) is within 2 ulps of the float64 log
    everywhere (without the settling call one thread's chunk was seen
    4e-5 off, in about one process in twenty)."""
    code = (
        "import numpy as np, torch, fed_tgan_torch\n"
        "u = np.random.default_rng(1).random((1000, 282)).astype(np.float32)\n"
        "got = torch.log(torch.from_numpy(u)).numpy()\n"
        "want = np.log(u.astype(np.float64))\n"
        "ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)\n"
        "print(float((np.abs(got - want) / ulp).max()))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(8)]
    errs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        errs.append(float(out))
    assert max(errs) <= 2.0, errs  # in float32 ulps of the log


def test_canary_and_dates_run_with_jax_sklearn_and_pandas_blocked(tmp_path):
    """In a fresh interpreter where jax, the JAX package, pandas, pyarrow
    and sklearn cannot be imported: a demo artifact trains and writes its
    reference statistics, a degraded generation is rejected by the canary
    gate, the ML probe answers None (no sklearn), and a dated table splits,
    decodes and writes its CSV."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from fed_tgan_torch.serve.canary import (CanaryGate,\n"
        "    compute_reference_stats, ml_efficacy_probe)\n"
        "from fed_tgan_torch.serve.demo import (build_demo_artifact,\n"
        "    demo_frame)\n"
        "from fed_tgan_torch.serve.engine import SamplingEngine\n"
        "from fed_tgan_torch.serve.registry import ModelRegistry\n"
        "from fed_tgan_torch.testing.faults import degrade_checkpoint\n"
        f"root = build_demo_artifact({str(tmp_path / 'a')!r}, rows=120,\n"
        "                           device='cpu')\n"
        "reg = ModelRegistry(root, device='cpu', log=lambda *a: None)\n"
        "gate = CanaryGate(reg, SamplingEngine(reg.get()),\n"
        "                  log=lambda *a: None)\n"
        "degrade_checkpoint(root + '/models/synthesizer_torch', 100.0)\n"
        "assert gate.consider()['promoted'] is False\n"
        "f = demo_frame(120)\n"
        "st = compute_reference_stats(f, ['color', 'flag'], probe_rows=8)\n"
        "assert ml_efficacy_probe(st, f) is None\n"
        "from fed_tgan_torch.data.csvio import csv_bytes\n"
        "from fed_tgan_torch.data.decode import decode_columns\n"
        "from fed_tgan_torch.data.ingest import TablePreprocessor\n"
        "from fed_tgan_torch.data.schema import TableMeta\n"
        "from fed_tgan_torch.federation.init import harmonize_categories\n"
        "t = {'x': np.arange(6.0), 'd': np.array(['2024-02-29', ' ',\n"
        "     '2001-01-31', '2005-12-01', '2000-02-29', '1999-07-04'],\n"
        "     dtype=object)}\n"
        "pre = TablePreprocessor(table=t, date_formats={'d': 'YYYY-MM-DD'})\n"
        "m, enc, _ = harmonize_categories([pre.local_meta()])\n"
        "blob = csv_bytes(decode_columns(pre.encode(enc)[0],\n"
        "                 TableMeta.from_json_dict(m), enc))\n"
        "assert blob.splitlines()[1] == b'0.0,2024-02-29 00:00:00', blob\n"
        "assert blob.splitlines()[2] == b'1.0, ', blob\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def test_onboarding_and_churn_cli_runs_with_jax_sklearn_and_pandas_blocked(
        tmp_path):
    """The CLI's ``--similarity sketch --init-cache`` init and an elastic
    run with join, leave and drift faults on the CPU in a fresh
    interpreter where jax, the JAX package, pandas, pyarrow and sklearn
    cannot be imported; a second run restores the init from the cache."""
    data = str(tmp_path / "intr.csv")
    argv = ["--mode", "fedavg", "--datapath", data, "--dataset", "intrusion",
            "--n-clients", "2", "-epochs", "3", "--sample-rows", "60",
            "--batch-size", "40", "--embedding-dim", "8", "--quiet",
            "--device", "cpu", "--similarity", "sketch", "--init-cache",
            str(tmp_path / "cache"), "--elastic-capacity", "4",
            "--drift-every", "1", "--faults",
            "join:round=2,count=1;leave:client=0,round=3;"
            "drift:client=1,round=2,shift=2.0"]
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from fed_tgan_torch import cli\n"
        "from fed_tgan_torch.serve.demo import write_intrusion_csv\n"
        f"write_intrusion_csv({data!r}, 240, 0)\n"
        "for out in ('a', 'b'):\n"
        f"    assert cli.main({argv!r} + ['--out-dir', {str(tmp_path)!r}\n"
        "                                + '/' + out]) == 0\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    assert len(os.listdir(tmp_path / "cache")) == 4  # 2 clients, 1 global


def test_round_scale_cli_runs_with_jax_sklearn_and_pandas_blocked(tmp_path):
    """The CLI's ``--cohort`` run (with buffered aggregation, a straggler,
    the EMA and chunks of 2 rounds) and a ``--mode mdgan`` run on the CPU
    in a fresh interpreter where jax, the JAX package, pandas, pyarrow and
    sklearn cannot be imported."""
    data = str(tmp_path / "intr.csv")
    argv = ["--datapath", data, "--dataset", "intrusion", "--n-clients",
            "3", "-epochs", "3", "--sample-rows", "60", "--batch-size",
            "40", "--embedding-dim", "8", "--quiet", "--device", "cpu",
            "--save-model"]
    runs = [["--mode", "fedavg", "--cohort", "2", "--aggregation",
             "buffered", "--faults", "straggle:rank=2,delay=1,round=2",
             "--ema-decay", "0.9", "--rounds-per-program", "2"],
            ["--mode", "mdgan", "--save-every", "1"]]
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from fed_tgan_torch import cli\n"
        "from fed_tgan_torch.serve.demo import write_intrusion_csv\n"
        f"write_intrusion_csv({data!r}, 240, 0)\n"
        f"for i, extra in enumerate({runs!r}):\n"
        f"    out = {str(tmp_path)!r} + f'/run{{i}}'\n"
        f"    assert cli.main({argv!r} + extra + ['--out-dir', out]) == 0\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    for i in range(2):
        assert (tmp_path / f"run{i}" / "models" / "synthesizer_torch").is_dir()
    host = json.load(open(tmp_path / "run1" / "checkpoint" / "host.json"))
    assert host["kind"] == "mdgan_torch" and host["completed_epochs"] == 3


def test_multihost_world_runs_with_jax_sklearn_and_pandas_blocked(tmp_path):
    """A world of rank 0 and 2 participants, each launched in a fresh
    interpreter where jax, the JAX package, pandas, pyarrow and sklearn
    cannot be imported: the init protocol, a bf16 round over gloo (the
    bf16 delta payload), the snapshot written by rank 0."""
    from fed_tgan_torch.data.csvio import read_csv, write_csv
    from fed_tgan_torch.data.sharding import shard_table
    from fed_tgan_torch.serve.demo import write_intrusion_csv
    from test_torch_world import launch_world

    table = read_csv(write_intrusion_csv(str(tmp_path / "intr.csv"), 200, 0))
    shards = []
    for i, part in enumerate(shard_table(table, 2, "iid", seed=1)):
        shards.append(str(tmp_path / f"shard{i + 1}.csv"))
        write_csv(part, shards[-1])
    out = tmp_path / "out"
    res = launch_world(str(tmp_path), [
        "--dataset", "intrusion", "-epochs", "1", "--sample-rows", "40",
        "--batch-size", "50", "--embedding-dim", "8", "--device", "cpu",
        "--precision", "bf16", "--out-dir", str(out)], shards, blocked=True)
    assert [rc for rc, _, _ in res] == [0, 0, 0], res
    assert "final aggregated params identical across 2" in res[0][1]
    assert (out / "Intrusion_result" / "Intrusion_synthesis_epoch_0.csv"
            ).is_file()


def _blocked_run(script, argv, blocked, timeout=180):
    """``script argv`` in a fresh interpreter where the ``blocked``
    modules cannot be imported."""
    code = ("import runpy, sys\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            f"sys.argv = [{script!r}] + {list(argv)!r}\n"
            f"runpy.run_path({script!r}, run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_pod_launcher_plans_and_merges_without_torch(tmp_path):
    """The launcher's ``--dry-run`` and its journal merge run where torch,
    numpy, jax, the JAX package, pandas, pyarrow and sklearn cannot be
    imported: the planning parent and ``obs.report`` are stdlib only."""
    from fed_tgan_torch.obs import RunJournal

    script = RUN_LEVEL_SCRIPTS[0]
    blocked = BLOCKED + ("torch", "numpy")
    proc = _blocked_run(script, ["--processes", "3", "--dry-run",
                                 "--out-dir", str(tmp_path)], blocked)
    assert proc.returncode == 0, proc.stderr
    assert "parent_torch_imported=False" in proc.stdout
    for r in range(2):
        with RunJournal(str(tmp_path / f"pod_journal_rank{r}.jsonl"),
                        run_id=f"r{r}") as j:
            j.emit("round", round=0, first=0, rounds_per_program=1,
                   per_round_s=0.5, finite=True)
    code = ("import sys, importlib.util\n"
            f"for name in {blocked!r}:\n"
            "    sys.modules[name] = None\n"
            f"spec = importlib.util.spec_from_file_location('pod', {script!r})\n"
            "pod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(pod)\n"
            "args = pod.build_parser().parse_args(['--processes', '2'])\n"
            f"plan = pod.build_plan(args, {str(tmp_path)!r}, 25000, ['x.csv'])\n"
            f"print(pod.merge_journals(plan, {str(tmp_path)!r}, "
            "{'codes': {0: 0, 1: 0}, 'departed': None, 'wall_s': 1.0}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    fed = json.load(open(tmp_path / "federation.json"))
    assert len(fed["paths"]) == 2 and fed["pod"]["processes"] == 2


def test_soak_runs_with_jax_sklearn_and_pandas_blocked():
    proc = _blocked_run(RUN_LEVEL_SCRIPTS[1], [
        "--seed", "4", "--epochs", "2", "--device", "cpu"], BLOCKED)
    assert proc.returncode == 0, proc.stderr
    assert "soak OK: 1 seed(s)" in proc.stdout


def test_trace_attribution_runs_without_torch_or_numpy(tmp_path):
    with open(tmp_path / "trace_1.json", "w") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "cat": "user_annotation", "name": "train.snapshot",
             "pid": 1, "tid": 1, "ts": 0, "dur": 2000}]}, f)
    proc = _blocked_run(RUN_LEVEL_SCRIPTS[2], [str(tmp_path)],
                        BLOCKED + ("torch", "numpy"))
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)[str(tmp_path)]
    assert out["host_hotspots_ms"] == {"train.snapshot": {"total": 2.0,
                                                          "count": 1}}


def test_offline_eval_and_zoo_run_with_jax_sklearn_pandas_pyarrow_blocked(
        tmp_path):
    """Where jax, the JAX package, pandas, pyarrow and sklearn cannot be
    imported: the similarity report's module CLI and the cross-check
    script run; the closed-form encoders of the zoo run; what needs a
    host library (the utility CLI, the two mixtures of the zoo, a
    columnar snapshot writer) ends naming it."""
    result = tmp_path / "toy_result"
    result.mkdir()
    real = "x,c\n1.5,a\n2.5,b\n0.5,a\n"
    (tmp_path / "real.csv").write_text(real)
    for e in (0, 1):
        (result / f"toy_synthesis_epoch_{e}.csv").write_text(
            "x,c\n1.0,a\n2.0,a\n0.25,b\n")
    (tmp_path / "monitor.csv").write_text(
        "Epoch_No.,Avg_JSD,Avg_WD\n0,0.1,0.2\n1,0.1,0.2\n")
    report = str(tmp_path / "report.csv")
    code = (
        "import runpy, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        f"sys.argv = ['similarity', '--real', {str(tmp_path / 'real.csv')!r},"
        f" '--result-dir', {str(result)!r}, '--name', 'toy', "
        f"'--categorical', 'c', '-o', {report!r}]\n"
        "try:\n"
        "    runpy.run_module('fed_tgan_torch.eval.similarity', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"sys.argv = ['xc', '--monitor-csv', "
        f"{str(tmp_path / 'monitor.csv')!r}, '--similarity-csv', {report!r}]\n"
        "try:\n"
        f"    runpy.run_path({RUN_LEVEL_SCRIPTS[3]!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "from fed_tgan_torch.features import zoo\n"
        "data = np.array([[1.0, 'a'], [2.0, 'b'], [0.5, 'a']], "
        "dtype=object)\n"
        "for enc in (zoo.BinningTransformer(4, device='cpu'), "
        "zoo.MinMaxTransformer(device='cpu'), "
        "zoo.GridTransformer(2, device='cpu')):\n"
        "    enc.fit(data, categorical_columns=(1,))\n"
        "    back = enc.inverse_transform(enc.transform(data))\n"
        "    assert back[:, 1].tolist() == ['a', 'b', 'a']\n"
        "from fed_tgan_torch.eval import utility\n"
        "from fed_tgan_torch.train.snapshots import SnapshotWriter\n"
        "for call, lib in ((lambda: zoo.GMMTransformer(device='cpu').fit("
        "data, categorical_columns=(1,)), 'sklearn'), "
        "(lambda: zoo.BGMTransformer(device='cpu').fit("
        "data, categorical_columns=(1,)), 'sklearn'), "
        "(lambda: utility.ml_utility({}, {}, {}, 'c', []), 'sklearn'), "
        "(lambda: SnapshotWriter(None, [], str, fmt='parquet'), "
        "'pyarrow')):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as exc:\n"
        "        assert lib in str(exc), exc\n"
        "    else:\n"
        "        raise AssertionError(lib)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert json.loads(lines[-2])["rounds_compared"] == 2
    assert open(report).readline().strip() == "Epoch_No.,Avg_JSD,Avg_WD"
