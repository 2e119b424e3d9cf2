"""The port package stands alone: it never imports jax or the JAX package,
and neither its serving path nor its trainer needs pandas, pyarrow or
sklearn."""

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
                 "serve.service", "serve.demo", "__main__"):
        assert f"fed_tgan_torch.{name}" in mods


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

    from fed_tgan_torch.ops.segments import SegmentSpec
    from fed_tgan_torch.train import steps
    from fed_tgan_torch.train.sampler import CondSampler, RowSampler

    spec = SegmentSpec.from_output_info([(1, "tanh"), (3, "softmax")])
    data = np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 1]]
    cfg = steps.TrainConfig(embedding_dim=4, gen_dims=(8,), dis_dims=(8,),
                            batch_size=10, pac=5)
    return {
        "init_models": lambda: steps.init_models(spec, cfg).generator,
        "cond_sampler": lambda: CondSampler.from_data(data, spec).p_train,
        "row_sampler": lambda: RowSampler.from_data(data, spec).row_pool,
    }


@pytest.mark.parametrize("name", ["init_models", "cond_sampler",
                                  "row_sampler"])
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


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
