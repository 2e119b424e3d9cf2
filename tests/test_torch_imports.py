"""The port package stands alone: it never imports jax or the JAX package,
and its serving path needs no pandas, pyarrow or sklearn."""

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
                 "ops.segments", "ops.activate_cuda", "ops.decode",
                 "models.ctgan", "train.sampler", "train.steps",
                 "runtime.checkpoint", "serve.registry", "serve.engine",
                 "serve.service", "serve.demo", "__main__"):
        assert f"fed_tgan_torch.{name}" in mods


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
