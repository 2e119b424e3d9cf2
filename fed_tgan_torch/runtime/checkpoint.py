"""The port's sampling artifact: a directory with no pickles.

``<models>/synthesizer_torch/`` holds

- ``config.json``: format version, the ``TrainConfig`` fields,
  ``output_info``, ``key_offset`` and the column list (name, kind);
- ``weights.npz``: the generator's ``state_dict`` (``generator.*``), the
  conditional sampler tables (``cond.p_train``, ``cond.p_empirical``) and
  the decode tables (``col_NNNNN.means`` / ``.stds`` or ``.codes``).

The meta JSON (``<name>.json``) and ``label_encoders_<name>.json`` sit
beside the directory.  Counterpart of the JAX ``save_synthesizer`` /
``load_synthesizer`` (``fed_tgan_tpu/runtime/checkpoint.py:398-498``),
whose ``host.pkl`` + ``arrays.npz`` artifacts :mod:`fed_tgan_torch.interop`
converts into this format.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.features.transformer import (
    ContinuousColumn,
    DiscreteColumn,
    output_info,
)
from fed_tgan_torch.models.ctgan import Generator
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.train.sampler import CondSampler
from fed_tgan_torch.train.steps import TrainConfig, require_f32

SYNTH_DIR = "synthesizer_torch"
FORMAT_VERSION = 1
_CONFIG = "config.json"
_WEIGHTS = "weights.npz"


class SavedSynthesizer:
    """Everything sampling needs: eval-mode generator, conditional
    sampler, decode columns, config, layout and the sampling-key offset
    of the model's source (so a converted artifact keeps its stream)."""

    def __init__(self, generator: Generator, cond: CondSampler, columns: list,
                 cfg: TrainConfig, key_offset: int = 17):
        require_f32(cfg)
        self.generator = generator.eval()
        self.cond = cond
        self.columns = list(columns)
        self.cfg = cfg
        self.spec = cond.spec
        self.key_offset = int(key_offset)
        if self.spec.output_info != tuple(output_info(self.columns)):
            raise ValueError("decode columns do not match the layout")

    @property
    def device(self) -> torch.device:
        return self.generator.out.weight.device


def config_to_dict(cfg: TrainConfig) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}


def config_from_dict(d: dict) -> TrainConfig:
    """A ``TrainConfig`` from a field dict; unknown keys are dropped."""
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items() if k in names})


def save_synthesizer(synth: SavedSynthesizer, path: str) -> None:
    """Write ``synth`` to the directory ``path``: staged in a sibling
    temp directory, then renamed into place (a reader never sees a
    half-written artifact)."""
    config = {
        "version": FORMAT_VERSION,
        "kind": "synthesizer_torch",
        "cfg": config_to_dict(synth.cfg),
        "output_info": [list(x) for x in synth.spec.output_info],
        "key_offset": synth.key_offset,
        "columns": [{"name": c.name, "kind": "cont" if isinstance(
            c, ContinuousColumn) else "disc"} for c in synth.columns],
    }
    arrays = {f"generator.{k}": v.detach().cpu().numpy()
              for k, v in synth.generator.state_dict().items()}
    arrays["cond.p_train"] = synth.cond.p_train.cpu().numpy()
    arrays["cond.p_empirical"] = synth.cond.p_empirical.cpu().numpy()
    for i, col in enumerate(synth.columns):
        if isinstance(col, ContinuousColumn):
            arrays[f"col_{i:05d}.means"] = np.asarray(col.means, np.float64)
            arrays[f"col_{i:05d}.stds"] = np.asarray(col.stds, np.float64)
        else:
            arrays[f"col_{i:05d}.codes"] = np.asarray(col.codes, np.int64)
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, _CONFIG), "w") as f:
        json.dump(config, f, indent=1)
    with open(os.path.join(tmp, _WEIGHTS), "wb") as f:
        np.savez(f, **arrays)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_synthesizer(path: str, device="cuda") -> SavedSynthesizer:
    """Read a ``save_synthesizer`` directory onto ``device``."""
    device = resolve_device(device)
    with open(os.path.join(path, _CONFIG)) as f:
        config = json.load(f)
    if config.get("kind") != "synthesizer_torch":
        raise ValueError(f"{path} is not a port synthesizer artifact")
    if config["version"] > FORMAT_VERSION:
        raise ValueError(f"artifact version {config['version']} is newer "
                         f"than supported {FORMAT_VERSION}")
    cfg = config_from_dict(config["cfg"])
    spec = SegmentSpec.from_output_info(config["output_info"])
    with np.load(os.path.join(path, _WEIGHTS)) as data:
        columns = []
        for i, c in enumerate(config["columns"]):
            key = f"col_{i:05d}"
            if c["kind"] == "cont":
                columns.append(ContinuousColumn(
                    c["name"], data[f"{key}.means"], data[f"{key}.stds"]))
            else:
                columns.append(DiscreteColumn(c["name"], data[f"{key}.codes"]))
        generator = Generator(cfg.embedding_dim + spec.n_opt, cfg.gen_dims,
                              spec.dim)
        prefix = "generator."
        generator.load_state_dict({
            k[len(prefix):]: torch.as_tensor(data[k])
            for k in data.files if k.startswith(prefix)})
        cond = CondSampler.from_tables(data["cond.p_train"],
                                       data["cond.p_empirical"], spec, device)
    return SavedSynthesizer(generator.to(device), cond, columns, cfg,
                            key_offset=config["key_offset"])


def checkpoint_fingerprint(path: str) -> str:
    """Content hash of an artifact directory (12 hex chars): the served
    model id."""
    h = hashlib.sha256()
    for fname in (_CONFIG, _WEIGHTS):
        with open(os.path.join(path, fname), "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()[:12]
