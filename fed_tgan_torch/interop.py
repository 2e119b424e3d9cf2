"""Conversion from the JAX package's artifacts and pytrees to the port.

- :func:`generator_from_jax`, :func:`discriminator_from_jax` and
  :func:`cond_from_jax` turn the JAX generator parameters / BatchNorm
  state, discriminator parameters and conditional-sampler tables (numpy or
  jax arrays) into the port's modules; :func:`bundle_from_jax` makes a
  trainable :class:`~fed_tgan_torch.train.steps.Models` from a JAX
  ``ModelBundle``, and :func:`params_to_jax_layout` maps the port's
  weights back to the JAX pytree layout;
- :func:`convert_jax_artifact` reads a JAX ``--save-model`` artifact
  (``synthesizer/host.pkl`` + ``arrays.npz``, meta JSON, encoder pickle)
  and writes the port's own format (:mod:`fed_tgan_torch.runtime.checkpoint`).

The JAX package is never imported: ``host.pkl`` is read with an
unpickler that maps every ``fed_tgan_tpu.*`` and ``sklearn.*`` global to
an inert stand-in that only keeps its state.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import shutil

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.features.transformer import ContinuousColumn, DiscreteColumn
from fed_tgan_torch.models.ctgan import Discriminator, Generator
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.checkpoint import (
    SYNTH_DIR,
    SavedSynthesizer,
    config_from_dict,
    save_synthesizer,
)
from fed_tgan_torch.train.sampler import CondSampler
from fed_tgan_torch.train.steps import Models, TrainConfig


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def generator_from_jax(params_g: dict, state_g: dict) -> Generator:
    """A :class:`Generator` (CPU, eval mode) carrying JAX generator
    weights.  JAX stores a Linear's ``w`` as (fan_in, fan_out), the
    transpose of torch's weight; BatchNorm ``mean``/``var`` become the
    running statistics, ``bn_scale``/``bn_bias`` its affine parameters."""
    blocks, out = params_g["blocks"], params_g["out"]
    input_dim = np.shape(blocks[0]["fc"]["w"] if blocks else out["w"])[0]
    gen_dims = [np.shape(b["fc"]["w"])[1] for b in blocks]
    gen = Generator(input_dim, gen_dims, np.shape(out["w"])[1])
    with torch.no_grad():
        for mod, p, s in zip(gen.blocks, blocks, state_g["blocks"]):
            mod.fc.weight.copy_(_t(p["fc"]["w"]).T)
            mod.fc.bias.copy_(_t(p["fc"]["b"]))
            mod.bn.weight.copy_(_t(p["bn_scale"]))
            mod.bn.bias.copy_(_t(p["bn_bias"]))
            mod.bn.running_mean.copy_(_t(s["mean"]))
            mod.bn.running_var.copy_(_t(s["var"]))
        gen.out.weight.copy_(_t(out["w"]).T)
        gen.out.bias.copy_(_t(out["b"]))
    return gen.eval()


def discriminator_from_jax(params_d: dict, pac: int) -> Discriminator:
    """A :class:`Discriminator` (CPU) carrying JAX discriminator weights;
    the input width is the first layer's fan-in over ``pac``."""
    layers, out = params_d["layers"], params_d["out"]
    fan_in = np.shape(layers[0]["w"] if layers else out["w"])[0]
    dis = Discriminator(fan_in // pac, [np.shape(l["w"])[1] for l in layers],
                        pac)
    with torch.no_grad():
        for mod, p in zip([*dis.layers, dis.out], [*layers, out]):
            mod.weight.copy_(_t(p["w"]).T)
            mod.bias.copy_(_t(p["b"]))
    return dis


def bundle_from_jax(models, spec: SegmentSpec, cfg: TrainConfig,
                    device="cuda") -> Models:
    """Train-mode generator and discriminator with a JAX ``ModelBundle``'s
    weights and BatchNorm state, and fresh optimizers, on ``device``."""
    gen = generator_from_jax(models.params_g, models.state_g)
    dis = discriminator_from_jax(models.params_d, cfg.pac)
    device = resolve_device(device)
    return Models.build(gen.to(device), dis.to(device), spec, cfg)


def params_to_jax_layout(models: Models, of=None) -> dict:
    """``{"params_g", "state_g", "params_d"}`` as numpy copies in the JAX
    package's pytree layout (Linear ``w`` as (fan_in, fan_out)).  ``of``
    maps each parameter to the tensor reported in its place (default: the
    parameter itself), e.g. its Adam moment, so a test compares any
    per-parameter quantity leaf by leaf."""
    of = of or (lambda p: p)
    arr = lambda p: of(p).detach().cpu().numpy().copy()
    lin = lambda m: {"w": arr(m.weight).T, "b": arr(m.bias)}
    G, D = models.generator, models.discriminator
    return {
        "params_g": {
            "blocks": [{"fc": lin(b.fc), "bn_scale": arr(b.bn.weight),
                        "bn_bias": arr(b.bn.bias)} for b in G.blocks],
            "out": lin(G.out)},
        "state_g": {"blocks": [
            {"mean": b.bn.running_mean.cpu().numpy().copy(),
             "var": b.bn.running_var.cpu().numpy().copy()}
            for b in G.blocks]},
        "params_d": {"layers": [lin(l) for l in D.layers], "out": lin(D.out)},
    }


def cond_from_jax(cond, spec: SegmentSpec) -> CondSampler:
    """The port's sampler, on the CPU, over a JAX ``CondSampler``'s
    tables (anything with ``p_train`` and ``p_empirical``)."""
    return CondSampler.from_tables(np.asarray(cond.p_train),
                                   np.asarray(cond.p_empirical), spec, "cpu")


# ----------------------------------------------------------- artifact read


class _StandIn:
    """Inert stand-in for a pickled JAX-package or sklearn object: keeps
    the constructor arguments and the pickled state, runs nothing."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs
        self.state = None

    def __setstate__(self, state):
        self.state = state


_SAFE_BUILTINS = {"set", "frozenset", "slice", "complex", "bytearray",
                  "tuple", "list", "dict"}


class _RemapUnpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._stand_ins: dict = {}

    def find_class(self, module, name):
        if module.split(".")[0] in ("fed_tgan_tpu", "sklearn"):
            key = f"{module}.{name}"
            if key not in self._stand_ins:
                self._stand_ins[key] = type(name, (_StandIn,), {"origin": key})
            return self._stand_ins[key]
        if (module.split(".")[0] == "numpy" or module == "copyreg"
                or (module == "builtins" and name in _SAFE_BUILTINS)):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load global {module}.{name}")


def _unpickle(path: str):
    with open(path, "rb") as f:
        return _RemapUnpickler(f).load()


def _state(obj) -> dict:
    if not isinstance(obj, _StandIn) or not isinstance(obj.state, dict):
        raise ValueError(f"unexpected pickled object {obj!r}")
    return obj.state


def _columns_from_transformer(transformer) -> list:
    """The ``ModeNormalizer``'s columns, reduced to their decode tables."""
    out = []
    for col in _state(transformer)["columns"]:
        st = _state(col)
        if type(col).__name__ == "ContinuousColumn":
            gmm = _state(st["gmm"])
            active = np.flatnonzero(np.asarray(gmm["active"], dtype=bool))
            out.append(ContinuousColumn(
                st["name"], np.asarray(gmm["means"], np.float64)[active],
                np.asarray(gmm["stds"], np.float64)[active]))
        elif type(col).__name__ == "DiscreteColumn":
            out.append(DiscreteColumn(st["name"], np.asarray(st["codes"])))
        else:
            raise ValueError(f"unknown transformer column {col.origin}")
    return out


def _pytrees_from_leaves(data, n_blocks: int):
    """``(params_g, state_g, (p_train, p_empirical))`` from the npz leaves.

    JAX flattens dicts in sorted key order (``bn_bias, bn_scale, fc.b,
    fc.w`` per block, then ``out.b, out.w``; ``mean, var`` per BN block)
    but a registered dataclass in its ``data_fields`` order: the sampler's
    ``p_train`` comes before ``p_empirical``."""
    leaves = iter(data[f"leaf_{i:05d}"] for i in range(len(data.files)))
    blocks = []
    for _ in range(n_blocks):
        bn_bias, bn_scale, fc_b, fc_w = (next(leaves) for _ in range(4))
        blocks.append({"bn_bias": bn_bias, "bn_scale": bn_scale,
                       "fc": {"b": fc_b, "w": fc_w}})
    out_b, out_w = next(leaves), next(leaves)
    params_g = {"blocks": blocks, "out": {"b": out_b, "w": out_w}}
    state_g = {"blocks": [{"mean": next(leaves), "var": next(leaves)}
                          for _ in range(n_blocks)]}
    p_train, p_empirical = next(leaves), next(leaves)
    return params_g, state_g, (p_train, p_empirical)


def _resolve_jax_artifact(root: str) -> tuple[str, str, str]:
    """``(synthesizer dir, meta path, encoder pickle path)`` of a JAX
    artifact; ``root`` is its out-dir, models dir or synthesizer dir."""
    root = os.path.abspath(root)
    for cand in (os.path.join(root, "models"), root, os.path.dirname(root)):
        synth = os.path.join(cand, "synthesizer")
        for meta in sorted(glob.glob(os.path.join(cand, "*.json")),
                           key=os.path.getmtime, reverse=True):
            stem = os.path.splitext(os.path.basename(meta))[0]
            enc = os.path.join(cand, f"label_encoders_{stem}.pickle")
            if os.path.isdir(synth) and os.path.exists(enc):
                return synth, meta, enc
    raise FileNotFoundError(f"no JAX synthesizer artifact under {root}")


def convert_jax_artifact(src_dir: str, dst_dir: str) -> str:
    """Convert the JAX artifact under ``src_dir`` into the port format
    under ``dst_dir/models``; returns ``dst_dir``.  The synthesizer is
    written last, after the meta and encoders, so the registry's
    meta-freshness check sees the healthy order."""
    synth_dir, meta_path, enc_path = _resolve_jax_artifact(src_dir)
    host = _unpickle(os.path.join(synth_dir, "host.pkl"))
    if host.get("kind") != "synthesizer":
        raise ValueError(f"{synth_dir} is not a synthesizer checkpoint")
    cfg = config_from_dict(_state(host["cfg"]))
    spec = SegmentSpec.from_output_info(host["output_info"])
    with np.load(os.path.join(synth_dir, "arrays.npz")) as data:
        params_g, state_g, (p_train, p_emp) = _pytrees_from_leaves(
            data, len(cfg.gen_dims))
    synth = SavedSynthesizer(
        generator_from_jax(params_g, state_g),
        CondSampler.from_tables(p_train, p_emp, spec, "cpu"),
        _columns_from_transformer(host["transformer"]), cfg,
        key_offset=host.get("key_offset", 17))

    models = os.path.join(dst_dir, "models")
    os.makedirs(models, exist_ok=True)
    name = os.path.splitext(os.path.basename(meta_path))[0]
    shutil.copyfile(meta_path, os.path.join(models, f"{name}.json"))
    encoders = [{"column_name": d["column_name"],
                 "classes": np.asarray(_state(d["label_encoder"])["classes_"],
                                       dtype=object).tolist()}
                for d in _unpickle(enc_path)]
    with open(os.path.join(models, f"label_encoders_{name}.json"), "w") as f:
        json.dump(encoders, f)
    save_synthesizer(synth, os.path.join(models, SYNTH_DIR))
    return dst_dir
