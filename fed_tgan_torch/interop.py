"""Conversion from the JAX package's artifacts and pytrees to the port.

- :func:`generator_from_jax`, :func:`discriminator_from_jax` and
  :func:`cond_from_jax` turn the JAX generator parameters / BatchNorm
  state, discriminator parameters and conditional-sampler tables (numpy or
  jax arrays) into the port's modules; :func:`bundle_from_jax` makes a
  trainable :class:`~fed_tgan_torch.train.steps.Models` from a JAX
  ``ModelBundle``, and :func:`params_to_jax_layout` maps the port's
  weights back to the JAX pytree layout;
- :func:`convert_jax_artifact` reads a JAX ``--save-model`` artifact
  (``synthesizer/host.pkl`` + ``arrays.npz``, meta JSON, encoder pickle,
  reference statistics) and writes the port's own format
  (:mod:`fed_tgan_torch.runtime.checkpoint`);
- :func:`convert_jax_checkpoint` turns a JAX ``save_federated`` training
  checkpoint into the port's, so a run trained in JAX resumes on the card,
  and a JAX multi-process participant's ``multihost_rank<r>.pkl`` into
  the port's per-rank checkpoint (:mod:`fed_tgan_torch.train.multihost`).

The JAX package is never imported: a pickle is read with an unpickler
that maps every ``fed_tgan_tpu.*``, ``optax.*`` and ``sklearn.*`` global
to an inert stand-in that only keeps its arguments and state.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import shutil
from types import SimpleNamespace

import numpy as np
import torch

from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import ColumnMeta, TableMeta
from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.features.bgm import ColumnGMM
from fed_tgan_torch.features.transformer import (
    ContinuousColumn,
    DiscreteColumn,
    ModeNormalizer,
)
from fed_tgan_torch.federation.init import FederatedInit
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


def _index(tree, i: int):
    """Slice ``i`` of the leading axis of every array in a nested
    dict/list pytree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return np.asarray(tree)[i]


def client_models_from_jax(stacked, spec: SegmentSpec, cfg: TrainConfig,
                           device="cuda") -> list:
    """Per-client :class:`Models` from a JAX ``ModelBundle`` whose leaves
    carry a leading client axis (``FederatedTrainer.models``), each with
    fresh optimizers, on ``device``."""
    n = np.shape(stacked.params_g["out"]["b"])[0]
    return [bundle_from_jax(SimpleNamespace(
        params_g=_index(stacked.params_g, i),
        state_g=_index(stacked.state_g, i),
        params_d=_index(stacked.params_d, i)), spec, cfg, device)
        for i in range(n)]


def gmm_from_jax(gmm) -> ColumnGMM:
    """The port's mixture from a JAX ``ColumnGMM`` fitted by its
    variational (jax) backend, which carries the posterior parameters
    ``predict_proba`` needs."""
    if getattr(gmm, "mean_precision", None) is None:
        raise ValueError("a JAX mixture without its variational posterior "
                         "(the sklearn backend) has no port counterpart")
    f = lambda name: np.asarray(getattr(gmm, name), dtype=np.float64)
    return ColumnGMM(means=f("means"), stds=f("stds"), weights=f("weights"),
                     active=np.asarray(gmm.active, dtype=bool),
                     mean_precision=f("mean_precision"), dof=f("dof"),
                     stick_a=f("stick_a"), stick_b=f("stick_b"))


def transformer_from_jax(tf) -> ModeNormalizer:
    """The port's ``ModeNormalizer`` with a JAX normalizer's columns."""
    out = ModeNormalizer(device="cpu")
    out.columns, out.gmms = [], []
    for col in tf.columns:
        if hasattr(col, "gmm"):
            gmm = gmm_from_jax(col.gmm)
            out.gmms.append(gmm)
            out.columns.append(ContinuousColumn(
                col.name, gmm.means[gmm.active], gmm.stds[gmm.active]))
        else:
            out.gmms.append(None)
            out.columns.append(DiscreteColumn(col.name, np.asarray(col.codes)))
    out._finalize()
    return out


def federated_init_from_jax(init) -> FederatedInit:
    """The port's :class:`FederatedInit` from a JAX one: meta, encoders,
    per-client transformers with their mixtures, encoded matrices,
    weights and similarity scores."""
    opt = lambda a: None if a is None else np.asarray(a)
    return FederatedInit(
        global_meta=TableMeta.from_json_dict(init.global_meta.to_json_dict()),
        encoders=[CategoryEncoder(classes_=np.asarray(e.classes_,
                                                      dtype=object))
                  for e in init.encoders],
        transformers=[transformer_from_jax(tf) for tf in init.transformers],
        client_matrices=[np.asarray(m, dtype=np.float32)
                         for m in init.client_matrices],
        weights=np.asarray(init.weights), jsd=np.asarray(init.jsd),
        wd=np.asarray(init.wd),
        rows_per_client=[int(r) for r in init.rows_per_client],
        jsd_raw=opt(init.jsd_raw), wd_raw=opt(init.wd_raw))


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
    """Inert stand-in for a pickled JAX-package, optax or sklearn object:
    keeps the constructor arguments (a named tuple's fields) and the
    pickled state, runs nothing."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


_SAFE_BUILTINS = {"set", "frozenset", "slice", "complex", "bytearray",
                  "tuple", "list", "dict"}


class _RemapUnpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._stand_ins: dict = {}

    def find_class(self, module, name):
        if module.split(".")[0] in ("fed_tgan_tpu", "sklearn", "optax"):
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
    # the canary's reference statistics have one JSON schema in both
    stats = os.path.join(os.path.dirname(meta_path),
                         f"reference_stats_{name}.json")
    if os.path.exists(stats):
        shutil.copyfile(stats, os.path.join(models, os.path.basename(stats)))
    return dst_dir


# ---------------------------------------------------------- checkpoints


def _namespace(obj):
    """A pickled JAX object as plain attributes: stand-ins become
    namespaces of their state, a pickled ``TableMeta`` becomes the
    port's."""
    if isinstance(obj, _StandIn):
        st = {k: _namespace(v) for k, v in _state(obj).items()}
        if obj.origin.endswith(".ColumnMeta"):
            return ColumnMeta(**st)
        if obj.origin.endswith(".TableMeta"):
            return TableMeta(**st)
        return SimpleNamespace(**st)
    if isinstance(obj, (list, tuple)):
        return [_namespace(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _namespace(v) for k, v in obj.items()}
    return obj


def _bundle_from_leaves(leaves, n_blocks: int, n_layers: int,
                        scheduled: bool, kind: str = "federated",
                        ema: bool = False) -> SimpleNamespace:
    """A JAX ``ModelBundle`` from its flattened leaves: ``params_g``,
    ``state_g``, ``params_d`` (sorted dict keys), then per optimizer the
    Adam ``count``, ``mu`` and ``nu`` trees and, for a decaying schedule,
    the schedule's own count; with ``ema`` the EMA's ``(params_g,
    state_g)`` after it.  ``kind="mdgan"`` reads an MD-GAN checkpoint's
    ``(GeneratorBundle(params, state, opt), DiscriminatorBundle(params,
    opt))`` into the same fields."""
    it = iter(leaves)
    take = lambda: next(it)

    def gen_tree():
        blocks = []
        for _ in range(n_blocks):
            bn_bias, bn_scale, fc_b, fc_w = take(), take(), take(), take()
            blocks.append({"bn_bias": bn_bias, "bn_scale": bn_scale,
                           "fc": {"b": fc_b, "w": fc_w}})
        out_b, out_w = take(), take()
        return {"blocks": blocks, "out": {"b": out_b, "w": out_w}}

    def dis_tree():
        layers = []
        for _ in range(n_layers):
            b, w = take(), take()
            layers.append({"b": b, "w": w})
        out_b, out_w = take(), take()
        return {"layers": layers, "out": {"b": out_b, "w": out_w}}

    def adam(tree):
        count, mu, nu = take(), tree(), tree()
        if scheduled:
            take()  # the schedule's count, equal to Adam's
        return count, mu, nu

    def state_tree():
        return {"blocks": [{"mean": take(), "var": take()}
                           for _ in range(n_blocks)]}

    if kind == "mdgan":
        params_g, state_g, opt_g = gen_tree(), state_tree(), adam(gen_tree)
        params_d, opt_d = dis_tree(), adam(dis_tree)
    else:
        params_g, state_g, params_d = gen_tree(), state_tree(), dis_tree()
        opt_g, opt_d = adam(gen_tree), adam(dis_tree)
    ema_trees = (gen_tree(), state_tree()) if ema else None
    if next(it, None) is not None:
        raise ValueError("the checkpoint holds more leaves than a "
                         f"{kind} checkpoint of this config")
    return SimpleNamespace(params_g=params_g, state_g=state_g,
                           params_d=params_d, opt_g=opt_g, opt_d=opt_d,
                           ema=ema_trees)


def _flat(module) -> torch.Tensor:
    """A module's parameters, flattened and joined in their order."""
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def _load_adam(stack, bundle: SimpleNamespace, cfg: TrainConfig) -> None:
    """The clients' optax Adam states (``count``, ``mu``, ``nu``, each
    with the client axis) onto the stacked optimizers (count, moments).
    The moments are laid out through the same converters as the weights
    (a Linear's ``w`` transposed)."""
    n = stack.n
    for opt, (count, mu, nu), as_module in (
            (stack.opt_g, bundle.opt_g,
             lambda t, i: generator_from_jax(t, _index(bundle.state_g, i))),
            (stack.opt_d, bundle.opt_d,
             lambda t, i: discriminator_from_jax(t, cfg.pac))):
        flat = [torch.stack([torch.cat([p.detach().reshape(-1) for p in
                                        as_module(_index(tree, i), i)
                                        .parameters()]) for i in range(n)])
                for tree in (mu, nu)]
        if flat[0].shape != opt.exp_avg.shape:
            raise ValueError("Adam moments do not match the parameters")
        opt.load(np.asarray(count).astype(np.int64), *flat)


def convert_jax_checkpoint(src_dir: str, dst_dir: str) -> str:
    """Convert the JAX ``save_federated`` checkpoint in ``src_dir`` into a
    port checkpoint in ``dst_dir`` (:func:`~fed_tgan_torch.runtime.
    checkpoint.load_federated` loads it); returns ``dst_dir``.

    Carried over: the ``FederatedInit``; every client's parameters and
    BatchNorm state (:func:`client_models_from_jax`); its optax Adam
    ``mu`` / ``nu`` / ``count`` as torch's ``exp_avg`` / ``exp_avg_sq`` /
    ``step``, with the LR schedule at that count; the generator EMA and
    its update count; the weights, quarantine strikes, dropped clients,
    round counter and round times.  A JAX ``mdgan`` checkpoint becomes an
    :class:`~fed_tgan_torch.train.mdgan.MDGANTrainer` checkpoint: the
    shared generator, its Adam, every client's discriminator and Adam.
    Not carried over: the JAX key chain.  A threefry key has no torch
    counterpart, so each client's ``torch.Generator`` starts from
    ``step_seed(seed, client)`` as in a fresh port trainer, and the
    resumed run draws other numbers than the JAX run would have: other
    step draws, and other cohorts (the port derives a round's cohort from
    ``(seed, round)``, JAX from its key chain).  An elastic checkpoint
    keeps its ``capacity`` (every slot's models and Adam state, padded
    ones included).

    ``src_dir`` may also be a JAX participant's ``multihost_rank<r>.pkl``
    (:func:`_convert_multihost`); ``dst_dir`` is then the port run's
    checkpoint directory, and the per-rank checkpoint is written to
    ``dst_dir/multihost_rank<r>``, whose path is returned."""
    from fed_tgan_torch.runtime.checkpoint import save_federated

    if os.path.isfile(src_dir):
        return _convert_multihost(src_dir, dst_dir)
    host = _unpickle(os.path.join(src_dir, "host.pkl"))
    kind = host.get("kind")
    if kind not in ("federated", "mdgan"):
        raise ValueError(f"{src_dir} is not a JAX federated checkpoint")
    cfg = config_from_dict(_state(host["cfg"]))
    init = federated_init_from_jax(_namespace(host["init"]))
    spec = SegmentSpec.from_output_info(init.output_info)
    with np.load(os.path.join(src_dir, "arrays.npz")) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        bundle = _bundle_from_leaves(
            [data[f"leaf_{i:05d}"] for i in range(n)], len(cfg.gen_dims),
            len(cfg.dis_dims), cfg.lr_schedule != "constant", kind,
            ema=bool(host.get("ema")))
    trainer = (_mdgan_from_jax(init, cfg, host, bundle, spec)
               if kind == "mdgan"
               else _federated_from_jax(init, cfg, host, bundle, spec))
    trainer.completed_epochs = int(host["completed_epochs"])
    trainer.epoch_times = [float(t) for t in host["epoch_times"]]
    for k, v in (host.get("phase_times") or {}).items():
        if k in trainer.phase_times:
            trainer.phase_times[k] = [float(t) for t in v]
    save_federated(trainer, dst_dir, run_name=host.get("run_name"))
    return dst_dir


def _federated_from_jax(init, cfg, host, bundle, spec):
    from fed_tgan_torch.train.federated import FederatedTrainer

    trainer = FederatedTrainer(
        init, cfg, seed=host["seed"], device="cpu",
        models=client_models_from_jax(bundle, spec, cfg, "cpu"),
        capacity=int(host.get("capacity") or 0))
    _load_adam(trainer.stack, bundle, cfg)
    if bundle.ema is not None:
        params_g, state_g = bundle.ema
        gen = generator_from_jax(params_g, state_g)
        trainer.ema[0].copy_(_flat(gen))
        trainer.ema[1].copy_(torch.cat([
            t for b in gen.blocks for t in (b.bn.running_mean,
                                            b.bn.running_var)]))
        trainer._ema_updates = int(host.get("ema_updates", 0))
    trainer.weights = np.asarray(host["weights"], dtype=np.float32)
    trainer._strikes = np.asarray(host["strikes"], dtype=np.int64)
    trainer.dropped_clients = {int(i) for i in host.get("dropped_clients")
                               or ()}
    trainer.steps = np.where(trainer._alive(), trainer.steps, 0)
    return trainer


def _mdgan_from_jax(init, cfg, host, bundle, spec):
    """An ``MDGANTrainer`` holding a JAX MD-GAN checkpoint's state: the
    shared generator (no client axis) and its Adam, the stacked
    discriminators and theirs."""
    from fed_tgan_torch.train.mdgan import MDGANTrainer

    n = np.shape(bundle.params_d["out"]["b"])[0]
    trainer = MDGANTrainer(init, cfg, seed=host["seed"], device="cpu",
                           models=Models.build(
                               generator_from_jax(bundle.params_g,
                                                  bundle.state_g),
                               discriminator_from_jax(
                                   _index(bundle.params_d, 0), cfg.pac),
                               spec, cfg))
    dis = [discriminator_from_jax(_index(bundle.params_d, i), cfg.pac)
           for i in range(n)]
    trainer.disc.stack.load_state_dicts([d.state_dict() for d in dis])
    count, mu, nu = bundle.opt_g
    trainer.gen.opt.load(np.asarray(count).reshape(1).astype(np.int64), *(
        _flat(generator_from_jax(t, bundle.state_g))[None] for t in (mu, nu)))
    count, mu, nu = bundle.opt_d
    trainer.disc.opt.load(np.asarray(count).astype(np.int64), *(
        torch.stack([_flat(discriminator_from_jax(_index(t, i), cfg.pac))
                     for i in range(n)]) for t in (mu, nu)))
    return trainer


def _jax_leaves(obj) -> list:
    """The leaves of an unpickled JAX pytree in ``jax.tree.leaves`` order:
    dicts by sorted key, sequences and named tuples (stand-ins) in
    order."""
    if isinstance(obj, (np.ndarray, np.generic)):
        return [obj]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _jax_leaves(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _jax_leaves(v)]
    if isinstance(obj, _StandIn):
        return _jax_leaves(list(obj.args))
    if obj is None:
        return []
    raise ValueError(f"unexpected pytree node {obj!r}")


def _config_from_signature(sig: str) -> TrainConfig:
    """A ``TrainConfig`` from the JAX package's ``config_signature``
    (``TrainConfig(field=value, ...)``, defaults omitted)."""
    import ast

    call = ast.parse(sig, mode="eval").body
    if not isinstance(call, ast.Call):
        raise ValueError(f"not a config signature: {sig!r}")
    return config_from_dict({kw.arg: ast.literal_eval(kw.value)
                             for kw in call.keywords})


def _convert_multihost(src: str, ckpt_dir: str) -> str:
    """A JAX ``multihost_rank<r>.pkl`` (one participant's post-aggregation
    models, Adam states, key chain, optional raw EMA) as the port's
    per-rank checkpoint under ``ckpt_dir``.  The key chain does not carry
    over: the rank's generator is reseeded from ``(seed, client,
    round)``, as :func:`~fed_tgan_torch.runtime.checkpoint.load_federated`
    reseeds on a device move."""
    from fed_tgan_torch.models.ctgan import (
        StackedDiscriminator,
        StackedGenerator,
    )
    from fed_tgan_torch.serve.engine import step_seed
    from fed_tgan_torch.train.multihost import (
        MultihostRun,
        _save_participant,
    )
    from fed_tgan_torch.train.steps import StackedAdam

    state = _unpickle(src)
    cfg = _config_from_signature(state["config"])
    rank, seed, done = int(state["rank"]), int(state["seed"]), int(
        state["epochs_done"])
    bundle = _bundle_from_leaves(
        _jax_leaves(state["models"]), len(cfg.gen_dims), len(cfg.dis_dims),
        cfg.lr_schedule != "constant")
    G = StackedGenerator.from_modules([generator_from_jax(bundle.params_g,
                                                          bundle.state_g)])
    D = StackedDiscriminator.from_modules([discriminator_from_jax(
        bundle.params_d, cfg.pac)])
    opts = []
    for params, (count, mu, nu), as_module in (
            (G.params, bundle.opt_g,
             lambda t: generator_from_jax(t, bundle.state_g)),
            (D.params, bundle.opt_d,
             lambda t: discriminator_from_jax(t, cfg.pac))):
        opt = StackedAdam(params, cfg)
        opt.load(np.asarray(count).reshape(1).astype(np.int64),
                 *(_flat(as_module(t))[None] for t in (mu, nu)))
        opts.append(opt)
    stack = SimpleNamespace(generator=G, discriminator=D, opt_g=opts[0],
                            opt_d=opts[1])
    ema = None
    if state.get("ema") is not None:
        gen = generator_from_jax(*state["ema"])
        ema = [_flat(gen), torch.cat([t for b in gen.blocks for t in (
            b.bn.running_mean, b.bn.running_var)])]
    rng = torch.Generator().manual_seed(step_seed(step_seed(seed, rank - 1),
                                                  done))
    run = MultihostRun(epochs=done, seed=seed, ckpt_dir=ckpt_dir)
    _save_participant(run, rank, stack, rng, ema, done, done,
                      int(state["n_clients"]), cfg)
    return os.path.join(ckpt_dir, f"multihost_rank{rank}")
