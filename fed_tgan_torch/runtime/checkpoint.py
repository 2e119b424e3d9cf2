"""The port's sampling artifact: a directory with no pickles.

``<models>/synthesizer_torch/`` holds

- ``config.json``: format version, the ``TrainConfig`` fields (its
  ``precision`` among them), ``output_info``, ``key_offset`` and the
  column list (name, kind);
- ``weights.npz``: the generator's ``state_dict`` (``generator.*``), the
  conditional sampler tables (``cond.p_train``, ``cond.p_empirical``) and
  the decode tables (``col_NNNNN.means`` / ``.stds`` or ``.codes``).

The meta JSON (``<name>.json``) and ``label_encoders_<name>.json`` sit
beside the directory.  Counterpart of the JAX ``save_synthesizer`` /
``load_synthesizer`` (``fed_tgan_tpu/runtime/checkpoint.py:398-498``),
whose ``host.pkl`` + ``arrays.npz`` artifacts :mod:`fed_tgan_torch.interop`
converts into this format.

Federated training checkpoints (:func:`save_federated` /
:func:`load_federated`, counterpart of
``fed_tgan_tpu/runtime/checkpoint.py:64-395``) are pickle-free too:

- ``host.json``: format version, the ``TrainConfig``, seed, round counter,
  round times, weights, quarantine strikes, dropped clients, ``run_name``,
  the trainer's options (the elastic ``capacity`` among them, as JAX
  keeps it: a resumed elastic run rebuilds the same padded stacks), and
  the ``FederatedInit``'s meta, encoders, column layout and onboarding
  indices;
- ``arrays.npz``: the ``FederatedInit``'s arrays (client matrices,
  mixtures, scores, the onboarding references) and per slot (every
  client, then an elastic trainer's padded slots) its generator and
  discriminator ``state_dict`` (BatchNorm running statistics included),
  both Adam states, and the state of its ``torch.Generator``; with
  ``ema_decay`` > 0 the generator EMA (``ema.params``, ``ema.state``)
  and its update count.  An MD-GAN trainer saves as kind
  ``mdgan_torch``: the shared generator and its Adam, the stacked
  discriminators and theirs, each client's generator state.

A loaded trainer continues bit for bit where the saved one stood, in the
checkpoint's precision (its ``TrainConfig`` wins over the caller's, as in
the JAX package, whose ``load_federated`` rebuilds the trainer from the
checkpointed config alone).  Saves
are crash-safe: staged in a sibling temp directory, every file fsynced,
then a ``COMPLETE`` marker, then published by atomic renames that rotate
the previous checkpoints to ``<path>.1`` ... ``<path>.K-1``; a crash at any
point leaves the newest earlier checkpoint loadable, and
:func:`find_resumable` finds it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
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
from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.obs.registry import counter as _metric_counter
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.precision import resolve_precision
from fed_tgan_torch.testing.faults import FaultInjected, active_plan
from fed_tgan_torch.train.sampler import CondSampler
from fed_tgan_torch.train.steps import TrainConfig

SYNTH_DIR = "synthesizer_torch"
FORMAT_VERSION = 1
_CONFIG = "config.json"
_WEIGHTS = "weights.npz"
FEDERATED_VERSION = 1
_HOST = "host.json"
_ARRAYS = "arrays.npz"
_MARKER = "COMPLETE"
_GMM_FIELDS = ("means", "stds", "weights", "active", "mean_precision", "dof",
               "stick_a", "stick_b")

log = logging.getLogger("fed_tgan_torch.checkpoint")

_CKPT_SAVES = _metric_counter(
    "fed_tgan_checkpoints_saved_total", "crash-safe checkpoints published")
_CKPT_RESTORES = _metric_counter(
    "fed_tgan_checkpoints_restored_total", "checkpoints loaded for resume")


class SavedSynthesizer:
    """Everything sampling needs: eval-mode generator, conditional
    sampler, decode columns, config, layout and the sampling-key offset
    of the model's source (so a converted artifact keeps its stream).
    The generator's weights are float32 in either precision; a bf16
    model (``cfg.precision``) samples in bf16 (:attr:`compute_dtype`)."""

    def __init__(self, generator: Generator, cond: CondSampler, columns: list,
                 cfg: TrainConfig, key_offset: int = 17):
        self.compute_dtype = resolve_precision(cfg.precision).compute_dtype
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
    _snapshot_fault_hook(path)


def _snapshot_fault_hook(path: str) -> None:
    """After a publish: the active fault plan's ``degrade_snapshot`` may
    degrade the published artifact in place (a no-op without one)."""
    from fed_tgan_torch.testing.faults import active_plan

    plan = active_plan()
    if plan is not None:
        plan.on_snapshot_publish(path)


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


def is_valid_synthesizer(path: str) -> bool:
    """Both files of a :func:`save_synthesizer` directory present and
    readable: the serving registry's probe before it loads a newly
    published artifact (a torn or half-copied one fails it)."""
    try:
        with open(os.path.join(path, _CONFIG)) as f:
            if json.load(f).get("kind") != "synthesizer_torch":
                return False
        with np.load(os.path.join(path, _WEIGHTS)) as data:
            _ = data.files
        return True
    except Exception:
        return False


# ------------------------------------------------------ crash-safe writes


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _stage_dir(path: str) -> str:
    """A fresh sibling temp directory to stage a save in; stages left by
    earlier crashed writers are swept (one writer per path)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    base = os.path.basename(path)
    for entry in os.listdir(parent):
        if entry.startswith(f"{base}.tmp-"):
            shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp)
    return tmp


def _seal_dir(tmp: str) -> None:
    """Marker, then a directory fsync: after this ``tmp`` is a valid
    checkpoint."""
    with open(os.path.join(tmp, _MARKER), "wb") as f:
        _fsync_file(f)
    _fsync_dir(tmp)


def _publish_dir(tmp: str, path: str, keep: int) -> None:
    """Atomically publish the sealed ``tmp`` as ``path``, rotating the
    previous checkpoint into ``path.1`` ... ``path.{keep-1}``.  The oldest
    generation passes through ``path.{keep}`` and is removed once the new
    one is in place (the JAX package leaves it there until the next
    save, so it holds keep + 1 generations between saves)."""
    keep = max(1, int(keep))
    doomed = f"{path}.{keep}"
    if os.path.isdir(doomed):
        shutil.rmtree(doomed)
    for i in range(keep - 1, 0, -1):
        src = f"{path}.{i}"
        if os.path.isdir(src):
            os.replace(src, f"{path}.{i + 1}")
    if os.path.isdir(path):
        os.replace(path, f"{path}.1")
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    if os.path.isdir(doomed):
        shutil.rmtree(doomed)


def _is_valid_checkpoint(path: str) -> bool:
    """Both payload files present and readable.  The ``COMPLETE`` marker
    is not required, as in the JAX package."""
    try:
        with open(os.path.join(path, _HOST)) as f:
            json.load(f)
        with np.load(os.path.join(path, _ARRAYS)) as data:
            _ = data.files
        return True
    except Exception:
        return False


def list_resumable(path: str, max_rotations: int = 8) -> list[str]:
    """Every valid checkpoint generation at ``path``, newest first: the
    primary, then the rotation slots ``path.1`` ...  The watchdog walks
    this list when the newest generation holds already-poisoned state."""
    candidates = [path] + [f"{path}.{i}" for i in range(1, max_rotations + 1)]
    return [c for c in candidates
            if os.path.isdir(c) and _is_valid_checkpoint(c)]


def find_resumable(path: str, max_rotations: int = 8) -> str | None:
    """The newest valid checkpoint at ``path`` or its rotation slots (a
    crash can leave the primary slot torn while an older one is intact);
    None when nothing loadable exists."""
    gens = list_resumable(path, max_rotations)
    if gens and gens[0] != path:
        log.warning("checkpoint: primary %s unusable, resuming from %s",
                    path, gens[0])
    return gens[0] if gens else None


def _fault_hook(path: str) -> None:
    """The mid-write fault-injection point (nothing without a plan)."""
    plan = active_plan()
    if plan is not None:
        plan.on_checkpoint_write(path)


# ------------------------------------------------------------- federated


def _init_parts(init) -> tuple[dict, dict]:
    """A ``FederatedInit`` as (JSON-able dict, arrays)."""
    host = {
        "global_meta": init.global_meta.to_json_dict(),
        "encoders": [e.to_dict() for e in init.encoders],
        "columns": [[[c.name, "cont" if isinstance(c, ContinuousColumn)
                      else "disc"] for c in tf.columns]
                    for tf in init.transformers],
        "rows_per_client": [int(r) for r in init.rows_per_client],
        "timings": {k: float(v) for k, v in init.timings.items()},
    }
    arrays = {f"init.matrix_{i:03d}": np.asarray(m, dtype=np.float32)
              for i, m in enumerate(init.client_matrices)}
    for name in ("weights", "jsd", "wd", "jsd_raw", "wd_raw"):
        if getattr(init, name) is not None:
            arrays[f"init.{name}"] = np.asarray(getattr(init, name))
    ob = init.onboarding
    if ob is not None:
        host["onboarding"] = {k: ob[k] for k in ("cont_idx", "cat_idx",
                                                 "params")}
        host["onboarding"]["n_cat_counts"] = len(ob["cat_counts"])
        for k in ("mix_means", "mix_stds", "mix_weights"):
            arrays[f"init.ob.{k}"] = np.asarray(ob[k])
        for c, vec in enumerate(ob["cat_counts"]):
            arrays[f"init.ob.cat_counts{c}"] = np.asarray(vec)
    for i, tf in enumerate(init.transformers):
        for j, (col, gmm) in enumerate(zip(tf.columns, tf.gmms)):
            key = f"init.tf_{i:03d}.col_{j:05d}"
            if gmm is None:
                arrays[f"{key}.codes"] = np.asarray(col.codes)
            else:
                for field in _GMM_FIELDS:
                    arrays[f"{key}.{field}"] = np.asarray(getattr(gmm, field))
    return host, arrays


def _init_from(host: dict, data):
    """The ``FederatedInit`` of :func:`_init_parts` output."""
    from fed_tgan_torch.data.encoders import CategoryEncoder
    from fed_tgan_torch.data.schema import TableMeta
    from fed_tgan_torch.features.bgm import ColumnGMM
    from fed_tgan_torch.features.transformer import ModeNormalizer
    from fed_tgan_torch.federation.init import FederatedInit

    transformers = []
    for i, cols in enumerate(host["columns"]):
        tf = ModeNormalizer(device="cpu")
        for j, (name, kind) in enumerate(cols):
            key = f"init.tf_{i:03d}.col_{j:05d}"
            if kind == "disc":
                tf.gmms.append(None)
                tf.columns.append(DiscreteColumn(name, data[f"{key}.codes"]))
                continue
            gmm = ColumnGMM(**{f: data[f"{key}.{f}"] for f in _GMM_FIELDS})
            tf.gmms.append(gmm)
            tf.columns.append(ContinuousColumn(
                name, gmm.means[gmm.active], gmm.stds[gmm.active]))
        tf._finalize()
        transformers.append(tf)
    opt = lambda k: data[k] if k in data.files else None
    onboarding = None
    if "onboarding" in host:
        ob = host["onboarding"]
        onboarding = {
            "jsd_raw": data["init.jsd_raw"], "wd_raw": data["init.wd_raw"],
            "cat_counts": [data[f"init.ob.cat_counts{c}"]
                           for c in range(ob["n_cat_counts"])],
            **{k: data[f"init.ob.{k}"]
               for k in ("mix_means", "mix_stds", "mix_weights")},
            "cont_idx": list(ob["cont_idx"]), "cat_idx": list(ob["cat_idx"]),
            "params": dict(ob["params"])}
    return FederatedInit(
        global_meta=TableMeta.from_json_dict(host["global_meta"]),
        encoders=[CategoryEncoder.from_dict(e) for e in host["encoders"]],
        transformers=transformers,
        client_matrices=[data[f"init.matrix_{i:03d}"]
                         for i in range(len(transformers))],
        weights=data["init.weights"], jsd=data["init.jsd"],
        wd=data["init.wd"], rows_per_client=list(host["rows_per_client"]),
        jsd_raw=opt("init.jsd_raw"), wd_raw=opt("init.wd_raw"),
        timings=dict(host["timings"]), onboarding=onboarding)


def save_federated(trainer, path: str, run_name: str | None = None,
                   keep: int = 1) -> None:
    """Write a full-resume checkpoint of a port ``FederatedTrainer`` to
    the directory ``path``; ``run_name`` (the run's output identity) rides
    along.  Crash-safe (see the module docstring); ``keep`` > 1 retains
    the previous K-1 checkpoints as ``path.1`` ...  An
    :class:`~fed_tgan_torch.train.mdgan.MDGANTrainer` is saved as kind
    ``mdgan_torch`` (:func:`_mdgan_parts`)."""
    init_host, arrays = _init_parts(trainer.init)
    if hasattr(trainer, "gen"):
        host = _mdgan_parts(trainer, arrays)
        host.update(init=init_host, run_name=run_name)
        return _saved(path, host, arrays, keep)
    n_done = len(trainer.epoch_times)
    stack = trainer.stack
    parts = (("generator", stack.generator.state_dicts()),
             ("discriminator", stack.discriminator.state_dicts()))
    adam = [(name, opt, [t.cpu().numpy() for t in (
        opt.count, opt.exp_avg, opt.exp_avg_sq)], module)
        for name, opt, module in (("opt_g", stack.opt_g, stack.generator),
                                  ("opt_d", stack.opt_d,
                                   stack.discriminator))]
    clients = []
    for i in range(stack.n):  # every slot: the clients, then the padding
        pre = f"client_{i:03d}"
        for part, states in parts:
            for k, v in states[i].items():
                arrays[f"{pre}.{part}.{k}"] = v
        entry = {"rng_device": trainer.gens[i].device.type}
        # torch Adam's state_dict layout: per parameter index its step and
        # moments, none before the first update
        for part, opt, (count, mom, sq), module in adam:
            n = int(count[i])
            if n:
                split = np.cumsum(module.sizes)[:-1]
                for idx, (m, v, (_, shape)) in enumerate(zip(
                        np.split(mom[i], split), np.split(sq[i], split),
                        module.shapes)):
                    arrays[f"{pre}.{part}.{idx}.step"] = np.asarray(
                        float(n), dtype=np.float32)
                    arrays[f"{pre}.{part}.{idx}.exp_avg"] = m.reshape(shape)
                    arrays[f"{pre}.{part}.{idx}.exp_avg_sq"] = v.reshape(shape)
            entry[part] = {"lr": opt.lr(n), "sched_step": n}
        arrays[f"{pre}.rng"] = trainer.gens[i].get_state().numpy()
        clients.append(entry)
    host = {
        "version": FEDERATED_VERSION,
        "kind": "federated_torch",
        "cfg": config_to_dict(trainer.cfg),
        "seed": trainer.seed,
        "capacity": trainer.capacity if trainer.elastic else 0,
        "min_clients": trainer.min_clients,
        "quarantine_strikes": trainer.quarantine_strikes,
        "decode": trainer.decode.mode,
        "completed_epochs": trainer.completed_epochs,
        "epoch_times": list(trainer.epoch_times),
        # a save inside the hook sees the round's train phase but not its
        # total: keep only completed rounds
        "phase_times": {k: list(v)[:n_done]
                        for k, v in trainer.phase_times.items()},
        "weights": [float(w) for w in trainer.weights],
        "strikes": [int(s) for s in trainer._strikes],
        "dropped_clients": sorted(int(i) for i in trainer.dropped_clients),
        "run_name": run_name,
        "clients": clients,
        "init": init_host,
        # the generator EMA (cfg.ema_decay > 0) and its update count
        "ema_updates": trainer._ema_updates,
    }
    if trainer.ema is not None:
        arrays["ema.params"], arrays["ema.state"] = (
            t.cpu().numpy() for t in trainer.ema)
    _saved(path, host, arrays, keep)


def _saved(path: str, host: dict, arrays: dict, keep: int) -> None:
    """Write a trainer's checkpoint, then count and journal it."""
    _write_checkpoint(path, host, arrays, keep)
    _CKPT_SAVES.inc()
    _emit_event("checkpoint", path=str(path), kind=host["kind"],
                round=int(host["completed_epochs"]), keep=int(keep))


def _write_checkpoint(path: str, host: dict, arrays: dict,
                      keep: int) -> None:
    """Stage ``host.json`` and ``arrays.npz``, seal, publish."""
    tmp = _stage_dir(path)
    try:
        with open(os.path.join(tmp, _HOST), "w") as f:
            json.dump(host, f)
            _fsync_file(f)
        _fault_hook(path)  # a simulated crash: tmp is partial, path untouched
        with open(os.path.join(tmp, _ARRAYS), "wb") as f:
            np.savez(f, **arrays)
            _fsync_file(f)
        _seal_dir(tmp)
    except BaseException as exc:
        # an injected fault stands for a hard crash: its partial stage
        # stays on disk, as kill -9 would leave it
        if not isinstance(exc, FaultInjected):
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    _publish_dir(tmp, path, keep)


def _restored(path: str, host: dict, trainer):
    """Count and journal a loaded checkpoint; returns ``trainer``."""
    _CKPT_RESTORES.inc()
    _emit_event("checkpoint_restore", path=str(path), kind=host["kind"],
                round=int(trainer.completed_epochs))
    return trainer


def load_federated(path: str, device="cuda"):
    """A ``FederatedTrainer`` on ``device`` rebuilt from
    :func:`save_federated` output: the trainer is constructed from the
    checkpointed ``FederatedInit`` and options, then every client's
    weights, BatchNorm state, Adam state, learning-rate schedule and
    generator state, the round counter and the membership are restored.

    A checkpoint loads on either device.  A ``torch.Generator``'s state
    belongs to its device type, so on the other type each client's
    generator is reseeded from ``(seed, client, round)``: the run goes on,
    with other draws."""
    from fed_tgan_torch.serve.engine import step_seed
    from fed_tgan_torch.train.federated import FederatedTrainer

    device = resolve_device(device)
    with open(os.path.join(path, _HOST)) as f:
        host = json.load(f)
    if host.get("kind") not in ("federated_torch", "mdgan_torch"):
        raise ValueError(f"{path} is not a port federated checkpoint")
    if host["version"] > FEDERATED_VERSION:
        raise ValueError(f"checkpoint version {host['version']} is newer "
                         f"than supported {FEDERATED_VERSION}")
    if host["kind"] == "mdgan_torch":
        return _restored(path, host, _load_mdgan(path, host, device))
    with np.load(os.path.join(path, _ARRAYS)) as data:
        trainer = FederatedTrainer(
            _init_from(host["init"], data), config_from_dict(host["cfg"]),
            seed=host["seed"], min_clients=host["min_clients"],
            quarantine_strikes=host["quarantine_strikes"], device=device,
            decode=host["decode"], capacity=host.get("capacity", 0))
        done = host["completed_epochs"]
        stack = trainer.stack
        for part, module in (("generator", stack.generator),
                             ("discriminator", stack.discriminator)):
            names = list(module.client_state(0))
            module.load_state_dicts([
                {k: data[f"client_{i:03d}.{part}.{k}"] for k in names}
                for i in range(stack.n)])
        for part, opt, module in (("opt_g", stack.opt_g, stack.generator),
                                  ("opt_d", stack.opt_d,
                                   stack.discriminator)):
            counts, moments = [], []
            for i, entry in enumerate(host["clients"]):
                pre = f"client_{i:03d}.{part}"
                counts.append(int(entry[part]["sched_step"]))
                moments.append([np.concatenate([
                    data[f"{pre}.{idx}.{key}"].reshape(-1)
                    if f"{pre}.{idx}.{key}" in data.files
                    else np.zeros(size, np.float32)
                    for idx, size in enumerate(module.sizes)])
                    for key in ("exp_avg", "exp_avg_sq")])
            opt.load(np.asarray(counts), *(np.stack(m) for m in
                                           zip(*moments)))
        for i, entry in enumerate(host["clients"]):
            pre = f"client_{i:03d}"
            if entry["rng_device"] == device.type:
                trainer.gens[i].set_state(torch.as_tensor(data[f"{pre}.rng"]))
            else:
                log.warning("client %d: generator state saved on %s, loaded "
                            "on %s; reseeded", i, entry["rng_device"],
                            device.type)
                trainer.gens[i].manual_seed(
                    step_seed(step_seed(trainer.seed, i), done))
        if trainer.ema is not None:
            if "ema.params" not in data.files:
                raise ValueError(f"{path}: cfg.ema_decay > 0 but the "
                                 "checkpoint carries no EMA")
            for t, key in zip(trainer.ema, ("ema.params", "ema.state")):
                t.copy_(torch.as_tensor(data[key]))
            trainer._ema_updates = int(host.get("ema_updates", 0))
    trainer.completed_epochs = done
    trainer.epoch_times = list(host["epoch_times"])
    for k, v in host["phase_times"].items():
        trainer.phase_times[k] = list(v)
    trainer.weights = np.asarray(host["weights"], dtype=np.float32)
    trainer._strikes = np.asarray(host["strikes"], dtype=np.int64)
    trainer.dropped_clients = set(host["dropped_clients"])
    trainer.steps = np.where(trainer._alive(), trainer.steps, 0)
    trainer.run_name = host["run_name"]
    return _restored(path, host, trainer)


def _mdgan_parts(trainer, arrays: dict) -> dict:
    """An MD-GAN trainer's state into ``arrays`` (the shared generator's
    flat weights, running statistics, batch count and Adam; the stacked
    discriminators and their Adam; each client's generator state); returns
    its host fields (``fed_tgan_tpu/runtime/checkpoint.py:225-356``, kind
    ``mdgan``)."""
    for name, bundle, params in (("gen", trainer.gen, trainer.gen.params),
                                 ("disc", trainer.disc,
                                  trainer.disc.stack.params)):
        arrays[f"{name}.params"] = params.detach().cpu().numpy()
        for key in ("count", "exp_avg", "exp_avg_sq", "grad"):
            arrays[f"{name}.opt.{key}"] = getattr(bundle.opt,
                                                  key).cpu().numpy()
    arrays["gen.state"] = trainer.gen.state.cpu().numpy()
    arrays["gen.batches"] = trainer.gen.batches.cpu().numpy()
    for i, g in enumerate(trainer.gens):
        arrays[f"client_{i:03d}.rng"] = g.get_state().numpy()
    n_done = len(trainer.epoch_times)
    return {
        "version": FEDERATED_VERSION, "kind": "mdgan_torch",
        "cfg": config_to_dict(trainer.cfg), "seed": trainer.seed,
        "decode": trainer.decode.mode,
        "completed_epochs": trainer.completed_epochs,
        "epoch_times": list(trainer.epoch_times),
        "phase_times": {k: list(v)[:n_done]
                        for k, v in trainer.phase_times.items()},
        "rng_device": trainer.device.type,
    }


def _load_mdgan(path: str, host: dict, device):
    """An ``MDGANTrainer`` rebuilt from :func:`_mdgan_parts`' output."""
    from fed_tgan_torch.serve.engine import step_seed
    from fed_tgan_torch.train.mdgan import MDGANTrainer

    with np.load(os.path.join(path, _ARRAYS)) as data:
        trainer = MDGANTrainer(
            _init_from(host["init"], data), config_from_dict(host["cfg"]),
            seed=host["seed"], device=device, decode=host["decode"])
        done = host["completed_epochs"]
        with torch.no_grad():
            for name, bundle, params in (
                    ("gen", trainer.gen, trainer.gen.params),
                    ("disc", trainer.disc, trainer.disc.stack.params)):
                params.copy_(torch.as_tensor(data[f"{name}.params"]))
                for key in ("count", "exp_avg", "exp_avg_sq", "grad"):
                    getattr(bundle.opt, key).copy_(
                        torch.as_tensor(data[f"{name}.opt.{key}"]))
            trainer.gen.state.copy_(torch.as_tensor(data["gen.state"]))
            trainer.gen.batches.copy_(torch.as_tensor(data["gen.batches"]))
        for i, g in enumerate(trainer.gens):
            if host["rng_device"] == device.type:
                g.set_state(torch.as_tensor(data[f"client_{i:03d}.rng"]))
            else:
                log.warning("client %d: generator state saved on %s, loaded "
                            "on %s; reseeded", i, host["rng_device"],
                            device.type)
                g.manual_seed(step_seed(step_seed(trainer.seed, i), done))
    trainer.completed_epochs = done
    trainer.epoch_times = list(host["epoch_times"])
    for k, v in host["phase_times"].items():
        trainer.phase_times[k] = list(v)
    trainer.run_name = host["run_name"]
    return trainer
