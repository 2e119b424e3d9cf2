"""Intrusion-shaped demo data: a random-weight artifact and a training table.

- :func:`build_random_artifact` writes a full-width Intrusion-shaped
  artifact with random weights.
- :func:`intrusion_like_table` makes an Intrusion-shaped numeric training
  table, with its meta and encoders, without pandas.

The artifact's layout is what the JAX package's ``ModeNormalizer(backend="sklearn",
seed=0)`` fits to the Intrusion-shaped stand-in table of
``tests/test_workloads.py::_intrusion_like(4000, seed=0)`` (the reference
Intrusion dataset's 42 columns, 22 continuous and 20 categorical): 282
encoded dims in 64 segments.  It is recorded here as a constant, with the
matching meta and encoders, so an artifact of that shape can be built
where neither the data nor a trained model exists.  The weights are
random: default-initialised generator, random BatchNorm running
statistics, mode tables and conditional tables, all from ``seed``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import ColumnMeta, TableMeta
from fed_tgan_torch.features.transformer import (
    ContinuousColumn,
    DiscreteColumn,
    output_info,
)
from fed_tgan_torch.models.ctgan import Generator
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.checkpoint import (
    SYNTH_DIR,
    SavedSynthesizer,
    save_synthesizer,
)
from fed_tgan_torch.train.sampler import CondSampler
from fed_tgan_torch.train.steps import TrainConfig

_BINARY = ("0", "1")

# (name, number of active modes) for a continuous column, (name, categories
# in frequency order) for a categorical one; meta column order
INTRUSION_COLUMNS = (
    ("duration", 6), ("protocol_type", ("icmp", "udp", "tcp")),
    ("service", ("http", "ftp", "smtp", "dns")), ("flag", ("SF", "S0", "REJ")),
    ("src_bytes", 10), ("dst_bytes", 10),
    *((name, _BINARY) for name in (
        "land", "wrong_fragment", "urgent", "hot", "num_failed_logins",
        "logged_in", "num_compromised", "root_shell", "su_attempted",
        "num_root", "num_file_creations", "num_shells", "num_access_files",
        "num_outbound_cmds", "is_host_login", "is_guest_login")),
    *((name, 10) for name in (
        "count", "srv_count", "serror_rate", "srv_serror_rate", "rerror_rate",
        "srv_rerror_rate", "same_srv_rate", "diff_srv_rate",
        "srv_diff_host_rate", "dst_host_count", "dst_host_srv_count",
        "dst_host_same_srv_rate", "dst_host_diff_srv_rate",
        "dst_host_same_src_port_rate", "dst_host_srv_diff_host_rate",
        "dst_host_serror_rate", "dst_host_srv_serror_rate",
        "dst_host_rerror_rate", "dst_host_srv_rerror_rate")),
    ("class", ("anomaly", "normal")),
)
INTRUSION_META = {
    "name": "Intrusion",
    "problem_type": "binary_classification",
    "target": "class",
    "integer_info": ["duration", "src_bytes", "dst_bytes", "count",
                     "srv_count", "dst_host_count", "dst_host_srv_count"],
    "non_negative_cols": ["dst_bytes", "src_bytes"],
}


def intrusion_layout(rng: np.random.Generator):
    """``(meta, encoders, columns)`` of the Intrusion-shaped table; the
    continuous columns' mode means and stds are drawn from ``rng``
    (non-negative columns in log space, as the encoder stores them)."""
    metas, encoders, columns = [], [], []
    for i, (name, spec) in enumerate(INTRUSION_COLUMNS):
        if isinstance(spec, int):
            metas.append(ColumnMeta(name, "continuous", i, min=0.0, max=1.0))
            log_space = name in INTRUSION_META["non_negative_cols"]
            means = rng.uniform(0.0, 8.0 if log_space else 2.0, spec)
            stds = rng.uniform(0.05, 0.5, spec)
            columns.append(ContinuousColumn(name, means, stds))
        else:
            metas.append(ColumnMeta(name, "categorical", i, i2s=list(spec)))
            enc = CategoryEncoder.fit(spec)
            encoders.append(enc)
            columns.append(DiscreteColumn(name, enc.transform(spec)))
    meta = TableMeta(
        columns=metas, name=INTRUSION_META["name"],
        problem_type=INTRUSION_META["problem_type"],
        target=INTRUSION_META["target"],
        integer_columns=list(INTRUSION_META["integer_info"]),
        non_negative_columns=list(INTRUSION_META["non_negative_cols"]))
    return meta, encoders, columns


_VOCAB = {
    "protocol_type": ("tcp", "udp", "icmp"),
    "service": ("http", "smtp", "ftp", "dns"),
    "flag": ("SF", "S0", "REJ"),
    "class": ("normal", "anomaly"),
}


def intrusion_like_table(n: int = 400, seed: int = 0):
    """``(matrix, categorical_idx, meta, encoders)`` of an Intrusion-shaped
    table of ``n`` rows: the reference Intrusion dataset's 42 columns (22
    continuous, 20 categorical) drawn as ``tests/test_workloads.py::
    _intrusion_like(n, seed)`` draws them, then prepared as the JAX ingest
    prepares a table: ``log(x + 1)`` on the non-negative columns, each
    categorical column label-encoded (sorted classes) with its categories
    listed in frequency order in the meta.  ``matrix`` (n, 42) float64
    holds the encoder codes of the categorical columns."""
    rng = np.random.default_rng(seed)
    nonneg = INTRUSION_META["non_negative_cols"]
    cols, metas, encoders, cat_idx = [], [], [], []
    for i, (name, spec) in enumerate(INTRUSION_COLUMNS):
        if not isinstance(spec, int):
            values = _VOCAB.get(name, _BINARY)
            p = None if name in _VOCAB else [0.9, 0.1]
            raw = rng.choice(values, n, p=p)
            enc = CategoryEncoder.fit(raw)
            codes = enc.transform(raw)
            uniq, counts = np.unique(raw, return_counts=True)
            i2s = uniq[np.argsort(-counts, kind="stable")].tolist()
            metas.append(ColumnMeta(name, "categorical", i, i2s=i2s))
            encoders.append(enc)
            cat_idx.append(i)
            cols.append(codes.astype(np.float64))
            continue
        if name in ("src_bytes", "dst_bytes", "duration"):
            x = np.exp(rng.normal(4.0, 2.0, n)).round(0)
        elif name.endswith("_rate"):
            x = rng.uniform(0.0, 1.0, n).round(2)
        else:  # count-style columns
            x = rng.integers(0, 256, n).astype(float)
        if name in nonneg:
            x = np.log(x + 1.0)
        metas.append(ColumnMeta(name, "continuous", i, min=float(x.min()),
                                max=float(x.max())))
        cols.append(x)
    meta = TableMeta(
        columns=metas, name=INTRUSION_META["name"],
        problem_type=INTRUSION_META["problem_type"],
        target=INTRUSION_META["target"],
        integer_columns=list(INTRUSION_META["integer_info"]),
        non_negative_columns=list(nonneg))
    return np.stack(cols, axis=1), cat_idx, meta, encoders


def write_artifact(out_dir: str, synth: SavedSynthesizer, meta: TableMeta,
                   encoders) -> str:
    """Write ``synth`` with its meta and encoders as a port artifact under
    ``out_dir/models``; returns ``out_dir``.  Meta and encoders first, the
    synthesizer last (the registry's freshness order)."""
    models = os.path.join(out_dir, "models")
    os.makedirs(models, exist_ok=True)
    meta.dump_json(os.path.join(models, f"{meta.name}.json"))
    with open(os.path.join(models, f"label_encoders_{meta.name}.json"),
              "w") as f:
        json.dump([{"column_name": name, **enc.to_dict()} for name, enc in
                   zip(meta.categorical_columns, encoders)], f)
    save_synthesizer(synth, os.path.join(models, SYNTH_DIR))
    return out_dir


def build_random_artifact(out_dir: str, seed: int = 0,
                          cfg: TrainConfig = TrainConfig()) -> str:
    """Write a random-weight Intrusion-shaped port artifact under
    ``out_dir/models``; returns ``out_dir``."""
    rng = np.random.default_rng(seed)
    meta, encoders, columns = intrusion_layout(rng)
    spec = SegmentSpec.from_output_info(output_info(columns))
    torch_gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator = Generator(cfg.embedding_dim + spec.n_opt, cfg.gen_dims,
                              spec.dim)
    with torch.no_grad():
        for block in generator.blocks:
            block.bn.running_mean.normal_(0.0, 0.5, generator=torch_gen)
            block.bn.running_var.uniform_(0.5, 2.0, generator=torch_gen)
            block.bn.weight.uniform_(0.5, 1.5, generator=torch_gen)
            block.bn.bias.normal_(0.0, 0.1, generator=torch_gen)
    max_size = int(spec.cond_sizes.max())
    counts = np.zeros((spec.n_discrete, max_size))
    for c, size in enumerate(spec.cond_sizes):
        counts[c, :size] = rng.integers(1, 1000, size)
    cond = CondSampler.from_counts(counts, spec, "cpu")
    synth = SavedSynthesizer(generator, cond, columns, cfg, key_offset=17)
    return write_artifact(out_dir, synth, meta, encoders)
