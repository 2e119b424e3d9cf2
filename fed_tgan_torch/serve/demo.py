"""Demo data and artifacts: a random-weight artifact, training tables and
a small trained model.

- :func:`build_random_artifact` writes a full-width Intrusion-shaped
  artifact with random weights.
- :func:`intrusion_like_table` makes an Intrusion-shaped numeric training
  table, with its meta and encoders, without pandas;
  :func:`write_intrusion_csv` writes the same raw table as a CSV file, and
  :func:`write_dated_csv` the same with two date columns.
- :func:`build_demo_artifact` trains a tiny standalone model on
  :func:`demo_frame` and writes it with its reference statistics (the
  canary's tests and recipes), and :func:`republish_demo_candidate`
  publishes the same weights again as a new generation
  (``fed_tgan_tpu/serve/demo.py:18-109``).

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

from fed_tgan_torch.data.csvio import csv_bytes
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


def table_layout(columns: tuple, info: dict, rng: np.random.Generator):
    """``(meta, encoders, columns)`` of a table given as ``columns``
    ((name, number of active modes) or (name, categories in frequency
    order), in meta order) and ``info`` (name, problem type, target,
    integer and non-negative columns); the continuous columns' mode means
    and stds are drawn from ``rng`` (non-negative columns in log space, as
    the encoder stores them)."""
    metas, encoders, out = [], [], []
    for i, (name, spec) in enumerate(columns):
        if isinstance(spec, int):
            metas.append(ColumnMeta(name, "continuous", i, min=0.0, max=1.0))
            log_space = name in info["non_negative_cols"]
            means = rng.uniform(0.0, 8.0 if log_space else 2.0, spec)
            stds = rng.uniform(0.05, 0.5, spec)
            out.append(ContinuousColumn(name, means, stds))
        else:
            metas.append(ColumnMeta(name, "categorical", i, i2s=list(spec)))
            enc = CategoryEncoder.fit(spec)
            encoders.append(enc)
            out.append(DiscreteColumn(name, enc.transform(spec)))
    meta = TableMeta(
        columns=metas, name=info["name"], problem_type=info["problem_type"],
        target=info["target"], integer_columns=list(info["integer_info"]),
        non_negative_columns=list(info["non_negative_cols"]))
    return meta, encoders, out


def intrusion_layout(rng: np.random.Generator):
    """:func:`table_layout` of the Intrusion-shaped table (282 dims)."""
    return table_layout(INTRUSION_COLUMNS, INTRUSION_META, rng)


_VOCAB = {
    "protocol_type": ("tcp", "udp", "icmp"),
    "service": ("http", "smtp", "ftp", "dns"),
    "flag": ("SF", "S0", "REJ"),
    "class": ("normal", "anomaly"),
}


def intrusion_like_raw(n: int = 400, seed: int = 0) -> dict:
    """``{column: raw values}`` of an Intrusion-shaped table of ``n`` rows:
    the reference Intrusion dataset's 42 columns (22 continuous, 20
    categorical) drawn as ``tests/test_workloads.py::_intrusion_like(n,
    seed)`` draws them; categories as strings, numbers as float64."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in INTRUSION_COLUMNS:
        if not isinstance(spec, int):
            values = _VOCAB.get(name, _BINARY)
            p = None if name in _VOCAB else [0.9, 0.1]
            out[name] = rng.choice(values, n, p=p)
        elif name in ("src_bytes", "dst_bytes", "duration"):
            out[name] = np.exp(rng.normal(4.0, 2.0, n)).round(0)
        elif name.endswith("_rate"):
            out[name] = rng.uniform(0.0, 1.0, n).round(2)
        else:  # count-style columns
            out[name] = rng.integers(0, 256, n).astype(float)
    return out


def write_intrusion_csv(path: str, n: int = 400, seed: int = 0) -> str:
    """:func:`intrusion_like_raw` as a raw CSV file (integral numbers
    written as integers, as a real export holds them); returns ``path``."""
    cols = {}
    for name, v in intrusion_like_raw(n, seed).items():
        if v.dtype.kind == "f" and np.array_equal(v, np.round(v)):
            v = v.astype(np.int64)
        cols[name] = v
    with open(path, "wb") as f:
        f.write(csv_bytes(cols))
    return path


def dated_columns(n: int = 400, seed: int = 0) -> dict:
    """Two date columns of ``n`` rows for an Intrusion-shaped table:
    ``when`` as ``YYYY-MM-DD`` strings and ``stamp`` as ``yymmdd`` ints,
    years 1995-2024 (2000-2009 among them), every fourth row a leap day,
    and about one cell in twenty blank (``''``)."""
    rng = np.random.default_rng([seed, 2])
    out = {}
    for name in ("when", "stamp"):
        year = rng.integers(1995, 2025, n)
        month = rng.integers(1, 13, n)
        day = rng.integers(1, 29, n)
        leap = np.arange(n) % 4 == 0
        year[leap] = rng.choice([1996, 2000, 2004, 2008, 2024], leap.sum())
        month[leap], day[leap] = 2, 29
        if name == "when":
            cells = [f"{y:04d}-{m:02d}-{d:02d}"
                     for y, m, d in zip(year, month, day)]
        else:
            cells = [int(f"{y % 100:02d}{m:02d}{d:02d}")
                     for y, m, d in zip(year, month, day)]
        col = np.array(cells, dtype=object)
        col[rng.random(n) < 0.05] = ""
        out[name] = col
    return out


def write_dated_csv(path: str, n: int = 400, seed: int = 0) -> str:
    """:func:`write_intrusion_csv`'s table with :func:`dated_columns`
    appended, as a raw CSV file; returns ``path``."""
    cols = {}
    for name, v in {**intrusion_like_raw(n, seed),
                    **dated_columns(n, seed)}.items():
        if v.dtype.kind == "f" and np.array_equal(v, np.round(v)):
            v = v.astype(np.int64)
        cols[name] = v
    with open(path, "wb") as f:
        f.write(csv_bytes(cols))
    return path


def intrusion_like_table(n: int = 400, seed: int = 0):
    """``(matrix, categorical_idx, meta, encoders)`` of
    :func:`intrusion_like_raw` prepared as the JAX ingest prepares a
    table: ``log(x + 1)`` on the non-negative columns, each categorical
    column label-encoded (sorted classes) with its categories listed in
    frequency order in the meta.  ``matrix`` (n, 42) float64 holds the
    encoder codes of the categorical columns."""
    nonneg = INTRUSION_META["non_negative_cols"]
    cols, metas, encoders, cat_idx = [], [], [], []
    for i, (name, raw) in enumerate(intrusion_like_raw(n, seed).items()):
        if raw.dtype.kind != "f":
            enc = CategoryEncoder.fit(raw)
            codes = enc.transform(raw)
            uniq, counts = np.unique(raw, return_counts=True)
            i2s = uniq[np.argsort(-counts, kind="stable")].tolist()
            metas.append(ColumnMeta(name, "categorical", i, i2s=i2s))
            encoders.append(enc)
            cat_idx.append(i)
            cols.append(codes.astype(np.float64))
            continue
        x = raw
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


_EDUCATION = np.array([
    "Preschool", "1st-4th", "5th-6th", "7th-8th", "9th", "10th", "11th",
    "12th", "HS-grad", "Some-college", "Assoc-voc", "Assoc-acdm",
    "Bachelors", "Masters", "Prof-school", "Doctorate"])
# (column, categories, probabilities) of the independently drawn ones
_ADULT_CHOICES = {
    "workclass": (["Private", "Self-emp-not-inc", "Self-emp-inc",
                   "Federal-gov", "Local-gov", "State-gov", "Without-pay",
                   "Never-worked"],
                  [0.694, 0.079, 0.035, 0.029, 0.064, 0.041, 0.05, 0.008]),
    "marital-status": (["Married-civ-spouse", "Never-married", "Divorced",
                        "Separated", "Widowed", "Married-spouse-absent",
                        "Married-AF-spouse"],
                       [0.458, 0.33, 0.136, 0.031, 0.031, 0.013, 0.001]),
    "occupation": (["Prof-specialty", "Craft-repair", "Exec-managerial",
                    "Adm-clerical", "Sales", "Other-service",
                    "Machine-op-inspct", "Transport-moving",
                    "Handlers-cleaners", "Farming-fishing", "Tech-support",
                    "Protective-serv", "Priv-house-serv", "Armed-Forces"],
                   [0.132, 0.13, 0.129, 0.12, 0.117, 0.106, 0.066, 0.053,
                    0.047, 0.035, 0.028, 0.02, 0.016, 0.001]),
    "relationship": (["Husband", "Not-in-family", "Own-child", "Unmarried",
                      "Wife", "Other-relative"],
                     [0.404, 0.255, 0.155, 0.105, 0.048, 0.033]),
    "race": (["White", "Black", "Asian-Pac-Islander", "Amer-Indian-Eskimo",
              "Other"], [0.855, 0.096, 0.031, 0.01, 0.008]),
    "native-country": (["United-States", "Mexico", "Philippines", "Germany",
                        "Canada", "Puerto-Rico", "El-Salvador", "India",
                        "Cuba", "England", "other"],
                       [0.895, 0.02, 0.006, 0.004, 0.004, 0.004, 0.003,
                        0.003, 0.003, 0.003, 0.055]),
}


# the Adult-census-shaped layout of 123 dims: 6 continuous columns with
# 46 active modes in all (about what the mode fit keeps on
# adult_like_table) and 9 categorical columns of 71 categories
ADULT_COLUMNS = (
    ("age", 10), ("workclass", tuple(_ADULT_CHOICES["workclass"][0])),
    ("fnlwgt", 10), ("education", tuple(_EDUCATION)), ("education-num", 6),
    ("marital-status", tuple(_ADULT_CHOICES["marital-status"][0])),
    ("occupation", tuple(_ADULT_CHOICES["occupation"][0])),
    ("relationship", tuple(_ADULT_CHOICES["relationship"][0])),
    ("race", tuple(_ADULT_CHOICES["race"][0])), ("sex", ("Male", "Female")),
    ("capital-gain", 8), ("capital-loss", 4), ("hours-per-week", 8),
    ("native-country", tuple(_ADULT_CHOICES["native-country"][0])),
    ("income", ("<=50K", ">50K")),
)
ADULT_META = {
    "name": "Adult",
    "problem_type": "binary_classification",
    "target": "income",
    "integer_info": ["age", "fnlwgt", "education-num", "capital-gain",
                     "capital-loss", "hours-per-week"],
    "non_negative_cols": ["capital-gain", "capital-loss", "fnlwgt"],
}
LAYOUTS = {"intrusion": (INTRUSION_COLUMNS, INTRUSION_META),
           "adult": (ADULT_COLUMNS, ADULT_META)}


def adult_like_table(n: int = 7000, seed: int = 11) -> dict:
    """``{column: raw values}`` of an Adult-census-shaped table of ``n``
    rows, the columns, values and order ``bench.py::_adult_like(n, seed)``
    draws (6 continuous columns, two of them zero-inflated capital
    columns, 9 categorical; an income label from a logistic in age,
    education, hours, capital gain and sex).  Numbers as float64,
    categories as strings; numpy only."""
    rng = np.random.default_rng(seed)
    age = np.clip(rng.normal(38.6, 13.7, n), 17, 90).round()
    edu_num = np.clip(rng.normal(10.1, 2.6, n), 1, 16).round()
    hours = np.clip(rng.normal(40.4, 12.3, n), 1, 99).round()
    gain = np.where(rng.random(n) < 0.083,
                    np.exp(rng.normal(7.6, 1.3, n)), 0.0).round()
    loss = np.where(rng.random(n) < 0.047,
                    np.exp(rng.normal(7.4, 0.6, n)), 0.0).round()
    sex = rng.choice(["Male", "Female"], n, p=[0.67, 0.33])
    logit = (0.035 * (age - 38) + 0.32 * (edu_num - 10)
             + 0.03 * (hours - 40) + 0.9 * (gain > 0)
             + 0.55 * (sex == "Male") - 1.45)
    income = np.where(rng.random(n) < 1.0 / (1.0 + np.exp(-logit)),
                      ">50K", "<=50K")
    choice = lambda name: rng.choice(_ADULT_CHOICES[name][0], n,
                                     p=_ADULT_CHOICES[name][1])
    # the draws below follow the reference table's column order
    out = {"age": age, "workclass": choice("workclass"),
           "fnlwgt": np.exp(rng.normal(11.9, 0.5, n)).round(),
           "education": _EDUCATION[edu_num.astype(int) - 1],
           "education-num": edu_num,
           "marital-status": choice("marital-status"),
           "occupation": choice("occupation"),
           "relationship": choice("relationship"), "race": choice("race"),
           "sex": sex, "capital-gain": gain, "capital-loss": loss,
           "hours-per-week": hours,
           "native-country": choice("native-country"), "income": income}
    return out


def write_adult_csv(path: str, n: int = 7000, seed: int = 11,
                    train_frac: float = 1.0) -> str:
    """The first ``int(n * train_frac)`` rows of :func:`adult_like_table`
    (the training side of the reference's 70/30 split at 0.7) as a raw
    CSV file, integral numbers written as integers; returns ``path``."""
    rows = int(n * train_frac)
    cols = {}
    for name, v in adult_like_table(n, seed).items():
        v = v[:rows]
        if v.dtype.kind == "f" and np.array_equal(v, np.round(v)):
            v = v.astype(np.int64)
        cols[name] = v
    with open(path, "wb") as f:
        f.write(csv_bytes(cols))
    return path


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
                          cfg: TrainConfig = TrainConfig(),
                          table: str = "intrusion") -> str:
    """Write a random-weight port artifact of the ``table`` layout
    (:data:`LAYOUTS`: ``intrusion``, 282 dims, or ``adult``, 123) under
    ``out_dir/models``; returns ``out_dir``."""
    rng = np.random.default_rng(seed)
    meta, encoders, columns = table_layout(*LAYOUTS[table], rng)
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


def demo_frame(rows: int = 200, seed: int = 0) -> dict:
    """A mixed-type table as ``{column: values}``, with the JAX demo's
    draws: continuous, non-negative and two categorical columns."""
    rng = np.random.default_rng(seed)
    return {
        "amount": np.exp(rng.normal(2.0, 1.0, rows)).round(2),
        "score": np.concatenate([
            rng.normal(-4.0, 0.5, rows // 2),
            rng.normal(3.0, 1.0, rows - rows // 2),
        ]),
        "color": rng.choice(["red", "green", "blue"], rows,
                            p=[0.6, 0.3, 0.1]).astype(object),
        "flag": rng.choice(["yes", "no"], rows, p=[0.8, 0.2]).astype(object),
    }


def build_demo_artifact(out_dir: str, rows: int = 200, seed: int = 0,
                        epochs: int = 1, batch_size: int = 50,
                        embedding_dim: int = 16, name: str = "demo",
                        device="cuda", precision: str = "f32") -> str:
    """Train a tiny standalone model on :func:`demo_frame` on ``device``
    in ``precision`` (``fed_tgan_tpu/serve/demo.py:38-65``: it rides into
    the artifact, which then serves in it) and write it under
    ``out_dir/models`` (meta and encoders, the synthesizer last), with
    reference statistics of the training table; returns ``out_dir``."""
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import harmonize_categories
    from fed_tgan_torch.serve.canary import (
        compute_reference_stats,
        reference_stats_path,
        write_reference_stats,
    )
    from fed_tgan_torch.train.standalone import StandaloneSynthesizer

    frame = demo_frame(rows, seed)
    pre = TablePreprocessor(table=frame, name=name,
                            categorical_columns=["color", "flag"],
                            non_negative_columns=["amount"])
    meta_dict, encoders, _ = harmonize_categories([pre.local_meta()])
    matrix, cat_idx, ord_idx = pre.encode(encoders)
    cfg = TrainConfig(batch_size=batch_size, embedding_dim=embedding_dim,
                      gen_dims=(32, 32), dis_dims=(32, 32),
                      precision=precision)
    synth = StandaloneSynthesizer(cfg, seed=seed, device=device)
    synth.fit(matrix, cat_idx, ord_idx, epochs=epochs)
    meta = pre.global_table_meta(meta_dict)
    write_artifact(out_dir, synth.to_saved(), meta, encoders)
    # the canary scores later generations against these
    stats = compute_reference_stats(frame, meta.categorical_columns,
                                    name=name, probe_rows=min(64, rows))
    write_reference_stats(stats, reference_stats_path(
        os.path.join(out_dir, "models"), name))
    return out_dir


def republish_demo_candidate(artifact_dir: str, key_offset_bump: int = 1000,
                             device="cuda") -> str:
    """Publish the artifact's synthesizer again as a new generation: the
    same weights (loaded onto ``device``) with the sampling stream offset
    bumped, so a new fingerprint with the same output law, a candidate the
    canary should promote.  Returns the synthesizer's path."""
    from fed_tgan_torch.runtime.checkpoint import load_synthesizer

    path = os.path.join(artifact_dir, "models", SYNTH_DIR)
    synth = load_synthesizer(path, device=device)
    synth.key_offset += int(key_offset_bump)
    save_synthesizer(synth, path)
    return path
