"""The compiled CSV formatter (``fed_tgan_torch/csrc/csvfmt.c`` through
``fed_tgan_torch.data.fastcsv``) against its plain versions, on the CPU.

- float cells byte-equal to ``repr`` over seeded random values at several
  scales and the edge cases of the layout rules;
- ``csv_bytes`` byte-equal to ``plain_csv_bytes`` (the stdlib writer) on a
  decoded Intrusion-shaped table with blanks and quoted categories;
- the packed8 snapshot's lookup tables byte-equal to the plain assemble ->
  ``decode_columns`` -> ``plain_csv_bytes`` path, sentinels included;
- the port's snapshot and served CSV against the JAX package's writers on
  the same parts and matrix: ``pandas.read_csv`` parses both to identical
  values (only quoting differs);
- the bytes do not depend on the thread count.

Tolerance: none; bytes or parsed values are equal.
"""

import io

import numpy as np
import pandas as pd
import pytest
import torch

from fed_tgan_torch.data import fastcsv
from fed_tgan_torch.data.constants import MISSING_CONTINUOUS
from fed_tgan_torch.data.csvio import csv_bytes, plain_csv_bytes
from fed_tgan_torch.data.decode import decode_cells, decode_columns
from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import TableMeta
from fed_tgan_torch.features.bgm import ColumnGMM
from fed_tgan_torch.features.transformer import (
    ContinuousColumn,
    DiscreteColumn,
    ModeNormalizer,
)
from fed_tgan_torch.ops.decode import SnapshotDecode
from fed_tgan_torch.serve.demo import intrusion_layout, intrusion_like_table
from fed_tgan_tpu.data.csvio import csv_bytes as jax_csv_bytes
from fed_tgan_tpu.data.csvio import write_table_csv
from fed_tgan_tpu.data.decode import decode_matrix
from fed_tgan_tpu.data.encoders import CategoryEncoder as JaxEncoder
from fed_tgan_tpu.data.fastcsv import PackedSnapshotFormatter as JaxFormatter
from fed_tgan_tpu.data.schema import TableMeta as JaxMeta
from fed_tgan_tpu.features.bgm import ColumnGMM as JaxGMM
from fed_tgan_tpu.features.transformer import ModeNormalizer as JaxNormalizer
from fed_tgan_tpu.ops import decode as jdecode

torch.set_num_threads(1)


def _float_values(scale: str) -> np.ndarray:
    rng = np.random.default_rng(["f32", "integers", "wide", "decimals",
                                 "subnormal", "edge"].index(scale))
    n = 10_000
    if scale == "f32":  # what a float32 decode widens to
        return (rng.standard_normal(n) * 50).astype(np.float32).astype(
            np.float64)
    if scale == "integers":
        return rng.integers(-2**60, 2**60, n).astype(np.float64)
    if scale == "wide":  # 1e-20 .. 1e+20 and beyond, both signs
        return rng.standard_normal(n) * 10.0 ** rng.integers(-25, 25, n)
    if scale == "decimals":  # short reprs: rounded decimals
        return np.round(rng.standard_normal(n) * 1e4) / 10.0 ** rng.integers(
            0, 8, n)
    if scale == "subnormal":
        return rng.random(n) * 2.2250738585072014e-308 * rng.choice(
            [1e-16, 1e-8, 1.0], n)
    p2 = np.ldexp(1.0, np.arange(-1074, 1024))
    bounds = np.array([1e16, 1e-5, 1e-4, 1e15, 9999999999999998.0,
                       0.1, 0.3, 5e-324, 1.7976931348623157e308,
                       2.2250738585072014e-308, 123456789012345680.0])
    with np.errstate(over="ignore"):
        near = np.concatenate([np.nextafter(bounds, 0),
                               np.nextafter(bounds, np.inf)])
    return np.concatenate([
        p2, -p2, np.nextafter(p2, 0), np.nextafter(p2[:-1], np.inf), 3 * p2[:-2],
        bounds, -bounds, near,
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0, 100.0]])


@pytest.mark.parametrize("scale", ["f32", "integers", "wide", "decimals",
                                   "subnormal", "edge"])
def test_float_cells_equal_repr(scale):
    values = _float_values(scale)
    blob = fastcsv.format_rows([fastcsv.FloatCells(values)])
    got = blob.decode().split("\n")
    assert got[-1] == "" and got[:-1] == [repr(v) for v in values.tolist()]


def _intrusion_with_blanks(n=600, seed=3):
    """A decoded Intrusion-shaped table: continuous and non-negative
    missing sentinels, the missing category, categories that need quoting
    and negative non-negative values that decode to ``-0.0``."""
    matrix, _, meta, encoders = intrusion_like_table(n, seed)
    rng = np.random.default_rng(seed)
    names = meta.column_names
    cats = meta.categorical_columns
    svc = cats.index("service")
    encoders[svc] = CategoryEncoder.fit(["http", "ftp", 'sm"tp', "d,ns",
                                         "empty", "x\ny"])
    matrix[:, names.index("service")] = rng.integers(0, 6, n)
    rows = rng.choice(n, 40, replace=False)
    matrix[rows[:20], names.index("count")] = MISSING_CONTINUOUS
    matrix[rows[20:], names.index("src_bytes")] = MISSING_CONTINUOUS
    matrix[rows[:10], names.index("dst_bytes")] = -0.3
    return matrix, meta, encoders


@pytest.mark.parametrize("header", [True, False])
def test_csv_bytes_equal_plain_on_intrusion_with_blanks(header):
    matrix, meta, encoders = _intrusion_with_blanks()
    cols = decode_columns(matrix, meta, encoders)
    assert any(isinstance(v, str) for v in cols["count"].tolist())
    want = plain_csv_bytes(cols, header=header)
    assert b'"d,ns"' in want and b'"sm""tp"' in want and b",-0.0," in want
    assert csv_bytes(cols, header=header) == want
    plan = fastcsv.ColumnPlan(meta, encoders)
    cells = decode_cells(matrix, meta, encoders)
    assert plan.csv_bytes(cells, header=header) == want


@pytest.mark.parametrize("cols", [
    {"only": np.array(["", "a", "b,c"], dtype=object)},
    {"i": np.array([3, -1, 3]), "b": np.array([True, False, True]),
     "s": np.array(["x", "y", "x"]), "f32": np.array([0.1, 2, 3],
                                                     dtype=np.float32)},
    {"mixed": np.array([1.5, " ", "tcp", 2, None, np.float64(0.5)],
                       dtype=object),
     "blanks": np.array([" ", 0.25, " ", -0.0, float("nan"), 1e22],
                        dtype=object),
     "zeros": np.array([0.0, "a", -0.0, 1, True, 1.0], dtype=object)},
    {"empty": np.array([], dtype=np.float64), "e2": np.array([], dtype=object)},
], ids=["alone", "dtypes", "objects", "no_rows"])
def test_csv_bytes_equal_plain_on_column_kinds(cols):
    for header in (True, False):
        assert csv_bytes(cols, header=header) == plain_csv_bytes(
            cols, header=header)


def _snapshot_layout(case: str):
    """``(decode, meta, encoders)``: the full-width Intrusion layout, or
    one whose modes emit the missing sentinel and non-negative values that
    decode to -1 (blank) and to ``-0.0``."""
    rng = np.random.default_rng(5)
    meta, encoders, columns = intrusion_layout(rng)
    if case == "sentinels":
        for col in columns:
            if col.name == "count":  # its second mode is the sentinel
                col.means[1], col.stds[1] = MISSING_CONTINUOUS, 0.0
            if col.name == "src_bytes":  # exp(-1000) - 1 == -1 -> blank
                col.means[0], col.stds[0] = -1000.0, 1.0
            if col.name == "dst_bytes":  # exp(x) - 1 in (-1, 0) -> -0.0
                col.means[0], col.stds[0] = -0.5, 0.1
    return SnapshotDecode(columns, "packed8"), meta, encoders


def _packed_parts(decode, n=3000, seed=7):
    rng = np.random.default_rng(seed)
    cont = [c for c in decode.columns if isinstance(c, ContinuousColumn)]
    disc = [c for c in decode.columns if isinstance(c, DiscreteColumn)]
    u = rng.integers(-127, 128, (n, len(cont))).astype(np.int8)
    u[:2] = [[-127], [127]]  # both ends of the level range
    k = np.stack([rng.integers(0, c.n_active, n) for c in cont],
                 axis=1).astype(np.int8)
    d = np.stack([rng.choice(c.codes, n) for c in disc], axis=1)
    return {"u": u, "k": k, "disc": d.astype(np.int16)}


@pytest.mark.parametrize("case", ["intrusion", "sentinels"])
def test_packed_formatter_equals_plain_path(case):
    decode, meta, encoders = _snapshot_layout(case)
    fmt = fastcsv.PackedSnapshotFormatter.build(decode, meta, encoders)
    assert fmt is not None
    parts = _packed_parts(decode)
    cols = decode_columns(decode.assemble(parts), meta, encoders)
    if case == "sentinels":
        for name in ("count", "src_bytes"):
            assert " " in cols[name].tolist()
        assert "-0.0" in [repr(v) for v in cols["dst_bytes"].tolist()]
    for header in (True, False):
        assert fmt.csv_bytes(parts, header=header) == plain_csv_bytes(
            cols, header=header)


def test_packed_formatter_eligibility():
    decode, meta, encoders = _snapshot_layout("intrusion")
    build = fastcsv.PackedSnapshotFormatter.build
    for mode in ("packed16", "exact"):
        assert build(SnapshotDecode(decode.columns, mode), meta,
                     encoders) is None
    dated = TableMeta.from_json_dict({**meta.to_json_dict(),
                                      "date_info": {"duration": "%Y"}})
    assert build(decode, dated, encoders) is None
    # a discrete column without an encoder: the exact path
    ordinal = TableMeta.from_json_dict(meta.to_json_dict())
    ordinal.columns[1].kind = "ordinal"
    assert build(decode, ordinal, encoders[1:]) is None
    parts = _packed_parts(decode, n=10)
    parts["k"][3, 0] = 120  # no such mode: outside the column's table
    fmt = build(decode, meta, encoders)
    with pytest.raises(ValueError, match="out of range"):
        fmt.csv_bytes(parts)


@pytest.mark.parametrize("threads", [2, 3, 7, 16])
def test_thread_count_does_not_change_the_bytes(threads):
    matrix, meta, encoders = _intrusion_with_blanks(n=2000, seed=4)
    plan = fastcsv.ColumnPlan(meta, encoders)
    cells = decode_cells(matrix, meta, encoders)
    cols = [fastcsv.TableCells(cells[n].values, plan.tables[n])
            if n in plan.tables else
            fastcsv.FloatCells(cells[n].values, cells[n].blank)
            for n in plan.names]
    one = fastcsv.format_rows(cols, plan.header, threads=1)
    assert fastcsv.format_rows(cols, plan.header, threads=threads) == one
    assert one == plain_csv_bytes(decode_columns(matrix, meta, encoders))


# ------------------------------------------------ against the JAX package

META = {
    "columns": [
        {"column_name": "amount", "type": "continous", "min": 0, "max": 1},
        {"column_name": "kind", "type": "categorical",
         "i2s": ["p", "q,r", "empty"]},
        {"column_name": "score", "type": "continous", "min": 0, "max": 1},
        {"column_name": "level", "type": "categorical", "i2s": ["0", "1", "2"]},
    ],
    "name": "t", "non_negative_cols": ["amount"], "date_info": {},
}
CLASSES = (["p", "q,r", "empty"], ["0", "1", "2"])


def _normalizers():
    """Both packages' normalizers over one table with the same mixtures."""
    rng = np.random.default_rng(0)
    n = 400
    data = np.stack([
        np.concatenate([rng.normal(1, .3, 200), rng.normal(4, .5, 200)]),
        rng.integers(0, 3, n).astype(float),
        np.concatenate([rng.normal(-3, .3, 150), rng.normal(0, .3, 150),
                        rng.normal(4, .3, 100)]),
        rng.integers(0, 3, n).astype(float),
    ], axis=1)
    ours = ModeNormalizer(device="cpu").fit(data, categorical_idx=[1, 3])
    gmms = {j: JaxGMM(means=g.means, stds=g.stds, weights=g.weights,
                      active=g.active, mean_precision=g.mean_precision,
                      dof=g.dof, stick_a=g.stick_a, stick_b=g.stick_b)
            for j, g in enumerate(ours.gmms) if isinstance(g, ColumnGMM)}
    theirs = JaxNormalizer().fit(data, categorical_idx=[1, 3],
                                 column_gmms=gmms)
    return ours, theirs


def test_snapshot_parses_like_the_jax_formatter(tmp_path):
    ours, theirs = _normalizers()
    decode = SnapshotDecode(ours.columns, "packed8")
    jfn, _ = jdecode.make_device_decode_packed8(theirs.columns)
    meta, jmeta = TableMeta.from_json_dict(META), JaxMeta.from_json_dict(META)
    enc = [CategoryEncoder.fit(c) for c in CLASSES]
    jenc = [JaxEncoder.fit(c) for c in CLASSES]
    jfmt = JaxFormatter.build(jfn.tables, jmeta, jenc)
    assert jfmt is not None
    parts = _packed_parts(decode, n=2000, seed=9)
    write_table_csv(jfmt.table(parts), str(tmp_path / "jax.csv"))
    ours_csv = fastcsv.PackedSnapshotFormatter.build(
        decode, meta, enc).csv_bytes(parts)
    pd.testing.assert_frame_equal(pd.read_csv(io.BytesIO(ours_csv)),
                                  pd.read_csv(tmp_path / "jax.csv"))


def test_served_csv_parses_like_the_jax_writer():
    rng = np.random.default_rng(2)
    n = 500
    mat = np.stack([rng.normal(2, 1, n), rng.integers(0, 3, n),
                    rng.normal(0, 3, n), rng.integers(0, 3, n)],
                   axis=1).astype(np.float32)
    mat[3, 0] = mat[4, 2] = MISSING_CONTINUOUS
    mat[5, 0] = -0.5
    meta, jmeta = TableMeta.from_json_dict(META), JaxMeta.from_json_dict(META)
    enc = [CategoryEncoder.fit(c) for c in CLASSES]
    jenc = [JaxEncoder.fit(c) for c in CLASSES]
    ours = fastcsv.ColumnPlan(meta, enc).csv_bytes(
        decode_cells(mat, meta, enc))
    theirs = jax_csv_bytes(decode_matrix(mat, jmeta, jenc))
    pd.testing.assert_frame_equal(pd.read_csv(io.BytesIO(ours)),
                                  pd.read_csv(io.BytesIO(theirs)))
