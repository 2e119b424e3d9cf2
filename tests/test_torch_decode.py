"""The port's decode against the JAX package's: the on-device layout
decode against ``make_layout_decode``, and the CSV rows against
``decode_matrix`` (and the JAX CSV writer), cell for cell."""

import csv
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fed_tgan_tpu.data.csvio import csv_bytes as jax_csv_bytes
from fed_tgan_tpu.data.decode import decode_matrix
from fed_tgan_tpu.data.encoders import CategoryEncoder as JaxEncoder
from fed_tgan_tpu.data.schema import TableMeta as JaxMeta
from fed_tgan_tpu.features.bgm import ColumnGMM
from fed_tgan_tpu.features import transformer as jt
from fed_tgan_tpu.ops.decode import decode_layout as jax_decode_layout
from fed_tgan_tpu.ops.decode import decode_tables as jax_decode_tables
from fed_tgan_tpu.ops.decode import make_layout_decode
from fed_tgan_torch.data.csvio import csv_bytes
from fed_tgan_torch.data.decode import decode_columns
from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import TableMeta
from fed_tgan_torch.features.transformer import (
    ContinuousColumn,
    DiscreteColumn,
    output_info,
)
from fed_tgan_torch.ops.decode import (
    decode_layout,
    decode_tables,
    layout_decode,
    tables_to,
)

torch.set_num_threads(1)


def _columns(seed=0):
    """The same decode columns in both packages: two continuous columns
    with some inactive modes, two discrete ones with permuted codes."""
    rng = np.random.default_rng(seed)
    jcols, cols = [], []
    for name, k, active in (("a", 5, [1, 0, 1, 1, 0]), ("b", 3, [1, 1, 1])):
        means, stds = rng.normal(0, 5, k), rng.uniform(0.1, 2.0, k)
        active = np.asarray(active, dtype=bool)
        jcols.append(jt.ContinuousColumn(name, ColumnGMM(
            means=means, stds=stds, weights=np.full(k, 1.0 / k), active=active)))
        cols.append(ContinuousColumn(name, means[active], stds[active]))
    for name, codes in (("c", [2, 0, 1]), ("d", [1, 0])):
        jcols.append(jt.DiscreteColumn(name, np.asarray(codes)))
        cols.append(DiscreteColumn(name, np.asarray(codes)))
    return jcols, cols


def test_layout_matches_jax():
    jcols, cols = _columns()
    assert decode_layout(cols) == jax_decode_layout(jcols)
    for tab, jtab in zip(decode_tables(cols), jax_decode_tables(jcols)):
        for a, b in zip(tab, jtab):
            np.testing.assert_array_equal(a, b)
    jn = jt.ModeNormalizer()
    jn.columns = jcols
    jn._finalize()
    assert output_info(cols) == jn.output_info


def test_layout_decode_matches_jax():
    jcols, cols = _columns()
    dim = sum(size for size, _ in output_info(cols))
    rng = np.random.default_rng(1)
    enc = rng.normal(0, 1.5, (300, dim)).astype(np.float32)
    enc[:10, 1:4] = 0.5  # exact ties: the first slot wins in both
    enc[10:20, 9:12] = 0.25
    want = np.asarray(make_layout_decode(jax_decode_layout(jcols))(
        jnp.asarray(enc), jax_decode_tables(jcols)))
    got = layout_decode(torch.from_numpy(enc),
                        tables_to(decode_tables(cols), "cpu")).numpy()
    assert got.dtype == np.float32 and got.shape == (300, 4)
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])  # codes: exact
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=1e-6, atol=1e-6)


def test_layout_decode_rejects_width_mismatch():
    _, cols = _columns()
    with pytest.raises(ValueError):
        layout_decode(torch.zeros((2, 3)), tables_to(decode_tables(cols), "cpu"))


META = {
    "columns": [
        {"column_name": "amount", "type": "continous", "min": 0, "max": 1},
        {"column_name": "score", "type": "continous", "min": 0, "max": 1},
        {"column_name": "color", "type": "categorical",
         "i2s": ["red", "empty", "blue"]},
        {"column_name": "flag", "type": "categorical", "i2s": ["no", "yes, sure"]},
    ],
    "name": "t", "non_negative_cols": ["amount"], "date_info": {},
}


def _matrix():
    rng = np.random.default_rng(2)
    n = 50
    mat = np.stack([
        rng.normal(2, 1, n), rng.normal(0, 3, n),
        rng.integers(0, 3, n), rng.integers(0, 2, n)], axis=1).astype(np.float32)
    mat[3, 0] = -999999.0  # non-negative missing sentinel -> ' '
    mat[4, 1] = -999999.0  # continuous missing sentinel -> ' '
    mat[5, 0] = -0.5       # exp(x) - 1 < 0 -> ceil
    return mat


def _encoders(cls):
    return [cls.fit(["red", "empty", "blue"]), cls.fit(["no", "yes, sure"])]


def test_csv_rows_match_jax_decode_cell_for_cell():
    mat = _matrix()
    frame = decode_matrix(mat, JaxMeta.from_json_dict(META), _encoders(JaxEncoder))
    cols = decode_columns(mat, TableMeta.from_json_dict(META),
                          _encoders(CategoryEncoder))
    ours = list(csv.reader(io.StringIO(csv_bytes(cols).decode())))
    theirs = list(csv.reader(io.StringIO(jax_csv_bytes(frame).decode())))
    assert ours[0] == list(frame.columns) == theirs[0]
    assert len(ours) == len(theirs) == len(mat) + 1

    def same(a, b):
        if isinstance(b, str):
            return a == b
        return float(a) == float(b)

    for i, (row, jrow) in enumerate(zip(ours[1:], theirs[1:])):
        for j, name in enumerate(frame.columns):
            v = frame[name].iloc[i]
            assert same(row[j], v), (i, name, row[j], v)
            assert same(row[j], jrow[j] if isinstance(v, str) else float(jrow[j]))
    assert ours[4][0] == " " and ours[5][1] == " "
    assert {r[2] for r in ours[1:]} <= {"red", " ", "blue"}


def test_csv_header_flag_and_quoting():
    cols = {"x": np.array([1.5, 2.0]), "y": np.array(["a,b", "c"], dtype=object)}
    blob = csv_bytes(cols)
    assert blob == b'x,y\n1.5,"a,b"\n2.0,c\n'
    assert csv_bytes(cols, header=False) == blob.split(b"\n", 1)[1]


def test_encoder_json_roundtrip_matches_jax():
    values = ["b", "a", "c", "a"]
    enc, jenc = CategoryEncoder.fit(values), JaxEncoder.fit(values)
    np.testing.assert_array_equal(enc.transform(values), jenc.transform(values))
    back = CategoryEncoder.from_dict(enc.to_dict())
    np.testing.assert_array_equal(back.inverse_transform([2, 0]), ["c", "a"])
    with pytest.raises(ValueError):
        back.transform(["z"])
    with pytest.raises(ValueError):
        back.inverse_transform([3])
