"""The port's pandas-free ingest, sharding, CSV reader and similarity
metrics against the JAX package's pandas versions on the same files.

Tolerances: meta, encoders, encoded matrices and shard indices are
compared for equality; ``statistical_similarity`` to 1e-12.
"""

import csv
import json

import numpy as np
import pandas as pd
import pytest

from fed_tgan_torch.data import csvio
from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.sharding import shard_indices, shard_table
from fed_tgan_torch.datasets import PRESETS, preprocessor_kwargs
from fed_tgan_torch.eval.similarity import statistical_similarity
from fed_tgan_torch.federation.init import harmonize_categories
from fed_tgan_torch.serve.demo import write_intrusion_csv
from fed_tgan_tpu import datasets as jdatasets
from fed_tgan_tpu.data import sharding as jsharding
from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
from fed_tgan_tpu.eval.similarity import statistical_similarity as jax_sim
from fed_tgan_tpu.federation.init import harmonize_categories as jax_harm

KW = dict(categorical_columns=["cat", "code", "fcode", "cls"],
          non_negative_columns=["amount"], target_column="cls",
          problem_type="binary_classification")


def tricky_csv(path, n=60, seed=0):
    """Blanks, an exact ``" "`` cell, a non-negative column, an
    integer-valued float column, a float categorical with a blank, tied
    category counts, a numeric column that a ``" "`` turns into strings."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append({
            "x": "" if i % 17 == 3 else f"{rng.normal(5, 2):.3f}",
            "cat": ["b", "a", "c", "d"][i % 4] if i != 7 else " ",
            "code": str(int(rng.integers(0, 3))),
            "fcode": "" if i == 11 else f"{int(rng.integers(1, 4))}.0",
            "amount": str(int(rng.exponential(200))),
            "whole": f"{int(rng.integers(0, 9))}.0",
            "spaced": " " if i == 5 else f"{rng.uniform(0, 1):.2f}",
            "cls": ["yes", "no"][i % 2],
        })
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    return path


def test_read_csv_types_like_pandas(tmp_path):
    path = tricky_csv(tmp_path / "t.csv")
    ours, theirs = csvio.read_csv(path), pd.read_csv(path)
    assert list(ours) == list(theirs.columns)
    for name in ours:
        want = theirs[name]
        got = ours[name]
        if want.dtype.kind in "if":
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want.to_numpy())
        else:
            assert got.dtype == object, name
        assert csvio.cell_strings(got).tolist() == [
            None if v is np.nan or v != v else v
            for v in want.astype(str).tolist()], name


def _ingest_both(path, **kw):
    return (JaxPre.from_csv(str(path), **kw),
            TablePreprocessor.from_csv(str(path), **kw))


def test_local_meta_and_encoding_match_jax(tmp_path):
    path = tricky_csv(tmp_path / "t.csv")
    jpre, pre = _ingest_both(path, **KW)
    assert json.dumps(pre.local_meta()) == json.dumps(jpre.local_meta())
    jmeta, jenc, jjsd = jax_harm([jpre.local_meta()])
    meta, enc, jsd = harmonize_categories([pre.local_meta()])
    assert meta == jmeta
    assert [e.classes_.tolist() for e in enc] == [
        e.classes_.tolist() for e in jenc]
    (jm, jcat, _), (m, cat, _) = jpre.encode(jenc), pre.encode(enc)
    assert cat == jcat
    np.testing.assert_array_equal(m, jm)
    assert pre.integer_columns == jpre.integer_columns


def test_intrusion_csv_matches_jax(tmp_path):
    path = write_intrusion_csv(str(tmp_path / "intr.csv"), 300, 1)
    kw = preprocessor_kwargs(PRESETS["intrusion"])
    jkw = jdatasets.preprocessor_kwargs(jdatasets.PRESETS["intrusion"])
    assert {**kw, "date_formats": {}} == jkw  # no preset has a date column
    jpre = JaxPre.from_csv(path, **jkw)
    pre = TablePreprocessor.from_csv(path, **kw)
    assert pre.local_meta() == jpre.local_meta()
    _, jenc, _ = jax_harm([jpre.local_meta()])
    _, enc, _ = harmonize_categories([pre.local_meta()])
    np.testing.assert_array_equal(pre.encode(enc)[0], jpre.encode(jenc)[0])


@pytest.mark.parametrize("strategy", ["iid", "contiguous", "label_sorted",
                                      "dirichlet"])
def test_shard_indices_match_jax(strategy):
    labels = np.random.default_rng(3).choice(["a", "b", "c"], 97)
    for seed in (0, 5):
        ours = shard_indices(97, 4, strategy, labels, 0.4, seed)
        theirs = jsharding.shard_indices(97, 4, strategy, labels, 0.4, seed)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_shard_table_matches_shard_dataframe(tmp_path):
    path = tricky_csv(tmp_path / "t.csv", n=50)
    table, frame = csvio.read_csv(path), pd.read_csv(path)
    ours = shard_table(table, 3, "dirichlet", "cls", 0.8, seed=2)
    theirs = jsharding.shard_dataframe(frame, 3, "dirichlet", "cls", 0.8,
                                       seed=2)
    for t, f in zip(ours, theirs):
        np.testing.assert_array_equal(t["x"], f["x"].to_numpy())
        assert t["cls"].tolist() == f["cls"].tolist()
    with pytest.raises(ValueError, match="0 rows"):
        shard_table(table, 60, "contiguous")


def test_statistical_similarity_matches_jax(tmp_path):
    real_p = write_intrusion_csv(str(tmp_path / "real.csv"), 400, 0)
    fake_p = write_intrusion_csv(str(tmp_path / "fake.csv"), 250, 9)
    cats = list(PRESETS["intrusion"].categorical_columns)
    aj, aw, per = statistical_similarity(csvio.read_csv(real_p),
                                         csvio.read_csv(fake_p), cats)
    bj, bw, jper = jax_sim(pd.read_csv(real_p), pd.read_csv(fake_p), cats)
    np.testing.assert_allclose([aj, aw], [bj, bw], rtol=0, atol=1e-12)
    assert per.keys() == jper.keys()
    np.testing.assert_allclose(list(per.values()), list(jper.values()),
                               rtol=0, atol=1e-12)
