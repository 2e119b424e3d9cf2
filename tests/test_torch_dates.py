"""Date columns in the port on the CPU: the split into part-columns, the
rejoin (leap days, overruns, missing parts, ``yymmdd`` years 2000-2009),
the ingest with ``date_formats`` and the CSV bytes of a dated decode, each
held equal to the JAX package's pandas versions on the same inputs; then
``--date-format`` through the port's CLI in both modes, and serving the
dated artifact it saves.
"""

import csv
import datetime as dt
import io
import json
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

from fed_tgan_torch import cli as port_cli
from fed_tgan_torch import datasets as pdatasets
from fed_tgan_torch.data.csvio import csv_bytes, read_csv
from fed_tgan_torch.data.dates import (
    join_date_columns,
    part_columns,
    split_date_columns,
)
from fed_tgan_torch.data.decode import (
    decode_cells,
    decode_columns,
    output_columns,
)
from fed_tgan_torch.data.fastcsv import ColumnPlan
from fed_tgan_torch.data.ingest import TablePreprocessor, _fill_missing
from fed_tgan_torch.data.schema import TableMeta
from fed_tgan_torch.datasets import INTRUSION_SELECTED
from fed_tgan_torch.federation.init import harmonize_categories
from fed_tgan_torch.serve.demo import write_dated_csv
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import open_model
from fed_tgan_tpu import cli as jax_cli
from fed_tgan_tpu import datasets as jdatasets
from fed_tgan_tpu.data import dates as jdates
from fed_tgan_tpu.data.csvio import csv_bytes as jax_csv_bytes
from fed_tgan_tpu.data.decode import decode_matrix
from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
from fed_tgan_tpu.data.schema import TableMeta as JaxMeta
from fed_tgan_tpu.federation.init import harmonize_categories as jax_harm

torch.set_num_threads(1)

FORMATS = {"when": "YYYY-MM-DD", "stamp": "yymmdd|YYYY-MM-DD"}
COLUMNS = (*INTRUSION_SELECTED, "when", "stamp")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_dated_csv(str(tmp_path_factory.mktemp("dated") / "d.csv"),
                           300, 0)


def _kwargs(module):
    kw = module.preprocessor_kwargs(module.PRESETS["intrusion"])
    kw.update(date_formats=dict(FORMATS), selected_columns=list(COLUMNS))
    return kw


@pytest.fixture(scope="module")
def prepared(data):
    """The port's and JAX's preprocessors of the dated CSV, harmonized."""
    pre = TablePreprocessor.from_csv(data, **_kwargs(pdatasets))
    jpre = JaxPre.from_csv(data, **_kwargs(jdatasets))
    meta, enc, _ = harmonize_categories([pre.local_meta()])
    jmeta, jenc, _ = jax_harm([jpre.local_meta()])
    return pre, jpre, meta, enc, jmeta, jenc


def _valid_cell(cell: str, fmt: str) -> bool:
    """``' '``, or a date written as the JAX package writes the column."""
    if cell == " ":
        return True
    if fmt.startswith("yymmdd"):
        return bool(re.fullmatch(r"\d{1,6}", cell)) and bool(
            dt.datetime.strptime(cell.zfill(6), "%y%m%d"))
    return bool(re.fullmatch(r"\d{4}-\d{2}-\d{2} 00:00:00", cell)) and bool(
        dt.datetime.strptime(cell, "%Y-%m-%d %H:%M:%S"))


# ------------------------------------------------------ parity with JAX


@pytest.mark.parametrize("fmt", ["YYYY-MM-DD", "yymmdd|YYYY-MM-DD",
                                 "YYYY-MM-DD-hh-mm-ss", "MM-DD"])
def test_part_columns_match_jax(fmt):
    assert part_columns("d", fmt) == jdates.part_columns("d", fmt)


def test_split_matches_jax(data):
    """Parts of the raw CSV's dates (blanks, leap days, 2000-2009 years)
    equal the JAX split's, with the categorical list edited the same."""
    table = {c: _fill_missing(v) for c, v in read_csv(data).items()}
    df = pd.read_csv(data).replace(r" ", np.nan).fillna("empty")
    cats, jcats = ["when", "class"], ["when", "class"]
    ours = split_date_columns(table, FORMATS, cats)
    theirs = jdates.split_date_columns(df, FORMATS, jcats)
    assert list(ours) == list(theirs.columns) and cats == jcats
    for col in ours:
        if col.startswith(("when-", "stamp-")):
            assert ours[col].tolist() == theirs[col].tolist(), col
    years = set(ours["when-year"].tolist()) | set(ours["stamp-year"])
    assert {"00", "04", "empty"} <= years


# part values (year, month, day): leap days, overruns, missing parts,
# 2000-2009 years
JOIN_ROWS = [
    ("24", "02", "29"), ("23", "02", "29"), ("00", "02", "30"),
    ("99", "02", "29"), ("23", "04", "31"), ("23", "01", "31"),
    ("05", "01", "31"), ("09", "12", "01"), ("01", "02", "31"),
    ("empty", "03", "01"), ("12", "empty", "09"), ("68", "11", "empty"),
    ("69", "06", "15"), ("00", "01", "01"),
]


@pytest.mark.parametrize("fmt", ["YYYY-MM-DD", "yymmdd|YYYY-MM-DD",
                                 "YYYY-MM-DD-hh", "DD-MM-YYYY"])
def test_join_matches_jax(fmt):
    _, d_format = jdates._parse_format(fmt)
    parts = part_columns("d", fmt)
    pick = {"YYYY": 0, "MM": 1, "DD": 2}
    cols = {"x": np.arange(len(JOIN_ROWS), dtype=np.float64)}
    for tok, name in zip(d_format.split("-"), parts):
        cols[name] = np.array([r[pick[tok]] if tok in pick else "07"
                               for r in JOIN_ROWS], dtype=object)
    ours = join_date_columns(cols, {"d": fmt})
    theirs = jdates.join_date_columns(pd.DataFrame(cols), {"d": fmt})
    assert list(ours) == list(theirs.columns) == ["x", "d"]
    got, want = ours["d"].tolist(), theirs["d"].tolist()
    assert got == want
    assert [type(v) for v in got if v != "empty"] == \
        [int if fmt.startswith("yymmdd") else dt.datetime] * 11
    if fmt.startswith("yymmdd"):
        assert got[6] == 50131 and got[13] == 101  # leading zeros lost


def test_join_without_a_day_raises_as_jax():
    cols = {"d-year": np.array(["24"], dtype=object),
            "d-month": np.array(["02"], dtype=object)}
    with pytest.raises(ValueError):
        jdates.join_date_columns(pd.DataFrame(cols), {"d": "YYYY-MM"})
    with pytest.raises(ValueError):
        join_date_columns(cols, {"d": "YYYY-MM"})


def test_unparseable_date_names_column_and_value():
    table = {"when": np.array(["2024-01-02", "next tuesday"], dtype=object)}
    with pytest.raises(ValueError, match="'when'.*'next tuesday'"):
        split_date_columns(table, {"when": "YYYY-MM-DD"}, [])
    # the formats the port reads besides ISO 8601
    out = split_date_columns(
        {"d": np.array(["2024/02/29", "02/28/2023", "2021-03-04T05:06:07"],
                       dtype=object)}, {"d": "YYYY-MM-DD-hh"}, [])
    assert out["d-year"].tolist() == ["24", "23", "21"]
    assert out["d-hour"].tolist() == ["00", "00", "05"]


def test_preprocessor_with_dates_matches_jax(prepared):
    pre, jpre, meta, enc, jmeta, jenc = prepared
    assert pre.local_meta() == jpre.local_meta()
    assert meta == jmeta
    assert pre.categorical_columns == jpre.categorical_columns
    np.testing.assert_array_equal(pre.encode(enc)[0], jpre.encode(jenc)[0])


@pytest.mark.parametrize("roundtrip", [False, True])
def test_dated_csv_bytes_equal_jax(prepared, roundtrip):
    """The port's CSV of a dated decode (both writers) equals JAX's
    ``csv_bytes(decode_matrix(...))`` on the same matrix: the training
    rows, with each part column shuffled on its own so that overruns
    (February 30, April 31) and partly missing dates occur."""
    pre, _, meta_d, enc, jmeta_d, jenc = prepared
    meta = TableMeta.from_json_dict(meta_d)
    jmeta = JaxMeta.from_json_dict(jmeta_d)
    if roundtrip:  # as served: the meta read back from its JSON file
        text = json.dumps(meta.to_json_dict(), sort_keys=True)
        meta = TableMeta.from_json_dict(json.loads(text))
        jmeta = JaxMeta.from_json_dict(json.loads(text))
        assert list(meta.date_info) == ["stamp", "when"]
    mat = pre.encode(enc)[0]
    rng = np.random.default_rng(4)
    for i, name in enumerate(meta.column_names):
        if name.startswith(("when-", "stamp-")):
            mat[:, i] = rng.permutation(mat[:, i])
    want = jax_csv_bytes(decode_matrix(mat, jmeta, jenc))
    assert csv_bytes(decode_columns(mat, meta, enc)) == want
    assert ColumnPlan(meta, enc).csv_bytes(
        decode_cells(mat, meta, enc)) == want
    header = want.split(b"\n", 1)[0].decode().split(",")
    assert header == output_columns(meta) and header[-2:] == list(
        meta.date_info)
    rows = list(csv.reader(io.StringIO(want.decode())))[1:]
    for j, col in enumerate(header[-2:]):
        cells = [r[len(header) - 2 + j] for r in rows]
        assert all(_valid_cell(c, meta.date_info[col]) for c in cells)
        assert " " in cells


def test_parse_date_formats_matches_jax():
    items = ["when=YYYY-MM-DD", "stamp=yymmdd|YYYY-MM-DD"]
    assert port_cli._parse_date_formats(items) == \
        jax_cli._parse_date_formats(items)
    for bad in (["when"], ["=YYYY"], ["when="]):
        with pytest.raises(SystemExit):
            port_cli._parse_date_formats(bad)
        with pytest.raises(SystemExit):
            jax_cli._parse_date_formats(bad)


# ------------------------------------------------------------- the CLI


@pytest.mark.parametrize("mode", ["fedavg", "standalone"])
def test_cli_date_format_trains_snapshots_and_serves(data, tmp_path, mode,
                                                     capsys):
    out = tmp_path / mode
    argv = ["--datapath", data, "--dataset", "intrusion", "--selected",
            *COLUMNS, "--mode", mode, "--n-clients", "2", "-epochs", "1",
            "--sample-rows", "200", "--batch-size", "50",
            "--embedding-dim", "16", "--eval", "--save-model",
            "--out-dir", str(out), "--seed", "1", "--device", "cpu",
            "--date-format", *(f"{k}={v}" for k, v in FORMATS.items())]
    assert port_cli.main(argv) == 0
    assert "final Avg_JSD=" in capsys.readouterr().out
    snap = next((out / "Intrusion_result").iterdir())
    rows = list(csv.reader(open(snap)))
    assert rows[0][-2:] == ["when", "stamp"] and len(rows) == 201
    for j, col in ((-2, "when"), (-1, "stamp")):
        assert all(_valid_cell(r[j], FORMATS[col]) for r in rows[1:])
    stats = os.path.join(out, "models", "reference_stats_Intrusion.json")
    assert os.path.exists(stats)
    # serving the artifact: the request's bytes are the decode of its rows
    model = open_model(str(out), device="cpu")
    assert model.meta.date_info == FORMATS
    engine = SamplingEngine(model)
    blob = engine.sample_csv_bytes(300, seed=5)
    assert blob == csv_bytes(decode_columns(
        engine.sample_decoded(300, seed=5), model.meta, model.encoders))
    served = list(csv.reader(io.StringIO(blob.decode())))
    assert served[0][-2:] == ["stamp", "when"]  # the meta's JSON order
    for j, col in ((-2, "stamp"), (-1, "when")):
        assert all(_valid_cell(r[j], FORMATS[col]) for r in served[1:])
