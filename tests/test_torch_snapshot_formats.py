"""``--snapshot-format feather|parquet``: the port's columnar snapshots
against the JAX package's ``_write_columnar`` on the same decoded matrix,
read back with pyarrow.

- the same column names, types, values and nulls, on the four paths the
  JAX writer takes: an Intrusion-shaped table (dictionary categoricals,
  float64 numbers), the same with a missing continuous cell and a
  missing category (the pandas path: ``large_string``, true nulls), a
  dated table (timestamps and ``yymmdd`` ints, a partly missing date
  null), and JAX's own missing-sentinel table
  (``tests/test_snapshots.py:172-210``).  JAX's pandas path adds a
  ``pandas`` key to the schema metadata, which the port does not write:
  schemas are compared without their metadata;
- the writer refuses an unknown format, and keeps the CSV's spelling
  (``' '``) in what ``drain`` returns;
- without pyarrow the CLI exits 2 naming it, before the backend probe and
  with no snapshot written.

A multi-process world writing ``--snapshot-format parquet`` snapshots is
``tests/test_torch_cli.py::test_multihost_launch_flags_run[parquet]``.
"""

import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from fed_tgan_torch import datasets as pdatasets
from fed_tgan_torch.data.constants import (
    CATEGORICAL,
    MISSING_CONTINUOUS,
    MISSING_TOKEN,
)
from fed_tgan_torch.data.decode import decode_columns
from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.schema import ColumnMeta, TableMeta
from fed_tgan_torch.datasets import INTRUSION_SELECTED
from fed_tgan_torch.federation.init import harmonize_categories
from fed_tgan_torch.serve.demo import write_dated_csv, write_intrusion_csv
from fed_tgan_torch.train.snapshots import (
    SnapshotWriter,
    columnar_table,
    write_columnar,
)
from fed_tgan_tpu import datasets as jdatasets
from fed_tgan_tpu.data.encoders import CategoryEncoder as JaxEncoder
from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
from fed_tgan_tpu.data.schema import TableMeta as JaxMeta
from fed_tgan_tpu.federation.init import harmonize_categories as jax_harm
from fed_tgan_tpu.train.snapshots import _write_columnar

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMATS = ("feather", "parquet")
DATES = {"when": "YYYY-MM-DD", "stamp": "yymmdd|YYYY-MM-DD"}


def _read(path: str, fmt: str) -> pa.Table:
    if fmt == "feather":
        return pa.ipc.open_file(path).read_all()
    return pq.read_table(path)


def _prepared(path: str, dated: bool):
    """(matrix, meta, encoders, JAX meta, JAX encoders) of a CSV's own
    rows, harmonized as a one-client federation."""
    def kw(module):
        k = module.preprocessor_kwargs(module.PRESETS["intrusion"])
        if dated:
            k.update(date_formats=dict(DATES),
                     selected_columns=[*INTRUSION_SELECTED, *DATES])
        return k

    pre = TablePreprocessor.from_csv(path, **kw(pdatasets))
    jpre = JaxPre.from_csv(path, **kw(jdatasets))
    meta, enc, _ = harmonize_categories([pre.local_meta()])
    jmeta, jenc, _ = jax_harm([jpre.local_meta()])
    return (pre.encode(enc)[0], TableMeta.from_json_dict(meta), enc,
            JaxMeta.from_json_dict(jmeta), jenc)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("columnar")
    out = {}
    mat, meta, enc, jmeta, jenc = _prepared(
        write_intrusion_csv(str(root / "i.csv"), 200, 0), dated=False)
    out["typed"] = (mat, meta, enc, jmeta, jenc)
    holes = mat.copy()
    holes[3, meta.column_names.index(meta.continuous_columns[0])] = (
        MISSING_CONTINUOUS)
    out["missing"] = (holes, meta, enc, jmeta, jenc)
    mat, meta, enc, jmeta, jenc = _prepared(
        write_dated_csv(str(root / "d.csv"), 200, 0), dated=True)
    rng = np.random.default_rng(4)  # overruns and partly missing dates
    for i, name in enumerate(meta.column_names):
        if name.startswith(("when-", "stamp-")):
            mat[:, i] = rng.permutation(mat[:, i])
    out["dated"] = (mat, meta, enc, jmeta, jenc)
    # JAX's own missing-sentinel table (tests/test_snapshots.py:172-210)
    classes = ["a", MISSING_TOKEN, "z"]
    sentinel = TableMeta(columns=[
        ColumnMeta(name="c", kind=CATEGORICAL, index=0, i2s=classes),
        ColumnMeta(name="x", kind="continuous", index=1, min=0.0, max=1.0)])
    out["sentinel"] = (
        np.asarray([[0.0, 0.5], [1.0, MISSING_CONTINUOUS], [2.0, 0.25]]),
        sentinel, [CategoryEncoder(classes_=np.asarray(classes,
                                                        dtype=object))],
        JaxMeta.from_json_dict(sentinel.to_json_dict()),
        [JaxEncoder(classes_=np.asarray(classes, dtype=object))])
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", ["typed", "missing", "dated", "sentinel"])
def test_columnar_snapshot_equals_jax(cases, tmp_path, case, fmt):
    mat, meta, enc, jmeta, jenc = cases[case]
    ours, theirs = str(tmp_path / f"port.{fmt}"), str(tmp_path / f"jax.{fmt}")
    write_columnar(mat, meta, enc, ours, fmt)
    _write_columnar(mat, jmeta, jenc, theirs, fmt)
    got, want = _read(ours, fmt), _read(theirs, fmt)
    assert got.column_names == want.column_names
    assert got.schema.remove_metadata().equals(want.schema.remove_metadata())
    assert got.to_pydict() == want.to_pydict()  # values, None for a null
    assert got.schema.metadata is None
    # the pandas path (and its metadata key) exactly where missing cells
    # or dates are
    assert (want.schema.metadata is not None) == (case != "typed")
    nulls = sum(c.null_count for c in got.columns)
    assert (nulls > 0) == (case != "typed")
    if case == "sentinel":
        assert got.to_pydict() == {"c": ["a", None, "z"],
                                   "x": [0.5, None, 0.25]}


def test_writer_refuses_unknown_formats_and_drains_the_csv_spelling(
        cases, tmp_path):
    mat, meta, enc, _, _ = cases["sentinel"]
    with pytest.raises(ValueError, match="snapshot format 'xlsx'"):
        SnapshotWriter(meta, enc, str, fmt="xlsx")
    table = columnar_table(mat, meta, enc)
    assert table.column("x").null_count == 1
    assert decode_columns(mat, meta, enc)["x"].tolist()[1] == " "


def _cli_argv(data, out):
    return ["--datapath", data, "--dataset", "intrusion", "--n-clients", "2",
            "-epochs", "1", "--sample-rows", "60", "--batch-size", "50",
            "--embedding-dim", "16", "--seed", "1", "--out-dir", str(out),
            "--snapshot-format", "parquet"]


def test_cli_without_pyarrow_exits_2_writing_nothing(cases, tmp_path):
    """No ``--device cpu``: a run that reached the probe would exit 3 on a
    host without a card."""
    data = write_intrusion_csv(str(tmp_path / "i.csv"), 200, 0)
    argv = _cli_argv(data, tmp_path / "out")
    code = ("import sys\n"
            "sys.modules['pyarrow'] = None\n"
            "from fed_tgan_torch.cli import main\n"
            f"sys.exit(main({argv!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert "--snapshot-format parquet needs pyarrow" in proc.stderr
    assert not (tmp_path / "out").exists()
