"""The port's standalone trainer end to end on the CPU, with the
assertions of ``tests/test_standalone.py``, its artifact served by the
port's serving path, and the pandas-free Intrusion-shaped table against
``tests/test_workloads.py::_intrusion_like``."""

import numpy as np
import pytest
import torch

from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.schema import ColumnMeta, TableMeta
from fed_tgan_torch.serve.demo import intrusion_like_table, write_artifact
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import open_model
from fed_tgan_torch.train.standalone import StandaloneSynthesizer
from fed_tgan_torch.train.steps import TrainConfig
from test_workloads import _intrusion_like

torch.set_num_threads(1)

SMALL = TrainConfig(embedding_dim=16, gen_dims=(32, 32), dis_dims=(32, 32),
                    batch_size=100)


@pytest.fixture(scope="module")
def table():
    """``tests/test_standalone.py``'s two-column table."""
    rng = np.random.default_rng(11)
    n = 1200
    cont = np.concatenate([rng.normal(-2, 0.5, n // 2),
                           rng.normal(3, 1.0, n - n // 2)])
    rng.shuffle(cont)
    cat = rng.choice([0, 1, 2], n, p=[0.7, 0.2, 0.1]).astype(float)
    return np.stack([cont, cat], axis=1)


@pytest.fixture(scope="module")
def trained(table):
    return StandaloneSynthesizer(config=SMALL, seed=0, device="cpu").fit(
        table, categorical_idx=[1], epochs=2)


def test_standalone_end_to_end(trained):
    out = trained.sample(700, seed=1)
    assert out.shape == (700, 2)
    # categorical codes are valid
    assert set(np.unique(out[:, 1])) <= {0.0, 1.0, 2.0}
    # continuous values land in a sane range around the real support
    assert out[:, 0].min() > -15 and out[:, 0].max() < 15
    # not mode-collapsed after 2 epochs: every class present with real mass
    counts = np.bincount(out[:, 1].astype(int), minlength=3) / len(out)
    assert (counts > 0.05).all()
    assert all(np.isfinite(v) for v in trained.metrics.values())
    assert len(trained.timings["epoch_s"]) == 2


def test_sampling_is_seeded_and_offset_addressable(trained):
    a = trained.sample_encoded(250, seed=3)
    assert np.array_equal(a, trained.sample_encoded(250, seed=3))
    assert not np.array_equal(a, trained.sample_encoded(250, seed=4))


def test_saved_model_serves(trained, tmp_path):
    meta = TableMeta(columns=[
        ColumnMeta("x", "continuous", 0, min=-5.0, max=7.0),
        ColumnMeta("c", "categorical", 1, i2s=["a", "b", "c"])], name="toy")
    enc = CategoryEncoder.fit(["a", "b", "c"])
    write_artifact(str(tmp_path), trained.to_saved(), meta, [enc])
    engine = SamplingEngine(open_model(str(tmp_path), device="cpu"))
    # the served stream is the trained model's own stream
    np.testing.assert_array_equal(engine.sample_encoded(300, seed=2),
                                  trained.sample_encoded(300, seed=2))
    one = engine.sample_csv_bytes(300, seed=2)
    parts = [engine.sample_csv_bytes(120, seed=2),
             engine.sample_csv_bytes(180, seed=2, offset=120, header=False)]
    assert b"".join(parts) == one
    rows = one.decode().splitlines()
    assert rows[0] == "x,c" and len(rows) == 301
    assert {r.split(",")[1] for r in rows[1:]} <= {"a", "b", "c"}
    # the saved generator is a copy in eval mode; training mode is kept
    assert trained.models.generator.training


def test_standalone_too_few_rows_raises(table):
    cfg = TrainConfig(batch_size=5000)
    with pytest.raises(ValueError):
        StandaloneSynthesizer(config=cfg, device="cpu").fit(
            table, categorical_idx=[1], epochs=1)


def test_standalone_defaults_to_the_card():
    if torch.cuda.is_available():
        assert StandaloneSynthesizer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StandaloneSynthesizer()


@pytest.mark.parametrize("n,seed", [(400, 0), (1000, 3)])
def test_intrusion_like_table_matches_the_pandas_generator(n, seed):
    df = _intrusion_like(n, seed)
    matrix, cat_idx, meta, encoders = intrusion_like_table(n, seed)
    assert meta.column_names == list(df.columns) and matrix.shape == (n, 42)
    assert len(cat_idx) == 20 and meta.categorical_columns == [
        df.columns[i] for i in cat_idx]
    for i, name in enumerate(df.columns):
        if i in cat_idx:
            enc = encoders[cat_idx.index(i)]
            np.testing.assert_array_equal(
                enc.inverse_transform(matrix[:, i].astype(int)),
                df[name].astype(str).to_numpy())
            counts = df[name].value_counts()
            assert meta.columns[i].i2s[0] == counts.index[0]
        else:
            want = df[name].to_numpy(float)
            if name in meta.non_negative_columns:  # the ingest's log(x + 1)
                want = np.log(want + 1.0)
            np.testing.assert_array_equal(matrix[:, i], want)
