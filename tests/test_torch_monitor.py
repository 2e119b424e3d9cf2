"""The port's similarity monitor (``fed_tgan_torch.train.monitor``)
against ``fed_tgan_tpu.train.monitor`` on the CPU.

- The real-side constants (``p_real`` per categorical column; ``lo``,
  ``span`` and the sorted scaled sample per continuous column) equal the
  JAX package's bit for bit, missing values included.
- ``metrics_fn`` on one decoded matrix (a non-negative log column and a
  column with missing values among its inputs) equals JAX's within atol
  1e-6, column by column.
- ``evaluate`` on a port trainer (a table without missing values) equals
  the offline metric (``eval/similarity``) on the same rows within 1e-6
  for the categorical part, and scipy's W1 against the monitor's own real
  sample for the continuous part (``tests/test_monitor.py:29``).
- ``MonitorLog`` writes the JAX package's bytes.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import wasserstein_distance

from fed_tgan_torch.data.decode import decode_columns
from fed_tgan_torch.eval.similarity import column_similarity
from fed_tgan_torch.interop import federated_init_from_jax
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.federated import FederatedTrainer
from fed_tgan_torch.train.monitor import MonitorLog, SimilarityMonitor
from fed_tgan_tpu.train import monitor as jmonitor

torch.set_num_threads(1)
N_ROWS = 400
CFG = dict(embedding_dim=8, gen_dims=(16, 16), dis_dims=(16, 16),
           batch_size=40, pac=4)


@pytest.fixture(scope="module")
def dirty_frame(toy_frame):
    """The toy table with missing values: blank categories and a
    continuous column with NaN cells (its mixture gets the sentinel mode)."""
    df = toy_frame.copy()
    df["score"] = df["score"].astype(float)
    df.loc[df.index[5:40], "score"] = np.nan
    df.loc[df.index[:20], "color"] = np.nan
    return df


def as_table(frame) -> dict:
    out = {}
    for c in frame:
        col = frame[c]
        if pd.api.types.is_numeric_dtype(col):
            out[c] = col.to_numpy()
        else:
            out[c] = np.array([None if v is None or v != v else v
                               for v in col.tolist()], dtype=object)
    return out


def jax_and_port_init(frame, toy_spec):
    from fed_tgan_tpu.data.ingest import TablePreprocessor
    from fed_tgan_tpu.data.sharding import shard_dataframe
    from fed_tgan_tpu.federation.init import federated_initialize

    frames = shard_dataframe(frame, 2, "iid", seed=0)
    jinit = federated_initialize(
        [TablePreprocessor(frame=f, name="toy", **toy_spec) for f in frames],
        seed=0, backend="jax")
    return jinit, federated_init_from_jax(jinit)


@pytest.fixture(scope="module")
def inits(dirty_frame, toy_spec):
    return jax_and_port_init(dirty_frame, toy_spec)


@pytest.fixture(scope="module")
def monitors(inits, dirty_frame):
    jinit, init = inits
    jmon = jmonitor.SimilarityMonitor(jinit.global_meta, jinit.encoders,
                                      dirty_frame, n_rows=N_ROWS, seed=0)
    mon = SimilarityMonitor(init.global_meta, init.encoders,
                            as_table(dirty_frame), n_rows=N_ROWS, seed=0,
                            device="cpu")
    return jmon, mon


def test_real_side_constants_equal_jax(monitors):
    jmon, mon = monitors
    assert mon._cat_names == jmon._cat_names
    assert mon._cont_names == jmon._cont_names
    for (i, p), (ji, jp) in zip(mon._cats, jmon._cats):
        assert i == ji
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    for (i, lo, span, srt, log), (ji, jlo, jspan, jsrt, jlog) in zip(
            mon._conts, jmon._conts):
        assert (i, lo, span, log) == (ji, jlo, jspan, jlog)
        np.testing.assert_array_equal(srt.numpy(), np.asarray(jsrt))
    assert [log for *_, log in mon._conts] == [True, False]  # amount: log


def decoded_matrix(init, seed: int) -> np.ndarray:
    """A (N_ROWS, n_columns) decoded-layout matrix: valid codes for the
    categorical columns, log-space values for ``amount`` (some below
    zero), a ``score`` column with sentinel rows and outliers."""
    rng = np.random.default_rng(seed)
    meta = init.global_meta
    out = np.zeros((N_ROWS, len(meta.columns)), dtype=np.float32)
    cats = list(meta.categorical_columns)
    for j, col in enumerate(meta.columns):
        if not col.is_continuous:
            k = len(init.encoders[cats.index(col.name)].classes_)
            out[:, j] = rng.integers(0, k, N_ROWS)
        elif col.name == "amount":
            out[:, j] = rng.normal(2.0, 1.5, N_ROWS)
        else:
            v = rng.normal(0.0, 3.0, N_ROWS)
            v[:25] = -999999.0
            v[25:30] = 50.0
            out[:, j] = v
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_fn_matches_jax(inits, monitors, seed):
    _, init = inits
    jmon, mon = monitors
    mat = decoded_matrix(init, seed)
    got = mon.metrics_fn(torch.as_tensor(mat))
    want = jmon.metrics_fn(jnp.asarray(mat))
    for k in ("avg_jsd", "avg_wd", "jsd_cols", "wd_cols"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)


def test_evaluate_matches_offline_metric(toy_frame, toy_spec):
    """On the table without missing values: the offline metric leaves
    missing cells out, the monitor counts them as the 'empty' category."""
    _, init = jax_and_port_init(toy_frame, toy_spec)
    mon = SimilarityMonitor(init.global_meta, init.encoders,
                            as_table(toy_frame), n_rows=N_ROWS, seed=0,
                            device="cpu")
    tr = FederatedTrainer(init, steps.TrainConfig(**CFG), seed=0,
                          device="cpu").fit(1)
    dev = mon.evaluate(tr, seed=7)
    assert dev == mon.evaluate(tr, seed=7)  # deterministic
    assert set(dev["per_column_jsd"]) == {"color", "flag"}
    rows = mon.decoded(tr, seed=7).numpy()
    assert rows.shape == (N_ROWS, 4)
    fake = decode_columns(rows.astype(np.float64), init.global_meta,
                          init.encoders)
    real = as_table(toy_frame)
    host = {c: column_similarity(real[c], fake[c], True)
            for c in init.global_meta.categorical_columns}
    for c, v in host.items():
        assert abs(dev["per_column_jsd"][c] - v) <= 1e-6, c
    assert abs(dev["avg_jsd"] - np.mean(list(host.values()))) <= 1e-6
    wds = []
    for i, lo, span, srt, _ in mon._conts:
        name = init.global_meta.column_names[i]
        f = np.clip((np.asarray(fake[name], dtype=np.float64) - lo) / span,
                    -1.0, 2.0)
        wds.append(wasserstein_distance(srt.numpy().astype(np.float64), f))
    np.testing.assert_allclose(dev["avg_wd"], np.mean(wds), atol=1e-6)


def test_monitor_log_bytes_equal_jax(tmp_path):
    rows = [(0, 0.1234567891, 0.5), (1, float("nan"), 2.0), (2, 1e-9, 0.25)]
    for cls, name in ((MonitorLog, "port.csv"),
                      (jmonitor.MonitorLog, "jax.csv")):
        path = str(tmp_path / name)
        with cls(path) as log:  # a run, then a resumed run appending
            log.append(*rows[0])
        with cls(path) as log:
            for r in rows[1:]:
                log.append(*r)
        with cls(str(tmp_path / f"never_{name}")):
            pass
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    assert not (tmp_path / "never_port.csv").exists()
