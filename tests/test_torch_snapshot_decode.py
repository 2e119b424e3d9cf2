"""The port's snapshot decodes (packed8, packed16, exact) against
``fed_tgan_tpu/ops/decode.py`` on the same activated rows, the snapshot
writer's error path, and its reuse of host buffers under thread switches.

Tolerance: packed parts equal as integers, assembled values equal
(float64, the same formula on the same tables); exact values equal.
"""

import sys

import numpy as np
import pytest
import torch

from fed_tgan_torch.data.csvio import plain_csv_bytes
from fed_tgan_torch.data.decode import decode_columns
from fed_tgan_torch.features.bgm import ColumnGMM
from fed_tgan_torch.features.transformer import ModeNormalizer
from fed_tgan_torch.ops.decode import SnapshotDecode, select_snapshot_decode
from fed_tgan_torch.serve.demo import intrusion_layout
from fed_tgan_torch.train.snapshots import MAX_PENDING, SnapshotWriter
from fed_tgan_tpu.features.bgm import ColumnGMM as JaxGMM
from fed_tgan_tpu.features.transformer import ModeNormalizer as JaxNormalizer
from fed_tgan_tpu.ops import decode as jdecode


def normalizers():
    """Both packages' normalizers over one table with the same mixtures:
    two continuous columns (3 and 2 active modes) and two discrete ones
    (one with negative and wide codes)."""
    rng = np.random.default_rng(0)
    n = 400
    data = np.stack([
        np.concatenate([rng.normal(-3, .3, 150), rng.normal(0, .3, 150),
                        rng.normal(4, .3, 100)]),
        rng.choice([5.0, -2.0, 300.0], n),
        np.concatenate([rng.normal(-1, .2, 200), rng.normal(6, .5, 200)]),
        rng.integers(0, 4, n).astype(float),
    ], axis=1)
    ours = ModeNormalizer(device="cpu").fit(data, categorical_idx=[1, 3])
    gmms = {j: JaxGMM(means=g.means, stds=g.stds, weights=g.weights,
                      active=g.active, mean_precision=g.mean_precision,
                      dof=g.dof, stick_a=g.stick_a, stick_b=g.stick_b)
            for j, g in enumerate(ours.gmms) if isinstance(g, ColumnGMM)}
    theirs = JaxNormalizer().fit(data, categorical_idx=[1, 3],
                                 column_gmms=gmms)
    return ours, theirs


def activated_rows(info, n=257, seed=1):
    """Rows with exact argmax ties, clipped and half-step ``u`` values."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, (n, sum(s for s, _ in info))).astype(np.float32)
    st = 0
    for size, kind in info:
        if kind == "tanh":
            x[:8, st] = np.asarray([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 63.5,
                                    -63.5], dtype=np.float32) / 127
        elif size > 1:
            x[:4, st:st + size] = 0.25  # every slot tied
        st += size
    return x


@pytest.mark.parametrize("mode,jax_fn", [
    ("packed8", jdecode.make_device_decode_packed8),
    ("packed16", jdecode.make_device_decode_packed16),
    ("exact", jdecode.make_device_decode_packed)])
def test_snapshot_decode_matches_jax(mode, jax_fn):
    ours, theirs = normalizers()
    assert ours.output_info == theirs.output_info
    x = activated_rows(ours.output_info)
    dec = select_snapshot_decode(ours.columns, mode)
    parts = {k: v.numpy() for k, v in dec.decode(torch.from_numpy(x)).items()}
    jfn, jassemble = jax_fn(theirs.columns)
    jparts = {k: np.asarray(v) for k, v in jfn(x).items()}
    if mode != "exact":
        assert parts.keys() == jparts.keys()
        for k in parts:
            assert parts[k].dtype == jparts[k].dtype, k
            np.testing.assert_array_equal(parts[k], jparts[k], err_msg=k)
    np.testing.assert_array_equal(dec.assemble(parts), jassemble(jparts))


def test_disc_dtype_widens_and_default_is_packed8():
    ours, _ = normalizers()
    dec = select_snapshot_decode(ours.columns, None)
    assert dec.mode == "packed8" and dec.int_dtype == torch.int16
    with pytest.raises(ValueError, match="packed8"):
        SnapshotDecode(ours.columns, "packed4")


class _Boom:
    decode = SnapshotDecode([], "exact")

    def sample_parts(self, n, seed=0, to_host=True):
        return {"values": torch.zeros((n, 0))}


def test_writer_reraises_worker_errors(tmp_path):
    writer = SnapshotWriter(None, [], lambda e: str(tmp_path / "x.csv"),
                            rows=3)
    writer(0, _Boom())  # the column plan of meta=None fails on the worker
    with pytest.raises(AttributeError):
        writer.drain()
    writer.close()


class _Stream:
    """A trainer whose snapshot parts are a function of the seed alone."""

    def __init__(self):
        self.meta, self.encoders, columns = intrusion_layout(
            np.random.default_rng(0))
        self.decode = SnapshotDecode(columns, "packed8")

    def parts(self, n, seed):
        rng = np.random.default_rng(seed)
        cols = self.decode.columns
        k = [rng.integers(0, c.n_active, n) for c in cols
             if hasattr(c, "n_active")]
        d = [rng.choice(c.codes, n) for c in cols if hasattr(c, "codes")]
        return {"u": rng.integers(-127, 128, (n, len(k))).astype(np.int8),
                "k": np.stack(k, 1).astype(np.int8),
                "disc": np.stack(d, 1).astype(np.int16)}

    def sample_parts(self, n, seed=0, to_host=True):
        return {k: torch.from_numpy(v) for k, v in self.parts(n, seed).items()}


def test_writer_reuses_buffers_without_mixing_snapshots(tmp_path):
    """Many snapshots through the writer's reused host buffer sets, with
    the interpreter switching threads as often as it can: each file holds
    exactly its own rows."""
    stream = _Stream()
    path_fn = lambda e: str(tmp_path / f"s{e}.csv")  # noqa: E731
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with SnapshotWriter(stream.meta, stream.encoders, path_fn, rows=300,
                            seed=5) as writer:
            for e in range(24):
                writer(e, stream)
            last = writer.drain()
            assert len(writer._free) == MAX_PENDING
    finally:
        sys.setswitchinterval(old)
    for e in range(24):
        want = decode_columns(stream.decode.assemble(stream.parts(300, 5 + e)),
                              stream.meta, stream.encoders)
        assert open(path_fn(e), "rb").read() == plain_csv_bytes(want), e
    for name in want:
        np.testing.assert_array_equal(last[name], want[name])
