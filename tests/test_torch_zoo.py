"""The port's encoder zoo against ``fed_tgan_tpu.features.zoo`` on one
seeded table: a bimodal continuous column, a categorical column whose
four categories tie in count, an ordinal column, and (for the metadata) a
column with missing cells.

For each of the five encoders (min-max in both activations) on the CPU:
the metadata equal (``i2s`` order with ties in first-appearance order,
min and max), ``output_info`` equal, ``transform`` equal (float32 or
int64, atol 0: the mixtures are the same sklearn fits and the mode draws
the same seeded stream) and ``inverse_transform`` equal.  Without a card,
an encoder left on its default device (the card) raises.
"""

import numpy as np
import pytest
import torch

from fed_tgan_torch.features import zoo as port_zoo
from fed_tgan_tpu.features import zoo as jax_zoo

torch.set_num_threads(1)
COLUMNS = dict(categorical_columns=(1,), ordinal_columns=(2,))
ENCODERS = {
    "binning": ("BinningTransformer", (16,), {}),
    "minmax_sigmoid": ("MinMaxTransformer", ("sigmoid",), {}),
    "minmax_tanh": ("MinMaxTransformer", ("tanh",), {}),
    "gmm": ("GMMTransformer", (4,), {"seed": 2}),
    "bgm": ("BGMTransformer", (10,), {"seed": 2}),
    "grid": ("GridTransformer", (2,), {}),
}


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(0)
    n = 400
    cont = np.concatenate([rng.normal(-4, 0.5, n // 2),
                           rng.normal(3, 1.0, n // 2)])
    rng.shuffle(cont)
    cat = np.array(["a", "b", "c", "d"] * (n // 4), dtype=object)
    rng.shuffle(cat)  # every category 100 times: ties throughout
    data = np.empty((n, 3), dtype=object)
    data[:, 0] = cont
    data[:, 1] = cat
    data[:, 2] = rng.integers(0, 5, size=n)
    return data


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.tolist() == b.tolist()


def test_meta_equals_jax_with_ties_and_missing_cells(table):
    meta = port_zoo.infer_zoo_meta(table, **COLUMNS)
    jmeta = jax_zoo.infer_zoo_meta(table, **COLUMNS)
    assert [vars(m) for m in meta] == [vars(m) for m in jmeta]
    assert meta[1].i2s == ["d", "b", "c", "a"]  # ties: first appearance
    holes = np.array([["b", 2.0], [None, np.nan], ["a", 1.0], ["c", 5.0],
                      ["a", -1.5], ["c", np.nan], ["b", 0.0], ["d", 3.0]],
                     dtype=object)
    got = port_zoo.infer_zoo_meta(holes, categorical_columns=(0,))
    want = jax_zoo.infer_zoo_meta(holes, categorical_columns=(0,))
    assert [vars(m) for m in got] == [vars(m) for m in want]
    assert got[0].i2s == ["b", "a", "c", "d"] and got[1].min == -1.5


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_equals_jax(table, name):
    cls, args, seeded = ENCODERS[name]
    fit_kw = dict(COLUMNS, **seeded)
    ours = getattr(port_zoo, cls)(*args, device="cpu")
    theirs = getattr(jax_zoo, cls)(*args)
    ours.fit(table, **fit_kw)
    theirs.fit(table, **fit_kw)
    assert [vars(m) for m in ours.meta] == [vars(m) for m in theirs.meta]
    assert getattr(ours, "output_info", None) == getattr(
        theirs, "output_info", None)
    transform_kw = {"seed": 5} if name == "bgm" else {}
    enc = ours.transform(table, **transform_kw)
    want = theirs.transform(table, **transform_kw)
    assert isinstance(enc, torch.Tensor) and enc.device.type == "cpu"
    assert enc.numpy().dtype == want.dtype
    np.testing.assert_array_equal(enc.numpy(), want)
    dec = ours.inverse_transform(enc)
    assert dec.dtype == object
    assert _same(dec, theirs.inverse_transform(want))
    assert _same(ours.inverse_transform(want), dec)  # arrays too


@pytest.mark.parametrize("cls", ["BinningTransformer", "MinMaxTransformer",
                                 "GMMTransformer", "BGMTransformer",
                                 "GridTransformer"])
def test_default_device_is_the_card(cls):
    args = {"BinningTransformer": (8,), "GridTransformer": (2,)}.get(cls, ())
    if torch.cuda.is_available():
        assert getattr(port_zoo, cls)(*args).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(port_zoo, cls)(*args)
