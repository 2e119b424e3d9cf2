"""The generated tables: the public schemas, their widths, and one table
per seed."""

import numpy as np
import pytest

from benchmark import tables
from benchmark.tables import covertype, intrusion


def test_intrusion_schema():
    t = tables.generate("intrusion", 4000, 7)
    assert list(t) == list(intrusion.COLUMNS) and len(t) == 42
    cat = [c for c in t if t[c].dtype == object]
    assert cat == list(intrusion.CATEGORICAL) and len(cat) == 20
    assert all(len(v) == 4000 for v in t.values())
    assert set(t["protocol_type"]) <= set(intrusion.PROTOCOLS)
    assert len(intrusion.SERVICES) == 70 and len(intrusion.FLAGS) == 11
    assert len(set(intrusion.SERVICES)) == 70
    assert (t["src_bytes"] >= 0).all() and (t["dst_bytes"] >= 0).all()


def test_covertype_schema():
    t = tables.generate("covertype", 5000, 7)
    assert list(t) == list(covertype.COLUMNS) and len(t) == 55
    assert [c for c in t if t[c].dtype == object] == ["Cover_Type"]
    area = np.stack([t[f"Wilderness_Area{j}"] for j in range(1, 5)], 1)
    soil = np.stack([t[f"Soil_Type{j}"] for j in range(1, 41)], 1)
    assert (area.sum(1) == 1).all() and (soil.sum(1) == 1).all()
    assert set(t["Cover_Type"]) <= {str(c) for c in range(1, 8)}
    assert sum(covertype.COVER) == 581_012


@pytest.mark.parametrize("name", ["intrusion", "covertype"])
def test_one_table_per_seed(name):
    a, b = tables.generate(name, 3000, 2**31 + 9), tables.generate(
        name, 3000, 2**31 + 9)
    c = tables.generate(name, 3000, 2**31 + 10)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("name,preset", [("intrusion", "intrusion"),
                                         ("covertype", "covertype")])
def test_schema_is_the_presets(name, preset):
    """The reference reads the schema from the table's module; the program
    from its dataset preset: the two agree."""
    from fed_tgan_torch.datasets import PRESETS

    mod = getattr(tables, name) if hasattr(tables, name) else None
    mod = mod or __import__(f"benchmark.tables.{name}", fromlist=["x"])
    p = PRESETS[preset]
    assert list(p.categorical_columns) == list(mod.CATEGORICAL)
    assert sorted(p.non_negative_columns) == sorted(mod.NON_NEGATIVE)
    assert list(p.selected_columns) in ([], list(mod.COLUMNS))
