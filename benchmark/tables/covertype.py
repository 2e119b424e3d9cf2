"""A Covertype (UCI) table at the public schema's widths.

The 55 columns of ``covtype.data``: 10 quantitative columns,
``Wilderness_Area1-4`` and ``Soil_Type1-40`` as 0/1 columns (one of each
group set per row) and ``Cover_Type`` (7 classes).  The class, area and
soil shares follow the UCI table's counts; each quantitative column is
drawn around the real column's mean and spread, ``Elevation`` shifted by
the class, and rounded to integers as the real columns are.
"""

from __future__ import annotations

import numpy as np

from benchmark.tables import categorical_draw

QUANTITATIVE = (
    # name, mean, standard deviation, low, high
    ("Elevation", 2959.0, 280.0, 1859.0, 3858.0),
    ("Aspect", 155.7, 111.9, 0.0, 360.0),
    ("Slope", 14.1, 7.5, 0.0, 66.0),
    ("Horizontal_Distance_To_Hydrology", 269.4, 212.5, 0.0, 1397.0),
    ("Vertical_Distance_To_Hydrology", 46.4, 58.3, -173.0, 601.0),
    ("Horizontal_Distance_To_Roadways", 2350.1, 1559.3, 0.0, 7117.0),
    ("Hillshade_9am", 212.1, 26.8, 0.0, 254.0),
    ("Hillshade_Noon", 223.3, 19.8, 0.0, 254.0),
    ("Hillshade_3pm", 142.5, 38.3, 0.0, 254.0),
    ("Horizontal_Distance_To_Fire_Points", 1980.3, 1324.2, 0.0, 7173.0),
)
WILDERNESS = (260796, 29884, 253364, 36968)
SOIL = (3031, 7525, 4823, 12396, 1597, 6575, 105, 179, 1147, 32634, 12410,
        29971, 17431, 599, 3, 2845, 3422, 1899, 4021, 9259, 838, 33373,
        57752, 21278, 474, 2589, 1086, 946, 115247, 30170, 25666, 52519,
        45154, 1611, 1891, 119, 298, 15573, 13806, 8750)
COVER = (211840, 283301, 35754, 2747, 9493, 17367, 20510)
# the class's shift of Elevation (the real classes sit at different heights)
COVER_ELEVATION = (200.0, 0.0, -500.0, -800.0, -200.0, -450.0, 400.0)


def _one_hot(prefix: str, idx: np.ndarray, k: int) -> dict:
    return {f"{prefix}{j + 1}": (idx == j).astype(np.float64)
            for j in range(k)}


def generate(rows: int, seed: int) -> dict:
    rng = np.random.default_rng([seed, 0xC0F])
    cover = rng.choice(len(COVER), size=rows,
                       p=np.asarray(COVER) / sum(COVER))
    out = {}
    for name, mean, sd, lo, hi in QUANTITATIVE:
        x = rng.normal(mean, sd, rows)
        if name == "Elevation":
            x = x + np.asarray(COVER_ELEVATION)[cover]
        out[name] = np.round(np.clip(x, lo, hi))
    out.update(_one_hot("Wilderness_Area", rng.choice(
        len(WILDERNESS), size=rows,
        p=np.asarray(WILDERNESS) / sum(WILDERNESS)), len(WILDERNESS)))
    out.update(_one_hot("Soil_Type", rng.choice(
        len(SOIL), size=rows, p=np.asarray(SOIL) / sum(SOIL)), len(SOIL)))
    out["Cover_Type"] = np.asarray([str(c) for c in range(1, 8)],
                                   dtype=object)[cover]
    return out


COLUMNS = (tuple(q[0] for q in QUANTITATIVE)
           + tuple(f"Wilderness_Area{j + 1}" for j in range(len(WILDERNESS)))
           + tuple(f"Soil_Type{j + 1}" for j in range(len(SOIL)))
           + ("Cover_Type",))
CATEGORICAL = ("Cover_Type",)
NON_NEGATIVE = ()
