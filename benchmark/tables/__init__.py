"""Table generators, one module per table, found by name.

Each module defines ``generate(rows, seed) -> {column: numpy array}``:
categorical columns as object arrays of strings, every other column as
float64, in the public schema's column order.  The same ``(rows, seed)``
gives the same table.
"""

from __future__ import annotations

import importlib


def generate(name: str, rows: int, seed: int) -> dict:
    """The table ``name`` (a module of this package) at ``rows`` rows."""
    return importlib.import_module(f"{__name__}.{name}").generate(rows, seed)


def categorical_draw(rng, values, weights, n: int):
    """``n`` draws of ``values`` (strings) with probabilities ``weights``
    (normalised here), as an object array."""
    import numpy as np

    p = np.asarray(weights, dtype=np.float64)
    idx = rng.choice(len(values), size=n, p=p / p.sum())
    return np.asarray(values, dtype=object)[idx]
