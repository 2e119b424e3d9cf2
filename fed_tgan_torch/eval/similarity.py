"""Statistical similarity between a real and a synthetic table, without
pandas (counterpart of ``fed_tgan_tpu/eval/similarity.py:28-62``, the
reference's ``similarity_analysis.py``).

Tables are ``{name: column}`` as :func:`~fed_tgan_torch.data.csvio.read_csv`
returns them.

- categorical column: Jensen-Shannon distance (base 2) between the real
  category frequencies (sorted categories) and the fake ones, a category
  the fake side lacks counting 0; categories compare as their pandas
  string form, missing cells left out;
- continuous column: Wasserstein distance after min-max scaling fitted on
  the real column;
- ``avg_jsd`` and ``avg_wd`` average each kind.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.spatial import distance as _sdistance
from scipy.stats import wasserstein_distance

from fed_tgan_torch.data.csvio import cell_strings


def _frequencies(values) -> dict:
    strs = [s for s in cell_strings(values).tolist() if s is not None]
    counts: dict = {}
    for s in strs:
        counts[s] = counts.get(s, 0) + 1
    return {k: v / len(strs) for k, v in counts.items()}


def _floats(values) -> np.ndarray:
    values = np.asarray(values)
    if values.dtype.kind == "O":
        return np.array([np.nan if v is None else float(v)
                         for v in values.tolist()])
    return values.astype(np.float64)


def column_similarity(real, fake, categorical: bool) -> float:
    if categorical:
        rc, fc = _frequencies(real), _frequencies(fake)
        cats = sorted(rc)
        return float(_sdistance.jensenshannon(
            [rc[c] for c in cats], [fc.get(c, 0.0) for c in cats], 2.0))
    r, f = _floats(real), _floats(fake)
    lo, hi = r.min(), r.max()
    span = hi - lo if hi > lo else 1.0
    return float(wasserstein_distance((r - lo) / span, (f - lo) / span))


def statistical_similarity(real: dict, fake: dict,
                           categorical_columns: Sequence[str]):
    """``(avg_jsd, avg_wd, per_column)`` over the real table's columns."""
    cat = set(categorical_columns)
    per_column = {c: column_similarity(real[c], fake[c], c in cat)
                  for c in real}
    jsds = [v for c, v in per_column.items() if c in cat]
    wds = [v for c, v in per_column.items() if c not in cat]
    avg_jsd = float(np.mean(jsds)) if jsds else float("nan")
    avg_wd = float(np.mean(wds)) if wds else float("nan")
    return avg_jsd, avg_wd, per_column
