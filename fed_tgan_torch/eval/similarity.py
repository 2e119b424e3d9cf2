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

:func:`similarity_report` and the module CLI (``python -m
fed_tgan_torch.eval.similarity --real T.csv --result-dir D --name N
[--categorical ...] [--timing timestamp_experiment.csv] [-o OUT]``) run
the reference's offline workflow over a run's snapshot CSVs
(``fed_tgan_tpu/eval/similarity.py:65-145``); the report's CSV is
byte-equal to the JAX package's ``to_csv(index=False)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy.spatial import distance as _sdistance
from scipy.stats import wasserstein_distance

from fed_tgan_torch.data.csvio import cell_strings, plain_csv_bytes, read_csv


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


def similarity_report(real_path: str, fake_paths: Sequence[str],
                      categorical_columns: Sequence[str],
                      epoch_times: Optional[Sequence[float]] = None) -> dict:
    """The per-snapshot report (``fed_tgan_tpu/eval/similarity.py:65-82``)
    as ``{column: array}``: ``Epoch_No.`` (0, 1, ... in ``fake_paths``
    order), ``Avg_JSD``, ``Avg_WD`` and, with ``epoch_times``, the
    cumulative ``time_stamp``.  The real table and each snapshot are read
    on their own, so a column is typed per file as ``pandas.read_csv``
    types it."""
    real = read_csv(real_path)
    rows = [statistical_similarity(real, read_csv(fp),
                                   categorical_columns)[:2]
            for fp in fake_paths]
    report = {
        "Epoch_No.": np.arange(len(rows), dtype=np.int64),
        "Avg_JSD": np.array([r[0] for r in rows], dtype=np.float64),
        "Avg_WD": np.array([r[1] for r in rows], dtype=np.float64),
    }
    if epoch_times is not None:
        report["time_stamp"] = np.cumsum(np.asarray(epoch_times, dtype=float))
    return report


def report_csv_bytes(report: dict) -> bytes:
    """A report's CSV bytes, those of pandas' ``to_csv(index=False)`` of
    the same frame: integers as they are, floats in their shortest
    round-trip form, NaN as an empty cell."""
    cells = {}
    for name, values in report.items():
        values = np.asarray(values)
        if values.dtype.kind == "f":
            values = np.array(["" if v != v else v for v in values.tolist()],
                              dtype=object)
        cells[name] = values
    return plain_csv_bytes(cells)


def _main(argv=None) -> int:
    """Offline similarity analysis over a run's per-epoch snapshots (the
    reference's ``similarity_analysis.py`` workflow,
    ``fed_tgan_tpu/eval/similarity.py:85-145``), with the same flags,
    messages and exit codes."""
    import argparse
    import glob
    import os
    import re

    p = argparse.ArgumentParser(
        description="Per-epoch Avg_JSD/Avg_WD report over synthesis snapshots")
    p.add_argument("--real", required=True, help="real table CSV")
    p.add_argument("--result-dir", required=True,
                   help="directory with <name>_synthesis_epoch_<i>.csv files")
    p.add_argument("--name", required=True, help="run/dataset name prefix")
    p.add_argument("--categorical", nargs="*", default=[])
    p.add_argument("--timing", default=None,
                   help="timestamp_experiment.csv (one wall-clock per round)")
    p.add_argument("-o", "--out", default=None,
                   help="output CSV (default <result-dir>/"
                        "<name>_statistical_similarity_analysis.csv)")
    args = p.parse_args(argv)

    pat = re.compile(rf"{re.escape(args.name)}_synthesis_epoch_(\d+)\.csv$")
    found = []
    for f in glob.glob(os.path.join(args.result_dir,
                                    f"{args.name}_synthesis_epoch_*.csv")):
        m = pat.search(f)
        if m:
            found.append((int(m.group(1)), f))
    if not found:
        print(f"no {args.name}_synthesis_epoch_*.csv under {args.result_dir}")
        return 2
    found.sort()
    epochs, paths = zip(*found)

    cum_at = None
    if args.timing:
        with open(args.timing) as f:
            per_round = [float(line.split(",")[0]) for line in f
                         if line.strip()]
        if per_round:
            # snapshots may be sparser than rounds (--sample-every): each
            # is charged the cumulative time up to its round
            cum = np.cumsum(per_round)
            cum_at = [cum[min(e, len(cum) - 1)] for e in epochs]
        else:
            print(f"note: {args.timing} is empty; omitting time_stamp column")

    report = similarity_report(args.real, list(paths), args.categorical)
    report["Epoch_No."] = np.asarray(epochs, dtype=np.int64)
    if cum_at is not None:
        report["time_stamp"] = np.asarray(cum_at, dtype=np.float64)
    out = args.out or os.path.join(
        args.result_dir, f"{args.name}_statistical_similarity_analysis.csv")
    blob = report_csv_bytes(report)
    with open(out, "wb") as f:
        f.write(blob)
    print(blob.decode(), end="")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
