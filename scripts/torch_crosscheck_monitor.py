"""Cross-check the port's on-device similarity monitor against the offline
evaluation (counterpart of ``scripts/crosscheck_monitor.py``).

The monitor (``fed_tgan_torch/train/monitor.py``) estimates Avg_JSD and
Avg_WD on the device with a sampled Wasserstein distance and its own
generation draw; the offline report (``fed_tgan_torch/eval/similarity.py``)
computes the reference-exact metrics over the written snapshot CSVs.
Both estimate the same model at the same round, so their per-round gap
bounds the monitor's approximation error.

Usage, after a CLI run with both ``--monitor-every N`` and
``--sample-every N``:

    python -m fed_tgan_torch.eval.similarity --real <train.csv> \\
        --result-dir <out>/<name>_result --name <name> --categorical ...
    python scripts/torch_crosscheck_monitor.py \\
        --monitor-csv <out>/monitor_similarity.csv \\
        --similarity-csv <out>/<name>_result/<name>_statistical_similarity_analysis.csv

Prints one JSON line with the joined-round count and the max and mean
absolute gaps per metric, with the JAX script's keys and rounding.  The
two CSVs are inner-joined on ``Epoch_No.``; an empty join exits with the
JAX script's message.  Imports neither pandas nor torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _nan_max_mean(d):
    """pandas' ``Series.max()`` and ``.mean()`` (NaN skipped; NaN when
    every value is)."""
    import numpy as np

    keep = ~np.isnan(d)
    if not keep.any():
        return float("nan"), float("nan")
    return float(d[keep].max()), float(np.where(keep, d, 0.0).sum()
                                       / keep.sum())


def crosscheck(monitor_csv: str, similarity_csv: str) -> dict:
    import numpy as np

    from fed_tgan_torch.data.csvio import read_csv

    mon, off = read_csv(monitor_csv), read_csv(similarity_csv)
    by_epoch: dict = {}
    for k, e in enumerate(off["Epoch_No."].tolist()):
        by_epoch.setdefault(e, []).append(k)
    # the inner join on Epoch_No., in the monitor log's order
    pairs = [(i, k) for i, e in enumerate(mon["Epoch_No."].tolist())
             for k in by_epoch.get(e, ())]
    if not pairs:
        raise SystemExit(
            "no common rounds between the monitor log and the offline "
            "report — run the CLI with matching --monitor-every and "
            "--sample-every cadences")
    left, right = (np.array(ix) for ix in zip(*pairs))

    def gap(metric):
        a = np.asarray(mon[metric], dtype=np.float64)[left]
        b = np.asarray(off[metric], dtype=np.float64)[right]
        return _nan_max_mean(np.abs(a - b))

    max_jsd, mean_jsd = gap("Avg_JSD")
    max_wd, mean_wd = gap("Avg_WD")
    return {
        "metric": "monitor_vs_offline_similarity_gap",
        "rounds_compared": len(pairs),
        "max_abs_jsd_gap": round(max_jsd, 5),
        "mean_abs_jsd_gap": round(mean_jsd, 5),
        "max_abs_wd_gap": round(max_wd, 5),
        "mean_abs_wd_gap": round(mean_wd, 5),
        "final_round": int(np.asarray(mon["Epoch_No."])[left].max()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--monitor-csv", required=True)
    ap.add_argument("--similarity-csv", required=True)
    args = ap.parse_args(argv)
    print(json.dumps(crosscheck(args.monitor_csv, args.similarity_csv)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
