#!/usr/bin/env python3
"""Run-level quality record of the PyTorch port: long runs of its
federated CLI, read by the similarity monitor and the final evaluation.

    python3 scripts/torch_quality.py --runs iid:0,iid:1 --label parent \
        --out runs/quality.jsonl [--tree DIR] [--parallel]
    python3 scripts/torch_quality.py --runs adult:0 --smoke   # CPU rehearsal

Runs (``kind:seed``), each ``python -m fed_tgan_torch --mode fedavg`` in a
process of its own, ``--monitor-every 50 --sample-every 0 --eval`` over
500 rounds:

- ``iid``: ``serve/demo.py::write_intrusion_csv(20_000, 0)``, the
  Intrusion preset, 4 IID clients, a 20,000-row final snapshot;
- ``adult``: ``serve/demo.py::write_adult_csv`` of the 7,000-row
  Adult-shaped table (the table ``bench.py::_adult_like(7000)`` makes),
  its first 70% as the training data, the Adult preset, 8 Dirichlet
  clients (alpha 0.5) with ``--allow-zero-step-clients``, a 4,900-row
  final snapshot.

``--tree DIR`` runs the ``fed_tgan_torch`` package under DIR (another
commit, unpacked with ``git archive``); the data always comes from this
tree.  Each run appends one JSON line to ``--out``: its monitor reads
(round, Avg_JSD, Avg_WD), the final evaluation, seconds per round, the
rows per shard, and the card's ``nvidia-smi`` name and power limit.
``--smoke`` shrinks every run (600 rows, 2 rounds, narrow model) and runs
it on the CPU, to rehearse the script; its lines are no measurement.

``--summarize FILE`` reads such lines and prints the record's checks:
(a) for the IID runs, the mean over the monitored rounds of |change -
parent| (seed 0) against the mean of |parent seed 0 - parent seed 1|, per
metric, passing at most 2x; (b) each non-IID run's final Avg_JSD and
Avg_WD against the JAX package's 500-round runs (``ADULT_ROWS_r04.jsonl``,
7,000 rows): within [min - 2s, max + 2s], s the JAX seeds' spread.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROUNDS, MONITOR_EVERY = 500, 50
RUNS = {
    # kind: (dataset preset, clients, shard strategy, rows written, rows
    # trained on, extra flags)
    "iid": ("intrusion", 4, "iid", 20_000, 20_000, []),
    "adult": ("adult", 8, "dirichlet", 7_000, 4_900,
              ["--alpha", "0.5", "--allow-zero-step-clients"]),
}
SMOKE_FLAGS = ["--batch-size", "100", "--embedding-dim", "16",
               "--device", "cpu"]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "no card"


def write_data(kind: str, root: str, smoke: bool) -> tuple[str, int]:
    """The run's CSV under ``root``; returns (path, training rows)."""
    from fed_tgan_torch.serve.demo import write_adult_csv, write_intrusion_csv

    _, _, _, rows, train, _ = RUNS[kind]
    if smoke:
        rows, train = 600, 600 if kind == "iid" else 420
    path = os.path.join(root, f"{kind}.csv")
    if kind == "iid":
        write_intrusion_csv(path, rows, 0)
    else:
        write_adult_csv(path, rows, 11, train_frac=train / rows)
    return path, train


def command(kind: str, seed: int, csv_path: str, train_rows: int, out: str,
            rounds: int, smoke: bool) -> list:
    dataset, clients, strategy, _, _, extra = RUNS[kind]
    every = 1 if smoke else MONITOR_EVERY
    cmd = [sys.executable, "-m", "fed_tgan_torch", "--mode", "fedavg",
           "--datapath", csv_path, "--dataset", dataset, "--n-clients",
           str(clients if not smoke else min(clients, 3)),
           "--shard-strategy", strategy, *extra, "--epochs", str(rounds),
           "--monitor-every", str(every), "--sample-every", "0",
           "--sample-rows", str(train_rows), "--eval", "--out-dir", out,
           "--seed", str(seed)]
    return cmd + (SMOKE_FLAGS if smoke else [])


def result(label: str, kind: str, seed: int, cmd: list, proc, out: str,
           wall: float, card: str) -> dict:
    stdout, stderr, _ = proc
    reads = []
    mon = os.path.join(out, "monitor_similarity.csv")
    if os.path.exists(mon):
        with open(mon, newline="") as f:
            rows = list(csv.reader(f))[1:]
        reads = [[int(r[0]), float(r[1]), float(r[2])] for r in rows]
    final = re.search(r"final Avg_JSD=(\S+) Avg_WD=(\S+)", stdout)
    per_round = re.search(r"rounds in \S+s \((\S+)s/round\)", stdout)
    shards = re.search(r"rows per shard: (\[[^\]]*\])", stdout)
    steps_line = [line for line in stdout.splitlines()
                  if line.startswith("init done")]
    return {
        "label": label, "run": kind, "seed": seed,
        "argv": [os.path.basename(a) if a.startswith("/") else a
                 for a in cmd[1:]],
        "monitor": reads,
        "final": ({"avg_jsd": float(final.group(1)),
                   "avg_wd": float(final.group(2))} if final else None),
        "s_per_round": float(per_round.group(1)) if per_round else None,
        "rows_per_shard": json.loads(shards.group(1)) if shards else None,
        "init_line": steps_line[0] if steps_line else None,
        "wall_s": wall, "card": card, "rc": proc[2],
        "stderr_tail": stderr[-2000:] if proc[2] else "",
    }


# the JAX package's 500-round CPU runs of the same non-IID configuration
# (ADULT_ROWS_r04.jsonl, 7,000 rows, seeds 0 and 1)
JAX_ADULT = {"avg_jsd": (0.0468, 0.0321), "avg_wd": (0.0223, 0.025)}
METRICS = ("avg_jsd", "avg_wd")


def summarize(path: str) -> dict:
    """The record's two checks from the JSON lines in ``path``."""
    with open(path) as f:
        runs = [json.loads(line) for line in f if line.strip()]
    pick = lambda label, kind, seed: next(
        (r for r in runs if (r["label"], r["run"], r["seed"]) ==
         (label, kind, seed)), None)
    out = {}
    a, b, c = pick("parent", "iid", 0), pick("parent", "iid", 1), \
        pick("change", "iid", 0)
    if a and b and c:
        for k, name in enumerate(METRICS, start=1):
            gap = [abs(x[k] - y[k]) for x, y in zip(c["monitor"],
                                                     a["monitor"])]
            seeds = [abs(x[k] - y[k]) for x, y in zip(a["monitor"],
                                                      b["monitor"])]
            mean = lambda v: sum(v) / len(v)
            out[f"iid_{name}"] = {
                "mean_change_vs_parent": mean(gap),
                "mean_parent_seed_spread": mean(seeds),
                "ratio": mean(gap) / mean(seeds),
                "pass": mean(gap) <= 2 * mean(seeds),
                "final": {"change": c["final"][name],
                          "parent": a["final"][name],
                          "parent_seed1": b["final"][name]}}
    for r in runs:
        if r["run"] != "adult" or not r["final"]:
            continue
        for name in METRICS:
            lo, hi = min(JAX_ADULT[name]), max(JAX_ADULT[name])
            spread = hi - lo
            band = (lo - 2 * spread, hi + 2 * spread)
            value = r["final"][name]
            out[f"adult_{r['label']}_seed{r['seed']}_{name}"] = {
                "final": value, "jax": JAX_ADULT[name], "band": band,
                "pass": band[0] <= value <= band[1]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--summarize", metavar="FILE",
                    help="print the record's checks from FILE and exit")
    ap.add_argument("--runs",
                    help="comma-separated kind:seed, kind in "
                    f"{sorted(RUNS)}")
    ap.add_argument("--label", default="change")
    ap.add_argument("--tree", default=REPO,
                    help="root of the fed_tgan_torch package to run")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--parallel", action="store_true",
                    help="start every run at once (one card)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CPU rehearsal, no measurement")
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return 0
    if not args.runs:
        ap.error("--runs is required")
    rounds = 2 if args.smoke else args.rounds
    card = "CPU rehearsal" if args.smoke else card_line()
    build = os.path.join(REPO, "fed_tgan_torch", "_build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="torch_quality_", dir=build)
    data = {}
    started = []
    for spec in args.runs.split(","):
        kind, seed = spec.split(":")
        if kind not in data:
            data[kind] = write_data(kind, work, args.smoke)
        out = os.path.join(work, f"{args.label}_{kind}_{seed}")
        cmd = command(kind, int(seed), *data[kind], out, rounds, args.smoke)
        env = dict(os.environ, PYTHONPATH=os.path.abspath(args.tree))
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=args.tree, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        started.append((kind, int(seed), cmd, proc, out, t0))
        if not args.parallel:
            started[-1] = started[-1][:3] + (
                (*proc.communicate(), proc.returncode),
                out, time.perf_counter() - t0)
    rc = 0
    for kind, seed, cmd, proc, out, t in started:
        if isinstance(proc, subprocess.Popen):
            stdout, stderr = proc.communicate()
            proc, t = (stdout, stderr, proc.returncode), time.perf_counter() - t
        line = result(args.label, kind, seed, cmd, proc, out, t, card)
        rc = rc or line["rc"]
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    shutil.rmtree(work, ignore_errors=True)
    print(card)
    return rc


if __name__ == "__main__":
    sys.exit(main())
