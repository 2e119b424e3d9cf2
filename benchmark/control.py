"""Readings that the check's limits are set from, on the card at a cell's
own size: per seed the program's first rounds against the reference
(sound runs), the reference in TF32 in the program's place (the
control), and with ``--faults`` the program with a fault planted.  One
JSON line a reading.  Not part of a benchmark run.

    python benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--faults 3 [--fault-names half_batch_one ...]] [--no-control] \
        [--out chiprun_out/control.jsonl]
"""

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ["USE_FLAX"] = "0"


# the slot that the one-slot faults hit
SLOT = 1
FAULTS = ("frozen_state", "half_batch", "altered_aggregate",
          "frozen_state_one", "half_batch_one")


@contextlib.contextmanager
def planted(fault: str):
    """A fault of the training path, in the program, inside the block.
    ``*_one``: the fault in one slot of the stacked step only (slot
    ``SLOT``), as a slot's index or mask gone wrong would be."""
    import torch

    from fed_tgan_torch.ops import decode
    from fed_tgan_torch.train import federated, sampler

    saved = []

    def patch(owner, name, fn):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    if fault == "frozen_state":
        from fed_tgan_torch.train import steps

        def step(self, grad, active):
            self.count.add_(active)
        patch(steps.StackedAdam, "step", step)
    elif fault == "frozen_state_one":
        from fed_tgan_torch.train import steps

        orig_step = steps.StackedAdam.step

        def step(self, grad, active):
            active = active.clone()
            active[SLOT] = False
            orig_step(self, grad, active)
        patch(steps.StackedAdam, "step", step)
    elif fault == "half_batch_one":
        orig = sampler.StackedRowSampler.sample_rows

        def sample_rows(self, col, opt, u):
            rows = orig(self, col, opt, u).view(col.shape).clone()
            half = rows[SLOT, :rows.shape[1] // 2]
            rows[SLOT] = torch.cat([half, half])
            return rows.reshape(-1)
        patch(sampler.StackedRowSampler, "sample_rows", sample_rows)
    elif fault == "half_batch":
        orig = sampler.StackedRowSampler.sample_rows

        def sample_rows(self, col, opt, u):
            rows = orig(self, col, opt, u).view(col.shape)
            half = rows[:, :rows.shape[1] // 2]
            return torch.cat([half, half], dim=1).reshape(-1)
        patch(sampler.StackedRowSampler, "sample_rows", sample_rows)
    elif fault == "altered_aggregate":
        orig_agg = federated.aggregate_updates

        def aggregate_updates(prev, new, *a, **k):
            agg, quar = orig_agg(prev, new, *a, **k)
            agg = list(agg)
            agg[8] = agg[8] + 1e-2   # the generator's output bias
            return agg, quar
        patch(federated, "aggregate_updates", aggregate_updates)
    elif fault == "altered_snapshot":
        orig_dec = decode.SnapshotDecode.decode

        def dec(self, encoded):
            parts = orig_dec(self, encoded)
            u = parts["u"].clone()
            u[:, 0] = torch.clamp(u[:, 0].to(torch.int32) + 3, -127,
                                  127).to(u.dtype)
            parts["u"] = u
            return parts
        patch(decode.SnapshotDecode, "decode", dec)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def look(r: dict, ref: dict) -> dict:
    """Where the gaps sit: quantiles over (client, leaf) of the moment
    gaps, over leaves of the change gaps (the worst five named), and per
    round the median over clients of each loss's gap."""
    import numpy as np

    from benchmark import check

    kept = check.kept_leaves(ref["moments"])
    mg = []
    for k in kept:
        med = np.median([ref["moments"][x] for x in kept], axis=0)
        mg.append(np.abs(r["moments"][k] - ref["moments"][k])
                  / np.maximum(np.maximum(ref["moments"][k], med), 1e-30))
    mg = np.stack(mg)
    keys = [k for k in ref["change"] if k in kept or "running" in k]
    med = float(np.median([ref["change"][k] for k in keys]))
    cg = {k: abs(r["change"][k] - ref["change"][k])
          / max(ref["change"][k], med, 1e-30) for k in keys}
    m = np.stack(r["metrics"][:check.ROUNDS])
    rm = ref["metrics"]
    scale = np.maximum(np.abs(rm), np.median(np.abs(rm), axis=(0, 1)))
    lg = np.abs(m - rm) / scale
    return {"moment_q": [float(np.quantile(mg, q)) for q in (0.5, 0.9, 1)],
            "moment_leaf_med_max": float(np.max(np.median(mg, axis=1))),
            "change_q": [float(np.quantile(list(cg.values()), q))
                         for q in (0.5, 0.9, 1)],
            "change_worst": sorted(cg.items(), key=lambda kv: -kv[1])[:5],
            "loss_med_by_round": np.median(lg, axis=1).tolist(),
            "loss_max_by_round": lg.max(axis=1).tolist()}


def main(argv=None) -> int:
    import importlib

    import torch

    from benchmark import check, harness, tables
    from benchmark.program import Program, cli_args

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, default=0,
                   help="plant each fault in the first N seeds' runs")
    p.add_argument("--fault-names", nargs="+", default=None,
                   help="these faults only (default: every one the cell "
                   "can have)")
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w = harness.load("workloads", args.workload)
    cfg = harness.load("configs", w["config"])
    traffic = harness.load("traffic", w["traffic"])
    schema = importlib.import_module(f"benchmark.tables.{cfg['table']}")
    dev = torch.device(args.device)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    snapshots = bool(cli_args(cfg, traffic, 0).sample_every)
    faults = args.fault_names or (
        list(FAULTS) + (["altered_snapshot"] if snapshots else []))
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        table = tables.generate(cfg["table"], cfg["rows"], seed)
        prog = Program(cfg, traffic, table, seed, dev,
                       harness.scratch_dir("control"))
        runs = {"sound": {**prog.first_rounds(check.ROUNDS),
                          **prog.readings(check.ROUNDS)}}
        for fault in (faults if k < args.faults else []):
            with planted(fault):
                prog.start_training()
                runs[fault] = {**prog.first_rounds(check.ROUNDS),
                               **prog.readings(check.ROUNDS)}
        init_timings = dict(prog.init.timings)
        prog.close()
        del prog
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        snap = check.snapshot_stream(cli_args(cfg, traffic, seed), seed)
        ref = check.reference_readings(table, schema, cfg, seed, dev,
                                       snapshot=snap)
        def rounds_gap(r):
            import numpy as np
            m = np.stack(r["metrics"][:check.ROUNDS])
            return [check.loss_gap(m[i], ref["metrics"][i])
                    for i in range(check.ROUNDS)]

        for name, r in runs.items():
            emit({"cell": args.workload, "seed": seed, "run": name,
                  "numbers": check.compare(r, ref),
                  "loss_gap_by_round": rounds_gap(r),
                  "look": look(r, ref)})
        if not args.no_control:
            low = check.reference_readings(table, schema, cfg, seed, dev,
                                           tf32=True, snapshot=snap)
            if snap is not None:
                low["snapshot"] = check.as_written(low["snapshot"])
            emit({"cell": args.workload, "seed": seed, "run": "tf32",
                  "numbers": check.compare(low, ref),
                  "loss_gap_by_round": rounds_gap(low),
                  "look": look(low, ref)})
        emit({"cell": args.workload, "seed": seed, "run": "seconds",
              "seconds": time.perf_counter() - t0,
              "init": {k: round(v, 3) for k, v in init_timings.items()},
              "device": (torch.cuda.get_device_name(0)
                         if dev.type == "cuda" else "cpu")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
