"""One run of one cell: set-up, the measured window, the traced window,
the check, and the result line.

Data-driven: the cell is ``workloads/<cell>.json`` (its configuration,
its traffic, its limits), the configuration ``configs/<config>.json``,
the traffic ``traffic/<traffic>.json``, the table a generator in
``tables/``, and every metric a reader ``metrics/<metric>.py`` (a
``read(run)`` that returns a number or None), listed for the cell in
``BENCHMARK.json``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fed_tgan_tpu")
KERNELS = {"K1": "activate_fwd_kernel", "K2": "activate_bwd_kernel"}
TRACE_SECONDS = 2.0
# the fixed work whose card time an untraced run reads: whole chunks of
# at least this many rounds (a cell's file may give ``device_rounds``)
DEVICE_ROUNDS = 8


def load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def metric_plan(cell: str, trace: bool, spec: dict) -> list:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced (a metric with a ``workloads`` list only in
    those cells)."""
    out = []
    for m in spec["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        out.append(m)
    return out


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What the metric readers read."""

    def __init__(self):
        self.setup_s = self.init_s = self.window_s = 0.0
        self.rounds = self.rows = 0
        self.flops = 0.0
        self.snapshots = False
        self.splits: dict = {}
        self.distribution: list = []
        self.write_s: list = []
        self.trace = None
        self.kernel_elements: dict = {}
        self.device_s = 0.0
        self.device_rows = 0

    def split(self, name: str) -> list:
        return self.splits.get(name, [])

    def kernel(self, label: str):
        if self.trace is None:
            return None
        k = dict(self.trace["kernels"][label])
        k["elements"] = self.kernel_elements.get(label, 0)
        return k


def _launch_elements() -> dict:
    from fed_tgan_torch.ops.activate_cuda import (
        fused_activate_bwd,
        fused_apply_activate,
    )
    return {"K1": sum(fused_apply_activate.variant_elements.values()),
            "K2": sum(fused_activate_bwd.variant_elements.values())}


def device_seconds(prog, rounds: int, device) -> tuple:
    """Card seconds of ``rounds`` rounds or more, run in whole chunks
    after the window: the summed duration of every kernel, copy and
    memset they launch, on any stream (a device-only profiler trace, so
    the host's speed does not enter); the rounds run; and the seconds by
    kind of device event."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import devtrace
    from benchmark.program import sync

    tdir = scratch_dir("device")
    t = prog.trainer
    r0 = t.completed_epochs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while t.completed_epochs - r0 < rounds:
            prog.chunk()
        prog.drain()
        sync(device)
    path = os.path.join(tdir, "device.json")
    prof.export_chrome_trace(path)
    red = devtrace.reduce(path, {})
    shutil.rmtree(tdir, ignore_errors=True)
    return red["device_s"], t.completed_epochs - r0, red["device_by_cat"]


def scratch_dir(name: str) -> str:
    """A fixed directory under the run's ``TMPDIR``, emptied."""
    base = os.environ.get("TMPDIR") or "/tmp"
    path = os.path.join(base, f"fed_tgan_bench_{name}")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
             device_name: str = "cuda", spec: dict | None = None,
             workload: dict | None = None, config: dict | None = None,
             traffic: dict | None = None, log=print) -> dict:
    import torch

    from benchmark import check, counts, tables
    from benchmark.program import Program, sync

    workload = workload or load("workloads", cell)
    config = config or load("configs", workload["config"])
    traffic = traffic or load("traffic", workload["traffic"])
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    device = torch.device(device_name)
    schema = importlib.import_module(f"benchmark.tables.{config['table']}")

    marks = {"imports": time.perf_counter() - t_start}
    table = tables.generate(config["table"], config["rows"], seed)
    marks["table"] = time.perf_counter() - t_start
    out_dir = scratch_dir("snapshots")
    prog = Program(config, traffic, table, seed, device, out_dir)
    marks["program"] = time.perf_counter() - t_start
    run = Run()
    run.init_s = prog.init_s
    run.snapshots = prog.writer is not None

    # set-up: the first three rounds through the timed call, read for the
    # check; then one chunk of the window's own shape
    first = prog.first_rounds(check.ROUNDS)
    marks["first_rounds"] = time.perf_counter() - t_start
    if prog.args.rounds_per_program > 1:
        prog.chunk()
    prog.drain()
    sync(device)
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s (init {prog.init_s:.3f} s), "
        f"{prog.steps_per_round} client steps a round; by then "
        + ", ".join(f"{k} {v:.3f}" for k, v in marks.items())
        + "; init phases " + ", ".join(
            f"{k} {v:.3f}" for k, v in prog.init.timings.items()))

    # the measured window: whole chunks until --seconds have passed
    t = prog.trainer
    r0, c0 = t.completed_epochs, len(t.round_split["local_steps"])
    w0 = len(prog.writer.write_s) if prog.writer else 0
    keep = {check.SNAPSHOT_ROUND}
    t0 = time.perf_counter()
    while True:
        prog.chunk()
        prog.remove_snapshots(keep, t.completed_epochs - 3)
        if time.perf_counter() - t0 >= seconds:
            break
    prog.drain()
    sync(device)
    run.window_s = time.perf_counter() - t0
    run.rounds = t.completed_epochs - r0
    run.rows = run.rounds * prog.steps_per_round * config["batch_size"]
    run.splits = {k: v[c0:] for k, v in t.round_split.items()}
    run.distribution = t.phase_times["distribution"][r0:]
    run.write_s = prog.writer.write_s[w0:] if prog.writer else []
    spec_ = t.spec
    run.flops = run.rounds * prog.steps_per_round * counts.step_flops(
        config["batch_size"], config["embedding_dim"], spec_.n_opt,
        spec_.dim, config["gen_dims"], config["dis_dims"],
        config["pac"])["total"]
    prog.remove_snapshots(keep, t.completed_epochs)
    chunks = np.add(run.split("local_steps"), run.split("aggregate"))
    log(f"window {run.window_s:.3f} s: {run.rounds} rounds, "
        f"{run.rows} rows, layout {spec_.dim} wide ({spec_.n_opt} "
        f"conditional); chunk seconds quartiles "
        f"{np.percentile(chunks, [0, 25, 50, 75, 100]).round(4).tolist()}, "
        f"by quarter {[round(float(q.mean()), 4) for q in np.array_split(chunks, 4) if q.size]}")

    if not trace and device.type == "cuda":
        seconds, rounds, by_cat = device_seconds(
            prog, workload.get("device_rounds", DEVICE_ROUNDS), device)
        run.device_s = seconds
        run.device_rows = rounds * prog.steps_per_round * config["batch_size"]
        prog.remove_snapshots(keep, t.completed_epochs)
        log(f"card time {seconds:.6f} s over {rounds} rounds after the "
            f"window, {run.device_rows} rows; by kind "
            + ", ".join(f"{k} {v:.6f}" for k, v in by_cat.items()))
    if trace:
        from fed_tgan_torch.runtime.profiling import device_trace, trace_path

        from benchmark import devtrace

        tdir = scratch_dir("trace")
        e0 = _launch_elements()
        with device_trace(tdir):
            tt = time.perf_counter()
            while time.perf_counter() - tt < TRACE_SECONDS:
                prog.chunk()
            prog.drain()
        e1 = _launch_elements()
        run.kernel_elements = {k: e1[k] - e0[k] for k in e0}
        run.trace = devtrace.reduce(trace_path(tdir), KERNELS)
        shutil.rmtree(tdir, ignore_errors=True)
        prog.remove_snapshots(keep, t.completed_epochs)

    metrics = {}
    for m in metric_plan(cell, trace, spec):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # what the check reads from the program, then the program is freed
    readings = {**first, **prog.readings(check.ROUNDS)}
    snap = check.snapshot_stream(prog.args, seed)
    attempted, failed = run.rounds, prog.nonfinite
    prog.close()
    del prog, t
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)

    t1 = time.perf_counter()
    ref = check.reference_readings(table, schema, config, seed, device,
                                   snapshot=snap)
    numbers = check.compare(readings, ref)
    log(f"reference {time.perf_counter() - t1:.3f} s")
    limits = workload["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(np.isfinite(v) and v <= limits[k]
                  for k, v in numbers.items()) and failed == 0
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": {
                  "platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
