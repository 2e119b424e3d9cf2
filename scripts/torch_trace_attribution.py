"""Summarize a ``torch.profiler`` trace of the port into the round's
attribution numbers (counterpart of ``scripts/trace_attribution.py``).

Reads the newest ``trace_<pid>.json`` (by mtime) under each directory
given: the Chrome traces that ``fed_tgan_torch/runtime/profiling.py::
device_trace`` writes (the CLI's ``--profile-dir``).  Prints one JSON
object, keyed by directory, each with:

- ``trace``: the file read;
- ``device_busy_ms``: the device's busy time, the length of the union of
  the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events over every
  stream, so work on two streams at once counts once (before, this key
  held the per-stream sums that ``device_stream_ms`` holds now);
- ``device_stream_ms``: the summed duration of those events per CUDA
  stream (``cuda:<device> stream <id>``);
- ``device_by_span_ms``: their summed duration by the span that launched
  them: each event, matched through ``args.correlation`` to its
  ``cuda_runtime`` or ``cuda_driver`` launch, goes to the innermost
  port span open on the training thread (the one that opens the most
  ``train.local_steps``) when the launch started, so the backward
  kernels autograd launches from its own thread go to the caller's span;
  ``no span`` where the launch is not traced or no span was open;
- ``device_modules_ms``: ``{"total": ms, "count": n}`` for the top 8
  device kernels by time, and always for the port's hand-written kernels
  (K1 ``activate_fwd_kernel``, K2 ``activate_bwd_kernel``); a kernel's
  name drops its ``void``, its template arguments and its parameter list,
  so a kernel's instantiations add up under one name;
- ``host_hotspots_ms``: ``{"total": ms, "count": n}`` for the top 24 host
  events whose name matches :data:`HOST_PATTERNS`: the port's spans
  (``train.local_steps``, ``train.aggregate.sync``, ``train.snapshot``,
  the chunk's host copy ``train.host_copy``, the writer thread's decode
  and CSV ``train.snapshot.write``, ...) and the CUDA runtime's waits and
  copies.

Usage: python scripts/torch_trace_attribution.py PROFILE_DIR [...]
Stdlib only.
"""
from __future__ import annotations

import bisect
import collections
import glob
import json
import os
import re
import sys

# host events worth reporting, keyed by a substring of the event's name:
# the span names obs/trace.py::span opens as record_function ranges, and
# the CUDA runtime's synchronising calls and copies
HOST_PATTERNS = (
    "train.",
    "multihost.",
    "elastic.",
    "init.",
    "cudaStreamSynchronize",
    "cudaEventSynchronize",
    "cudaDeviceSynchronize",
    "cudaMemcpyAsync",
)
#: the port's hand-written kernels, always listed (csrc/activate.cu)
HAND_KERNELS = ("activate_fwd_kernel", "activate_bwd_kernel")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
#: the port's spans (obs/trace.py::span names)
SPAN_PREFIXES = ("train.", "multihost.", "elastic.", "init.")
TOP_DEVICE, TOP_HOST = 8, 24

_TEMPLATE = re.compile(r"<[^<>]*>")


def kernel_name(name: str) -> str:
    """``void ns::k<float, true>(Params)`` -> ``ns::k``."""
    name = name.replace("(anonymous namespace)::", "")
    prev = None
    while prev != name:  # innermost template arguments first
        prev, name = name, _TEMPLATE.sub("", name)
    name = name.split("(", 1)[0].strip()
    return name[len("void "):] if name.startswith("void ") else name


def union_ms(intervals: list) -> float:
    """Length of the union of ``(start, end)`` µs intervals, in ms."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + (b - a), b
        elif b > end:
            total, end = total + (b - end), b
    return total / 1e3


def innermost(spans: list, starts: list, t: float):
    """The name of the innermost of one thread's nested ``(start, end,
    name)`` spans, sorted by start (``starts``), open at ``t``: the
    latest-starting one that contains it."""
    for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[k][1] >= t:
            return spans[k][2]
    return None


def newest_trace(profile_dir: str) -> str:
    paths = glob.glob(os.path.join(profile_dir, "trace_*.json"))
    if not paths:
        raise FileNotFoundError(f"no trace_<pid>.json under {profile_dir}")
    return max(paths, key=os.path.getmtime)


def summarize(profile_dir: str) -> dict:
    path = newest_trace(profile_dir)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]

    busy: collections.Counter = collections.Counter()
    modules: collections.Counter = collections.Counter()
    module_counts: collections.Counter = collections.Counter()
    host: collections.Counter = collections.Counter()
    host_counts: collections.Counter = collections.Counter()
    intervals, launched, launch_ts = [], [], {}
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        dur = float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in LAUNCH_CATEGORIES and "correlation" in args:
            launch_ts[args["correlation"]] = float(e["ts"])
        if cat == "user_annotation" and e.get("name", "").startswith(
                SPAN_PREFIXES):
            spans[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + dur, e["name"]))
        if cat in DEVICE_CATEGORIES:
            line = (f"cuda:{args.get('device', e.get('pid'))} stream "
                    f"{args.get('stream', e.get('tid'))}")
            busy[line] += dur
            intervals.append((float(e["ts"]), float(e["ts"]) + dur))
            launched.append((dur, args.get("correlation")))
            if cat == "kernel":
                name = kernel_name(e["name"])
                modules[name] += dur
                module_counts[name] += 1
        elif not cat.startswith("gpu_"):
            name = e.get("name", "")
            if any(p in name for p in HOST_PATTERNS):
                host[name] += dur
                host_counts[name] += 1
    main = max(spans, default=None, key=lambda tid: (
        sum(s[2] == "train.local_steps" for s in spans[tid]),
        len(spans[tid])))
    ordered = sorted(spans.get(main, []), key=lambda s: (s[0], -s[1]))
    starts = [a for a, _, _ in ordered]
    by_span: collections.Counter = collections.Counter()
    for dur, corr in launched:
        name = (innermost(ordered, starts, launch_ts[corr])
                if corr in launch_ts else None)
        by_span[name or "no span"] += dur
    listed = [k for k, _ in modules.most_common(TOP_DEVICE)]
    listed += [k for k in modules if k not in listed
               and any(h in k for h in HAND_KERNELS)]
    return {
        "trace": path,
        "device_busy_ms": round(union_ms(intervals), 3),
        "device_stream_ms": {k: round(v / 1e3, 3) for k, v in busy.items()},
        "device_by_span_ms": {k: round(v / 1e3, 3)
                              for k, v in by_span.most_common()},
        "device_modules_ms": {
            k: {"total": round(modules[k] / 1e3, 3), "count": module_counts[k]}
            for k in listed},
        "host_hotspots_ms": {
            k: {"total": round(v / 1e3, 3), "count": host_counts[k]}
            for k, v in host.most_common(TOP_HOST)},
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: torch_trace_attribution.py PROFILE_DIR [...]",
              file=sys.stderr)
        return 2
    out = {d: summarize(d) for d in argv}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
