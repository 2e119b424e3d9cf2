"""Reduction of a ``torch.profiler`` Chrome trace to the device's busy
time, its idle gaps named by the program's open span, and kernel times.

Device work is every kernel, memcpy and memset event, on any stream; the
busy time is the length of their union, so work on two streams at once
counts once.  The traced window runs from the first to the last event of
the trace.  An idle gap is named by the innermost program span (a
``train.*`` or ``init.*`` range the program opens while a device trace
runs) open on the training thread at the gap's middle, else on any
thread (the snapshot writer's), else ``no span``.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIXES = ("train.", "init.")
TOP = 10


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def _namer(spans: list, main_tid):
    """``name(t)``: the innermost span open at ``t`` (µs)."""
    def index(group):
        group = sorted(group)
        return group, [s[0] for s in group]

    main = index([s for s in spans if s[3] == main_tid])
    other = index([s for s in spans if s[3] != main_tid])

    def inner(group, t):
        items, starts = group
        best = None
        for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            a, b, name, _ = items[k]
            if a <= t <= b and (best is None or a >= best[0]):
                best = (a, name)
            if best is not None and t - a > 60e6:
                break
        return None if best is None else best[1]

    return lambda t: inner(main, t) or inner(other, t) or "no span"


def reduce(path: str, kernel_names: dict) -> dict:
    """``busy_s``, ``window_s``, ``device_s`` (the summed duration of
    every device event: two streams at once count twice) and its split
    by kind in ``device_by_cat``, ``device_ops``
    and ``idle_gaps`` (at most 10 ``[name, seconds]`` each, largest
    first), and per entry of
    ``kernel_names`` (label -> substring of a kernel's name) its summed
    device seconds and launches."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, spans, lo, hi = [], [], None, None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        lo = ts if lo is None else min(lo, ts)
        hi = ts + dur if hi is None else max(hi, ts + dur)
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIXES):
            spans.append((ts, ts + dur, name, e.get("tid")))
    out = {"busy_s": 0.0, "window_s": 0.0, "device_s": 0.0,
           "device_by_cat": {c: 0.0 for c in DEVICE_CATS},
           "device_ops": [], "idle_gaps": [],
           "kernels": {k: {"seconds": 0.0, "launches": 0}
                       for k in kernel_names}}
    if lo is None:
        return out
    busy = _union([(a, b) for a, b, _ in device])
    out["busy_s"] = sum(b - a for a, b in busy) * 1e-6
    out["window_s"] = (hi - lo) * 1e-6
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e:
            out["device_by_cat"][e["cat"]] += float(e["dur"]) * 1e-6
    out["device_s"] = sum(out["device_by_cat"].values())
    by_op: dict = defaultdict(float)
    for a, b, name in device:
        by_op[name] += (b - a) * 1e-6
        for label, sub in kernel_names.items():
            if sub in name:
                out["kernels"][label]["seconds"] += (b - a) * 1e-6
                out["kernels"][label]["launches"] += 1
    out["device_ops"] = [[n[:120], s] for n, s in sorted(
        by_op.items(), key=lambda kv: -kv[1])[:TOP]]
    tids = defaultdict(int)
    for s in spans:
        if s[2] == "train.local_steps":
            tids[s[3]] += 1
    name_at = _namer(spans, max(tids, key=tids.get) if tids else None)
    gaps: dict = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[name_at(0.5 * (a + b))] += (b - a) * 1e-6
    out["idle_gaps"] = [[n, s] for n, s in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:TOP]]
    return out
