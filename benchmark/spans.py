"""Card time split by the program span that launched it, from a
``torch.profiler`` Chrome trace of the traced window.

Every kernel, memcpy and memset event is matched through its
``args.correlation`` to the host call that launched it (a
``cuda_runtime`` or a ``cuda_driver`` event: cuBLAS launches through the
driver), and its duration is charged to the innermost program span (a
``train.*`` or ``init.*`` range) open on the training thread when that
call started.  The training thread, and not the launching one: autograd
launches the backward kernels from its own device thread, where no span
is open, while the caller's span (``train.step.critic`` around the
gradient) is.  Card time whose launch is not in the trace, or was made
while no span was open, is charged to ``no span``.

A span's host self time is its duration less the part of it that its
child spans on the same thread cover.

The harness removes the trace's directory before its readers run, so the
readers reduce the trace that the program's ``device_trace`` holds open
(``fed_tgan_torch.runtime.profiling.last_trace``), once a run
(:func:`of_run`).
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import Counter, defaultdict

from benchmark.devtrace import DEVICE_CATS, SPAN_PREFIXES

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "no span"


def _nest(spans: list):
    """Spans ``(start, end, name)`` of one thread in nesting order, each
    with the index of its parent (-1 at the top)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    parents, stack = [], []
    for k, (a, _, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= a:  # closed before it
            stack.pop()
        parents.append(stack[-1] if stack else -1)
        stack.append(k)
    return spans, parents


def _innermost(spans: list, times: list) -> list:
    """For each time (µs), the name of the innermost span of ``spans``
    (one thread's: they nest) open then, or None: the latest-starting
    span that contains it."""
    spans, _ = _nest(spans)
    starts = [a for a, _, _ in spans]

    def name(t):
        for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[k][1] >= t:
                return spans[k][2]
        return None

    return [name(t) for t in times]


def _training_tid(spans: dict):
    """The thread that opens the most ``train.local_steps`` spans, else
    the most spans."""
    def count(tid, name=None):
        return sum(1 for s in spans[tid] if name in (None, s[2]))

    if not spans:
        return None
    return max(spans, key=lambda tid: (count(tid, "train.local_steps"),
                                       count(tid)))


def reduce(trace) -> dict:
    """``device_s`` (the summed duration of every device event) and
    ``ops`` (their count); ``device_by_span``: those seconds by the span
    that launched them, every span name of the training thread present
    (0 where it launched nothing) and ``no span``; ``self_s``: the host
    self seconds of each span name, summed over threads; ``counts``: how
    often the training thread opened each span name.  ``trace`` is the
    Chrome trace's path or a file open on it."""
    if hasattr(trace, "read"):
        events = json.load(trace).get("traceEvents", [])
    else:
        with open(trace) as f:
            events = json.load(f).get("traceEvents", [])
    device, launch_ts = [], {}
    spans: dict = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((float(e["dur"]), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch_ts[corr] = float(e["ts"])
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIXES):
            ts = float(e["ts"])
            spans[e.get("tid")].append((ts, ts + float(e["dur"]), name))
    main = spans.get(_training_tid(spans), [])
    by_span = {name: 0.0 for _, _, name in main}
    by_span[NO_SPAN] = 0.0
    launched = [(dur, launch_ts[c]) for dur, c in device if c in launch_ts]
    for (dur, _), name in zip(launched, _innermost(
            main, [t for _, t in launched])):
        by_span[name or NO_SPAN] += dur * 1e-6
    by_span[NO_SPAN] += sum(dur for dur, c in device
                            if c not in launch_ts) * 1e-6
    self_s: dict = defaultdict(float)
    for group in spans.values():
        group, parents = _nest(group)
        for (a, b, name), p in zip(group, parents):
            self_s[name] += (b - a) * 1e-6
            if p >= 0:
                self_s[group[p][2]] -= (min(b, group[p][1]) - a) * 1e-6
    return {"device_s": sum(dur for dur, _ in device) * 1e-6,
            "ops": len(device), "device_by_span": by_span,
            "self_s": dict(self_s),
            "counts": dict(Counter(name for _, _, name in main))}


def of_run(run):
    """The reduction of ``run``'s traced window, made once and kept on it,
    with the traced ``rounds`` (one ``train.aggregate`` span each) and
    ``rows`` (the window's rows a round): read from the trace that the
    program's ``device_trace`` holds open after its directory is gone.
    None in an untraced run, or where the program holds no trace or
    opens no ``train.aggregate`` span (before these spans existed)."""
    if run.trace is None or run.rounds <= 0:
        return None
    if not hasattr(run, "_spans"):
        run._spans = _reduce_held(run)
    return run._spans


def _reduce_held(run):
    from fed_tgan_torch.runtime import profiling

    held = getattr(profiling, "last_trace", None)
    trace = held() if held is not None else None
    if trace is None:
        return None
    out = reduce(trace)
    out["rounds"] = out["counts"].get("train.aggregate", 0)
    if out["rounds"] <= 0:
        return None
    out["rows"] = out["rounds"] * run.rows // run.rounds
    print(f"traced {out['rounds']} rounds, {out['rows']} rows, "
          f"{out['ops']} device ops, card time {out['device_s']:.6f} s by "
          "span: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(
              out["device_by_span"].items(), key=lambda kv: -kv[1]))
          + "; host self s: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(
              out["self_s"].items(), key=lambda kv: -kv[1])),
          file=sys.stderr, flush=True)
    return out


def device_us_per_row(run, name: str):
    """Card µs a traced row costs under span ``name``; None without a
    device trace, or where the program has no such span."""
    spans = of_run(run)
    if spans is None or spans["device_s"] <= 0:
        return None
    seconds = spans["device_by_span"].get(name)
    return None if seconds is None else 1e6 * seconds / spans["rows"]
