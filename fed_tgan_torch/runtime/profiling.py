"""Device-timeline tracing (counterpart of
``fed_tgan_tpu/runtime/profiling.py:28-54``).

``device_trace(dir)`` wraps ``torch.profiler.profile`` (CPU and CUDA
activities) around the traced block and writes its Chrome trace into
``dir`` (``trace_<pid>.json``, Perfetto- and ``chrome://tracing``-
loadable), and holds that file open for reading until the next trace
starts (:func:`last_trace`).  While it runs, every
:func:`fed_tgan_torch.obs.trace.span` also opens a ``record_function`` range of its name, so the host phases
(``train.local_steps``, ``train.aggregate.sync``, ``train.snapshot``,
...) sit beside the kernels on the same timeline.

As in the JAX package it is best effort: a profiler that cannot start
journals ``device_trace`` with ``ok=False`` and the run goes on untraced;
a trace written journals ``ok=True``.  It is a tool around the program:
the traced block runs the same kernels either way.  The context yields
the trace directory, or None when tracing could not start.
"""

from __future__ import annotations

import contextlib
import logging
import os

from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.obs.trace import _device_trace_started

log = logging.getLogger("fed_tgan_torch.profiling")

_last = None  # the latest trace written, held open


def last_trace():
    """The Chrome trace the latest :func:`device_trace` wrote, as a binary
    file open for reading from its start, or None.  It stays readable after
    its directory is removed, until the next trace starts: for a caller
    that reduces the trace after the tracing caller cleaned up (the card
    time by the span that launched it)."""
    if _last is not None:
        _last.seek(0)
    return _last


def _hold(path=None) -> None:
    """Close the trace held open; hold ``path``'s instead."""
    global _last
    if _last is not None:
        _last.close()
    _last = None if path is None else open(path, "rb")


def trace_path(profile_dir: str) -> str:
    """The Chrome trace file :func:`device_trace` writes into
    ``profile_dir``."""
    return os.path.join(str(profile_dir), f"trace_{os.getpid()}.json")


@contextlib.contextmanager
def device_trace(profile_dir: str):
    from torch.profiler import ProfilerActivity, profile

    import torch

    prof = None
    _hold()
    try:
        os.makedirs(profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        _device_trace_started(+1)
    except Exception as exc:  # the profiler itself, not the traced block
        prof = None
        log.warning("profiler trace unavailable (%s); running untraced", exc)
        _emit_event("device_trace", dir=str(profile_dir), ok=False,
                    error=str(exc))
    try:
        yield profile_dir if prof is not None else None
    finally:
        if prof is not None:
            _device_trace_started(-1)
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(trace_path(profile_dir))
                _hold(trace_path(profile_dir))
                log.info("profiler trace written to %s (open with Perfetto "
                         "or chrome://tracing)", trace_path(profile_dir))
                _emit_event("device_trace", dir=str(profile_dir), ok=True)
            except Exception as exc:
                # never mask the traced block's exception with a profiler
                # teardown failure
                log.warning("profiler stop failed (%s); trace may be "
                            "incomplete", exc)
                _emit_event("device_trace", dir=str(profile_dir), ok=False,
                            error=str(exc))
