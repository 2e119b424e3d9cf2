"""Model FLOPs of every local step in the window (counted from shapes,
``benchmark/counts.py``) per second, as a share of the float32 peak."""

from benchmark.counts import PEAK_F32_FLOPS


def read(run):
    return 100.0 * run.flops / run.window_s / PEAK_F32_FLOPS
