"""K1's least time (its elements' bytes over bandwidth) over its device
time in the traced window, per cent."""

from benchmark.counts import kernel_bound_s


def read(run):
    k = run.kernel("K1")
    if k is None or k["seconds"] <= 0 or k["elements"] <= 0:
        return None
    return 100.0 * kernel_bound_s("K1", k["elements"]) / k["seconds"]
