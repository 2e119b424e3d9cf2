"""Card microseconds a traced row costs in the per-client draws before
each stacked step: the device time launched inside ``train.draws``, over
the traced window's rows (``benchmark/spans.py``)."""

from benchmark.spans import device_us_per_row


def read(run):
    return device_us_per_row(run, "train.draws")
