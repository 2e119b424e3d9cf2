"""Card microseconds a traced row costs in aggregation: the device time
launched inside ``train.aggregate``, which wraps every round's gate and
weighted average in a chunk (not only the last), over the traced
window's rows (``benchmark/spans.py``)."""

from benchmark.spans import device_us_per_row


def read(run):
    return device_us_per_row(run, "train.aggregate")
