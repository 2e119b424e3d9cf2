"""Card microseconds a traced row costs in the stacked Adam updates of
both networks: the device time launched inside ``train.adam``, over the
traced window's rows (``benchmark/spans.py``)."""

from benchmark.spans import device_us_per_row


def read(run):
    return device_us_per_row(run, "train.adam")
