"""Card microseconds a traced row costs in the snapshot: the device time
launched inside ``train.snapshot.predispatch`` (the sampling, the packed
decode and the copies to pinned memory), over the traced window's rows
(``benchmark/spans.py``)."""

from benchmark.spans import device_us_per_row


def read(run):
    return device_us_per_row(run, "train.snapshot.predispatch")
