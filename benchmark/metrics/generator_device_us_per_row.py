"""Card microseconds a traced row costs in the generator's updates: the
device time launched while ``train.step.generator`` was the innermost
span on the training thread (its loss through the critic and its
backward pass; not its Adam update), over the traced window's rows
(``benchmark/spans.py``)."""

from benchmark.spans import device_us_per_row


def read(run):
    return device_us_per_row(run, "train.step.generator")
