"""Card microseconds a traced row costs in the critic's updates: the
device time launched while ``train.step.critic`` was the innermost span
on the training thread (the critic's forward and backward passes, the
generator's forward for the fake batch, the gradient penalty; not its
Adam update), over the traced window's rows (``benchmark/spans.py``)."""

from benchmark.spans import device_us_per_row


def read(run):
    return device_us_per_row(run, "train.step.critic")
