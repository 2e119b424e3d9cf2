"""Kernels, copies and memsets a traced round runs on the card, on any
stream, over the traced rounds (``benchmark/spans.py``)."""

from benchmark.spans import of_run


def read(run):
    spans = of_run(run)
    if spans is None or spans["ops"] <= 0:
        return None
    return spans["ops"] / spans["rounds"]
