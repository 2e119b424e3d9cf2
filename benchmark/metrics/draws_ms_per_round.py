"""Host milliseconds a traced round spends in the per-client draw loops:
the self time of ``train.draws`` on the profiler's clock (the loop's
dispatch, with the profiler's own cost), over the traced rounds
(``benchmark/spans.py``)."""

from benchmark.spans import of_run


def read(run):
    spans = of_run(run)
    seconds = None if spans is None else spans["self_s"].get("train.draws")
    return None if seconds is None else 1e3 * seconds / spans["rounds"]
