"""The card time split by the span that launched it: each device event is
charged, through its correlation, to the innermost span open on the
training thread when its launch started, whichever thread launched it;
the split and ``no span`` add up to the summed card time; a span's host
self time leaves out its children; and the new readers read the trace
the program holds open, and nothing without one."""

import io
import json

import pytest

from benchmark import harness, spans
from fed_tgan_torch.runtime import profiling

MAIN, AUTOGRAD, WRITER = 1, 2, 3
READERS = ("critic_device_us_per_row", "generator_device_us_per_row",
           "adam_device_us_per_row", "draws_device_us_per_row",
           "aggregate_device_us_per_row", "snapshot_device_us_per_row",
           "draws_ms_per_round", "device_ops_per_round")


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _launch(corr, ts, tid=MAIN, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
            "dur": 2, "tid": tid, "args": {"correlation": corr}}


def _device(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr, "stream": 7}}


EVENTS = [
    _span("train.local_steps", 0, 1000),
    _span("train.draws", 10, 90),
    _span("train.step", 100, 800),
    _span("train.step.critic", 110, 400),
    _span("train.adam", 400, 100),
    _span("train.step.generator", 520, 300),
    # the writer's span is on another thread: it charges nothing
    _span("train.snapshot.write", 0, 2000, tid=WRITER),
    _launch(1, 20),                          # draws
    _launch(2, 150),                         # critic, forward
    _launch(3, 300, tid=AUTOGRAD),           # critic's backward
    _launch(4, 450, cat="cuda_driver"),      # Adam through the driver
    _launch(5, 600, tid=AUTOGRAD),           # generator's backward
    _launch(6, 950),                         # train.local_steps itself
    _launch(7, 1500, tid=WRITER),            # no training span open
    {"ph": "X", "cat": "gpu_user_annotation", "name": "train.step",
     "ts": 100, "dur": 800, "tid": 7},       # not device work
    _device(1, 30, 5),
    _device(2, 160, 40),
    _device(3, 310, 60),
    _device(4, 460, 20, cat="gpu_memset"),
    _device(5, 610, 30),
    _device(6, 960, 10, cat="gpu_memcpy"),
    _device(7, 1510, 4),
    _device(99, 1600, 8),                    # its launch is not traced
]


@pytest.fixture
def reduced(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return spans.reduce(str(path))


def test_each_event_goes_to_the_training_threads_innermost_span(reduced):
    got = {k: round(v * 1e6, 6) for k, v in reduced["device_by_span"].items()}
    assert got == {"train.local_steps": 10, "train.draws": 5,
                   "train.step": 0, "train.step.critic": 100,
                   "train.adam": 20, "train.step.generator": 30,
                   "no span": 12}
    assert reduced["ops"] == 8


def test_split_and_no_span_add_up_to_the_card_time(reduced):
    assert reduced["device_s"] == pytest.approx(177e-6)
    assert sum(reduced["device_by_span"].values()) == pytest.approx(
        reduced["device_s"])


def test_self_time_leaves_out_the_children(reduced):
    got = {k: round(v * 1e6, 6) for k, v in reduced["self_s"].items()}
    assert got == {"train.local_steps": 1000 - 90 - 800, "train.draws": 90,
                   "train.step": 800 - 400 - 300,
                   "train.step.critic": 400 - 100, "train.adam": 100,
                   "train.step.generator": 300,
                   "train.snapshot.write": 2000}


def _run(rounds=4, rows=400):
    """A traced run's fields the readers read: its window's rounds and
    rows, and the devtrace reduction that marks it traced."""
    run = harness.Run()
    run.rounds, run.rows, run.trace = rounds, rows, {}
    return run


def _held(monkeypatch, events):
    data = json.dumps({"traceEvents": events}).encode()
    monkeypatch.setattr(profiling, "last_trace", lambda: io.BytesIO(data),
                        raising=False)


def test_readers(monkeypatch):
    run = _run()
    monkeypatch.setattr(profiling, "last_trace", lambda: None)
    assert all(harness.reader(name)(run) is None for name in READERS)
    # two rounds traced (one aggregation span each), 100 rows a round
    _held(monkeypatch, EVENTS + [_span("train.aggregate", 1100, 10),
                                 _span("train.aggregate", 1200, 10)])
    run, untraced = _run(), _run()
    untraced.trace = None
    read = {name: harness.reader(name)(run) for name in READERS}
    assert spans.of_run(run)["rows"] == 200
    assert read["critic_device_us_per_row"] == pytest.approx(0.5)
    assert read["adam_device_us_per_row"] == pytest.approx(0.1)
    assert read["aggregate_device_us_per_row"] == 0
    assert read["draws_ms_per_round"] == pytest.approx(0.045)
    assert read["device_ops_per_round"] == 4
    # a span the program does not open reads nothing
    assert read["snapshot_device_us_per_row"] is None
    assert all(harness.reader(name)(untraced) is None for name in READERS)


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    # the parent's: no held trace, or a trace without train.aggregate
    monkeypatch.delattr(profiling, "last_trace")
    assert all(harness.reader(name)(_run()) is None for name in READERS)
    _held(monkeypatch, EVENTS)
    assert all(harness.reader(name)(_run()) is None for name in READERS)


def test_empty_trace_reads_nothing(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": []}))
    out = spans.reduce(str(path))
    assert out == {"device_s": 0.0, "ops": 0,
                   "device_by_span": {"no span": 0.0}, "self_s": {},
                   "counts": {}}
    _held(monkeypatch, [_span("train.aggregate", 0, 10)])
    assert all(harness.reader(name)(_run()) is None for name in READERS)
