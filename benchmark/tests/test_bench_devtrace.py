"""The reduction of a device trace: the busy time is the union of device
intervals over every stream, the card time their sum, and an untraced
run on the CPU reports no card time a row."""

import json

import pytest

from benchmark import devtrace, harness


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_busy_is_the_union_and_card_time_the_sum(tmp_path):
    path = _trace(tmp_path, [
        _x("kernel", "activate_fwd_kernel", 0, 100, tid=7),
        _x("kernel", "gemm", 50, 100, tid=8),        # overlaps, other stream
        _x("gpu_memcpy", "Memcpy DtoH", 300, 50, tid=7),
        _x("user_annotation", "train.local_steps", 0, 400),
    ])
    out = devtrace.reduce(path, harness.KERNELS)
    assert out["busy_s"] == pytest.approx(200e-6)
    assert out["device_s"] == pytest.approx(250e-6)
    assert out["device_by_cat"]["gpu_memcpy"] == pytest.approx(50e-6)
    assert out["window_s"] == pytest.approx(400e-6)
    assert out["kernels"]["K1"] == {"seconds": pytest.approx(100e-6),
                                    "launches": 1}
    assert out["idle_gaps"] == [["train.local_steps", pytest.approx(200e-6)]]


def test_empty_trace_reads_nothing(tmp_path):
    out = devtrace.reduce(_trace(tmp_path, []), harness.KERNELS)
    assert out["busy_s"] == out["device_s"] == 0.0


@pytest.mark.parametrize("rows,want", [(0, None), (40_000, 2.5)])
def test_card_time_a_row(rows, want):
    run = harness.Run()
    run.device_s, run.device_rows = 0.1, rows
    got = harness.reader("train_device_us_per_row")(run)
    assert got == (None if want is None else pytest.approx(want))
