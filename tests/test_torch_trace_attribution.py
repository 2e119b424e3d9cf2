"""``scripts/torch_trace_attribution.py`` against
``tests/test_trace_attribution.py``'s three cases, on hand-made events in
``torch.profiler``'s Chrome-trace format, plus a real CPU trace that
``fed_tgan_torch/runtime/profiling.py::device_trace`` writes around a
short stacked round."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_trace_attribution.py")
_spec = importlib.util.spec_from_file_location("torch_trace_attribution",
                                               SCRIPT)
attribution = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(attribution)

K1 = ("void (anonymous namespace)::activate_fwd_kernel<float, true>"
      "(Params<float>)")


def _write_trace(profile_dir, pid, events, mtime=None):
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_{pid}.json")
    with open(path, "w") as fh:
        json.dump({"schemaVersion": 1, "traceEvents": events}, fh)
    if mtime is not None:
        os.utime(path, (mtime, mtime))
    return path


def _events(sync_us):
    return [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "python"}},
        {"ph": "X", "cat": "kernel", "name": K1, "pid": 0, "tid": 7,
         "ts": 0, "dur": 3000, "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "kernel", "name": K1.replace("true", "false"),
         "pid": 0, "tid": 7, "ts": 5000, "dur": 1000,
         "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pinned)", "pid": 0, "tid": 7, "ts": 9000, "dur": 1000,
         "args": {"device": 0, "stream": 7}},
        # the device-side copy of a record_function range is no busy time
        {"ph": "X", "cat": "gpu_user_annotation", "name": "train.local_steps",
         "pid": 0, "tid": 7, "ts": 0, "dur": 99999},
        {"ph": "X", "cat": "user_annotation", "name": "train.aggregate.sync",
         "pid": 3, "tid": 3, "ts": 0, "dur": sync_us},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "pid": 3, "tid": 3, "ts": 0, "dur": 500},
        # a host event matching no pattern is dropped
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 3, "tid": 3,
         "ts": 0, "dur": 77777},
    ]


def test_summarize_extracts_device_and_host_totals(tmp_path):
    _write_trace(str(tmp_path), 11, _events(40000))
    out = attribution.summarize(str(tmp_path))
    # both instantiations of K1 add up under one name
    assert out["device_modules_ms"] == {
        "activate_fwd_kernel": {"total": 4.0, "count": 2}}
    assert out["device_busy_ms"] == 5.0
    assert out["device_stream_ms"] == {"cuda:0 stream 7": 5.0}
    hot = out["host_hotspots_ms"]
    assert hot["train.aggregate.sync"] == {"total": 40.0, "count": 1}
    assert hot["cudaStreamSynchronize"] == {"total": 0.5, "count": 1}
    assert "aten::mm" not in hot and "train.local_steps" not in hot


def test_summarize_reads_latest_trace_only(tmp_path):
    _write_trace(str(tmp_path), 2, _events(70000), mtime=2_000_000_000)
    _write_trace(str(tmp_path), 1, _events(10000), mtime=1_000_000_000)
    out = attribution.summarize(str(tmp_path))
    assert out["host_hotspots_ms"]["train.aggregate.sync"]["total"] == 70.0
    assert out["trace"].endswith("trace_2.json")


def test_missing_dir_raises_and_no_args_is_usage_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        attribution.summarize(str(tmp_path / "nope"))
    proc = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                          text=True)
    assert proc.returncode == 2
    assert "usage" in proc.stderr


def test_hand_written_kernels_are_always_listed(tmp_path):
    """Past the top 8 by time, K1 and K2 are still listed with their
    counts."""
    events = [{"ph": "X", "cat": "kernel", "name": f"void gemm_{i}<4>(int)",
               "pid": 0, "tid": 7, "ts": 0, "dur": 1000 + i,
               "args": {"device": 0, "stream": 7}} for i in range(10)]
    events += [{"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
                "ts": 0, "dur": 1, "args": {"device": 0, "stream": 7}}
               for name in (K1, K1, "void activate_bwd_kernel<float>(P)")]
    _write_trace(str(tmp_path), 5, events)
    mods = attribution.summarize(str(tmp_path))["device_modules_ms"]
    assert len(mods) == 10
    assert mods["activate_fwd_kernel"]["count"] == 2
    assert mods["activate_bwd_kernel"]["count"] == 1
    assert "gemm_9" in mods and "gemm_1" not in mods


def test_busy_is_the_union_over_streams(tmp_path):
    """Two streams at once count once in ``device_busy_ms``; the
    per-stream sums stay in ``device_stream_ms``."""
    def dev(ts, dur, stream):
        return {"ph": "X", "cat": "kernel", "name": "void gemm<4>(int)",
                "pid": 0, "tid": stream, "ts": ts, "dur": dur,
                "args": {"device": 0, "stream": stream}}

    _write_trace(str(tmp_path), 6, [dev(0, 3000, 7), dev(1000, 3000, 8),
                                    dev(6000, 1000, 7)])
    out = attribution.summarize(str(tmp_path))
    assert out["device_busy_ms"] == 5.0
    assert out["device_stream_ms"] == {"cuda:0 stream 7": 4.0,
                                       "cuda:0 stream 8": 3.0}


def test_device_time_by_the_span_that_launched_it(tmp_path):
    """Each device event goes, through its correlation, to the innermost
    span open on the training thread at its launch, also when autograd's
    thread (no span) or the driver launched it."""
    def span(name, ts, dur, tid=3):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "pid": 3, "tid": tid, "ts": ts, "dur": dur}

    def launch(corr, ts, tid=3, cat="cuda_runtime"):
        return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "pid": 3,
                "tid": tid, "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def dev(corr, dur):
        return {"ph": "X", "cat": "kernel", "name": f"void k{corr}(int)",
                "pid": 0, "tid": 7, "ts": 5000 + corr, "dur": dur,
                "args": {"device": 0, "stream": 7, "correlation": corr}}

    _write_trace(str(tmp_path), 8, [
        span("train.local_steps", 0, 1000), span("train.step", 0, 900),
        span("train.step.critic", 100, 300), span("train.adam", 300, 50),
        span("train.snapshot.write", 0, 5000, tid=9),
        launch(1, 50), launch(2, 150, tid=4), launch(3, 310,
                                                    cat="cuda_driver"),
        launch(4, 950), launch(5, 2000),
        dev(1, 1000), dev(2, 4000), dev(3, 2000), dev(4, 500), dev(5, 250),
        dev(6, 125)])
    out = attribution.summarize(str(tmp_path))
    assert out["device_by_span_ms"] == {
        "train.step.critic": 4.0, "train.adam": 2.0, "train.step": 1.0,
        "train.local_steps": 0.5, "no span": 0.375}


def test_real_cpu_trace_of_a_stacked_round(tmp_path):
    """``device_trace`` around one stacked round on the CPU: the host
    spans the round opens (local steps, the aggregation, the chunk's host
    copy) are reported with their counts, through the script's CLI; the
    CPU trace holds no device event."""
    from fed_tgan_torch import doctor
    from fed_tgan_torch.obs.trace import start_tracing, stop_tracing
    from fed_tgan_torch.runtime.profiling import device_trace

    torch.set_num_threads(1)
    tr = doctor._trainer("cpu", n=2)
    start_tracing()
    try:
        with device_trace(str(tmp_path)) as d:
            assert d is not None
            tr.fit(2)
    finally:
        stop_tracing()
    proc = subprocess.run([sys.executable, SCRIPT, str(tmp_path)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)[str(tmp_path)]
    assert out["trace"] == os.path.join(str(tmp_path),
                                        f"trace_{os.getpid()}.json")
    assert out["device_busy_ms"] == 0.0 and out["device_modules_ms"] == {}
    assert out["device_stream_ms"] == {} and out["device_by_span_ms"] == {}
    hot = out["host_hotspots_ms"]
    assert hot["train.local_steps"]["count"] == 2
    assert hot["train.aggregate.sync"]["count"] == 2
    assert hot["train.host_copy"]["count"] == 2  # one a chunk of 1 round
    assert all(v["total"] > 0 for v in hot.values())
