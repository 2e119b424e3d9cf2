"""The spans inside a federated chunk, read from the profiler's Chrome
trace on the CPU: each stacked step's draws, the step with its critic and
generator updates, each Adam update, every round's aggregation and the
round driver's chunk, counted and nested as the chunk runs them, with
the results bit-equal to an untraced run; and the trace, held readable
after its directory is removed."""

import json
import shutil
from collections import Counter

import numpy as np
import pytest
import torch

from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.parallel.fedavg import agg_leaves
from fed_tgan_torch.obs.trace import span
from fed_tgan_torch.runtime.profiling import (
    device_trace,
    last_trace,
    trace_path,
)
from fed_tgan_torch.serve.demo import demo_frame
from fed_tgan_torch.train.federated import FederatedTrainer
from fed_tgan_torch.train.steps import TrainConfig

K = 2  # rounds in the one chunk
CUTS = ((0, 200), (200, 280))  # 5 and 2 steps of 40 rows


def _trainer(d_steps: int) -> FederatedTrainer:
    frame = demo_frame(CUTS[-1][1], 7)
    clients = [TablePreprocessor(table={c: v[a:b] for c, v in frame.items()},
                                 name="spans",
                                 categorical_columns=["color", "flag"],
                                 non_negative_columns=["amount"])
               for a, b in CUTS]
    init = federated_initialize(clients, seed=0, device="cpu")
    cfg = TrainConfig(embedding_dim=8, gen_dims=(16, 16), dis_dims=(16, 16),
                      batch_size=40, pac=4, d_steps=d_steps)
    return FederatedTrainer(init, cfg, seed=0, device="cpu")


def _chunk(d_steps: int, trace_dir=None):
    """A trainer after one chunk of K rounds, its (K, P) metrics, and
    the chunk's spans ``(start, end, name, thread)`` when traced."""
    tr = _trainer(d_steps)
    metrics = []

    def fit():
        tr.fit(K, max_rounds_per_call=K,
               health_cb=lambda e, host: metrics.append(host))

    if trace_dir is None:
        fit()
        return tr, metrics, None
    with device_trace(str(trace_dir)) as d:
        assert d is not None
        fit()
    with open(trace_path(str(trace_dir))) as f:
        events = json.load(f)["traceEvents"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
              e.get("tid")) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("train.")]
    return tr, metrics, spans


def _inside(s, outer) -> bool:
    return outer[3] == s[3] and outer[0] <= s[0] and s[1] <= outer[1]


@pytest.fixture(scope="module", params=[1, 2], ids=lambda d: f"d_steps{d}")
def traced(request, tmp_path_factory):
    d_steps = request.param
    return (d_steps, *_chunk(d_steps, tmp_path_factory.mktemp("trace")))


def test_span_counts_in_a_chunk(traced):
    d_steps, tr, _, spans = traced
    assert tr.steps.tolist() == [5, 2]
    steps = K * int(tr.steps.max())  # stacked steps in the chunk
    got = Counter(name for _, _, name, _ in spans)
    assert got["train.fit.chunk"] == 1
    assert got["train.local_steps"] == 1
    assert got["train.draws"] == steps
    assert got["train.step"] == steps
    assert got["train.step.critic"] == d_steps * steps
    assert got["train.step.generator"] == steps
    assert got["train.adam"] == (d_steps + 1) * steps
    assert got["train.aggregate"] == K
    assert got["train.aggregate.sync"] == 1


def test_span_nesting_in_a_chunk(traced):
    spans = traced[-1]
    by = {}
    for s in spans:
        by.setdefault(s[2], []).append(s)
    # every span of the chunk on one thread, inside the driver's
    assert len({s[3] for s in spans}) == 1
    (chunk,) = by["train.fit.chunk"]
    assert all(_inside(s, chunk) for s in spans)
    updates = by["train.step.critic"] + by["train.step.generator"]
    for adam in by["train.adam"]:
        assert any(_inside(adam, u) for u in updates)
    for update in updates:
        assert any(_inside(update, st) for st in by["train.step"])
    (local,) = by["train.local_steps"]
    for span in by["train.draws"] + by["train.step"]:
        assert _inside(span, local)
    *early, last = sorted(by["train.aggregate"])
    (sync,) = by["train.aggregate.sync"]
    assert _inside(last, sync) and not _inside(last, local)
    assert early and all(_inside(s, local) for s in early)


def test_traced_chunk_is_bit_equal(traced):
    d_steps, tr, metrics, _ = traced
    plain, plain_metrics, _ = _chunk(d_steps)
    assert len(metrics) == len(plain_metrics) == 1  # one chunk
    for name in ("loss_d", "pen", "loss_g", "quarantined"):
        assert metrics[0][name].shape == (K, 2)
        assert np.array_equal(metrics[0][name], plain_metrics[0][name])
    for a, b in zip(agg_leaves(tr.stack), agg_leaves(plain.stack)):
        assert torch.equal(a, b)
    assert tr.completed_epochs == plain.completed_epochs == K


def _names(f) -> list:
    return [e["name"] for e in json.load(f)["traceEvents"]
            if e.get("cat") == "user_annotation"]


def test_the_last_trace_stays_readable_after_its_directory_goes(tmp_path):
    first, second = tmp_path / "a", tmp_path / "b"
    with device_trace(str(first)):
        with span("train.first"):
            torch.ones(4).add_(1)
    with open(trace_path(str(first)), "rb") as f:
        written = f.read()
    shutil.rmtree(first)
    assert last_trace().read() == written
    assert _names(last_trace()) == ["train.first"]  # read again from the start
    with device_trace(str(second)):
        assert last_trace() is None  # a new trace drops the old one
        with span("train.second"):
            torch.ones(4).add_(1)
    assert _names(last_trace()) == ["train.second"]
