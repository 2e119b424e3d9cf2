"""Rounds in chunks (``fit(max_rounds_per_call=K)``, the CLI's
``--rounds-per-program``), mirroring ``tests/test_scan_rounds.py:48-130``:
a chunk of 4 rounds ends bit-equal to 4 chunks of one round (weights,
every Adam and BatchNorm state, every client's generator, quarantine
masks, strikes) for the weighted and median aggregators in f32 and bf16;
a fault window clips the chunks at its edges; a chunk of K rounds makes
one copy of its results to the host; the watchdog clamps K to 1 after a
rollback until the alarming stretch has been run again.

The port's trainer on its own draws (K does not change what a round
computes, so there is nothing of JAX's to inject), 8 clients of the toy
table, 1 or 2 local steps each.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.runtime.checkpoint import save_federated
from fed_tgan_torch.testing.faults import FaultPlan, install_plan
from fed_tgan_torch.train.federated import FederatedTrainer
from fed_tgan_torch.train.steps import TrainConfig
from fed_tgan_torch.train.watchdog import (
    TrainingWatchdog,
    WatchdogAlarm,
    fit_with_watchdog,
)

torch.set_num_threads(1)
CFG = TrainConfig(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),
                  batch_size=40, pac=4)


@pytest.fixture(scope="module")
def init8(toy_frame, toy_spec):
    table = {c: toy_frame[c].to_numpy() for c in toy_frame.columns}
    order = np.random.default_rng(9).permutation(len(toy_frame))
    return federated_initialize(
        [TablePreprocessor(table={c: v[part] for c, v in table.items()},
                           **toy_spec)
         for part in np.array_split(order, 8)], seed=0, device="cpu")


@pytest.fixture(autouse=True)
def _no_fault_plan():
    install_plan(None)
    yield
    install_plan(None)


def _fit_collecting(trainer, epochs, k):
    """fit() recording each chunk's first round, length and quarantine
    mask; returns ``(chunks [(first, K)], masks (rounds, P))``."""
    chunks, masks = [], []

    def cb(first, metrics):
        chunks.append((first, len(metrics["loss_g"])))
        masks.append(np.asarray(metrics["quarantined"]))

    trainer.fit(epochs, max_rounds_per_call=k, health_cb=cb)
    return chunks, np.concatenate(masks)


def _assert_bit_equal(a, b):
    sa, sb = a.stack, b.stack
    for x, y in ((sa.generator.params, sb.generator.params),
                 (sa.generator.bn_state, sb.generator.bn_state),
                 (sa.generator.num_batches, sb.generator.num_batches),
                 (sa.discriminator.params, sb.discriminator.params),
                 (sa.opt_g.exp_avg, sb.opt_g.exp_avg),
                 (sa.opt_g.exp_avg_sq, sb.opt_g.exp_avg_sq),
                 (sa.opt_d.exp_avg, sb.opt_d.exp_avg),
                 (sa.opt_d.count, sb.opt_d.count)):
        assert torch.equal(x, y)
    for g, h in zip(a.gens, b.gens):
        assert torch.equal(g.get_state(), h.get_state())
    np.testing.assert_array_equal(a._strikes, b._strikes)


@pytest.mark.parametrize("aggregator", ["weighted", "median"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_k4_bit_identical_to_four_k1_chunks(init8, aggregator, precision):
    cfg = dataclasses.replace(CFG, aggregator=aggregator,
                              precision=precision)
    fused = FederatedTrainer(init8, cfg, seed=11, device="cpu")
    seq = FederatedTrainer(init8, cfg, seed=11, device="cpu")
    chunks_f, q_fused = _fit_collecting(fused, 4, 4)
    chunks_s, q_seq = _fit_collecting(seq, 4, 1)
    assert chunks_f == [(0, 4)]
    assert chunks_s == [(0, 1), (1, 1), (2, 1), (3, 1)]
    _assert_bit_equal(fused, seq)
    np.testing.assert_array_equal(q_fused, q_seq)
    np.testing.assert_array_equal(fused.last_metrics, seq.last_metrics)
    assert fused.completed_epochs == seq.completed_epochs == 4
    assert len(fused.epoch_times) == 4
    assert sum(fused.epoch_times) == pytest.approx(
        fused.round_split["local_steps"][0]
        + fused.round_split["aggregate"][0], rel=0.5)


def test_fault_window_clips_chunk(init8):
    """A ``scale_update`` window over rounds 2-3 (1-based) splits a 5-round
    run at K = 4 into [0], [1, 2], [3, 4], never flipping mid-chunk, and
    ends bit-equal to the run at K = 1."""
    install_plan(FaultPlan.parse(
        "scale_update:factor=1000,rank=2,round=2,until=3"))
    fused = FederatedTrainer(init8, CFG, seed=5, device="cpu")
    seq = FederatedTrainer(init8, CFG, seed=5, device="cpu")
    chunks_f, q_fused = _fit_collecting(fused, 5, 4)
    chunks_s, q_seq = _fit_collecting(seq, 5, 1)
    assert chunks_f == [(0, 1), (1, 2), (3, 2)]
    assert len(chunks_s) == 5
    _assert_bit_equal(fused, seq)
    np.testing.assert_array_equal(q_fused, q_seq)
    assert q_fused[1:3, 1].all() and not q_fused[[0, 3, 4]].any()
    assert fused._strikes[1] == 2


def test_one_host_copy_per_k_rounds(init8):
    """With the health callback reading every chunk, 4 rounds at K = 4
    make one device-to-host copy and 4 at K = 1 make four, counted where
    the trainer copies (a wrapper of ``_to_host``)."""
    counts = {}
    for label, k in (("fused", 4), ("seq", 1)):
        tr = FederatedTrainer(init8, CFG, seed=3, device="cpu")
        calls = []
        real = tr._to_host

        def counting(t, real=real, calls=calls):
            calls.append(t.shape)
            return real(t)

        tr._to_host = counting
        tr.fit(4, max_rounds_per_call=k, health_cb=lambda e, m: None)
        counts[label] = (len(calls), tr.host_copies)
    assert counts == {"fused": (1, 1), "seq": (4, 4)}


class _AlarmOnce(TrainingWatchdog):
    """Raises once, on the first chunk holding round 2; records every
    chunk it sees as ``(first round, rounds)``."""

    def __init__(self):
        super().__init__()
        self.seen, self.fired = [], False

    def health_cb(self, first, metrics):
        k = len(metrics["loss_g"])
        self.seen.append((first, k))
        if not self.fired and first <= 2 < first + k:
            self.fired = True
            raise WatchdogAlarm(f"scripted alarm in rounds {first}..")


def test_watchdog_clamps_k_after_a_rollback(init8, tmp_path):
    """K = 4 under the watchdog: the chunk of rounds 0-3 alarms, the run
    rolls back to the round-0 checkpoint and re-runs rounds 0-3 one round
    a chunk, then goes on at K = 4."""
    ckpt = str(tmp_path / "ck")
    tr = FederatedTrainer(init8, CFG, seed=2, device="cpu")
    save_federated(tr, ckpt)
    wd = _AlarmOnce()
    out = fit_with_watchdog(tr, 8, wd, ckpt,
                            fit_kwargs={"max_rounds_per_call": 4})
    assert wd.rollbacks == 1
    assert wd.seen == [(0, 4), (0, 1), (1, 1), (2, 1), (3, 1), (4, 4)]
    assert out.completed_epochs == 8 and out is not tr
