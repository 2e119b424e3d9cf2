"""The analytic FLOPs of a local step against what the reference's step
executes, counted by ``torch.utils.flop_counter`` at a small width."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.reference import ctgan

SEGMENTS = [(0, 1, "tanh"), (1, 3, "softmax"), (4, 4, "softmax"),
            (8, 1, "tanh"), (9, 2, "softmax")]
CFG = dict(embedding_dim=8, gen_dims=[16, 16], dis_dims=[16, 16], pac=2,
           batch_size=20, lr=2e-4, beta1=0.5, beta2=0.9, l2scale=1e-6)


class _Global:
    """Counts everything under one name (the module tracker's hooks do
    not support ``autograd.grad`` on a leaf, as the penalty takes)."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Counter(FlopCounterMode):
    def __init__(self):
        super().__init__(display=False)
        self.mod_tracker = _Global()


@pytest.fixture
def client():
    lay = ctgan.Layout(SEGMENTS)
    rng = np.random.default_rng(0)
    data = np.zeros((100, lay.dim), np.float32)
    for s, w, k in SEGMENTS:
        if k == "tanh":
            data[:, s] = rng.uniform(-0.9, 0.9, 100)
        else:
            data[np.arange(100), s + rng.integers(0, w, 100)] = 1.0
    G, D = ctgan.init_models(CFG["embedding_dim"] + lay.n_opt, lay.dim, CFG,
                             0)
    c = ctgan.Client(data, lay, CFG, G, D, 1, "cpu")
    c.step()
    return c


def test_forward_products_counted_exactly(client):
    lay = client.layout
    with _Counter() as fc:
        client.step()
    flops = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    B, e = CFG["batch_size"], CFG["embedding_dim"]
    g = sum(2 * B * i * o for i, o in counts.generator_layers(
        e, lay.n_opt, lay.dim, CFG["gen_dims"]))
    d = sum(2 * (B // CFG["pac"]) * i * o for i, o in counts.critic_layers(
        lay.dim, lay.n_opt, CFG["dis_dims"], CFG["pac"]))
    # two generator forwards, four critic forwards (fake, real, penalty,
    # generator step), every one a biased product
    assert flops["aten.addmm"] == 2 * g + 4 * d


def test_step_total_bounds_what_runs(client):
    lay = client.layout
    with _Counter() as fc:
        client.step()
    want = counts.step_flops(CFG["batch_size"], CFG["embedding_dim"],
                             lay.n_opt, lay.dim, CFG["gen_dims"],
                             CFG["dis_dims"], CFG["pac"])
    got = fc.get_total_flops()
    # what runs also holds products the algorithm does not need (input
    # gradients of the noise, the penalty's zero paths): never less
    assert want["total"] <= got <= 1.25 * want["total"]
    assert want["total"] == want["critic"] + want["generator"]


def test_kernel_bound_is_bytes_bound():
    n = 16_000 * 170
    assert counts.kernel_bound_s("K1", n) == pytest.approx(
        8 * n / counts.PEAK_BYTES_PER_S)
    assert counts.kernel_bound_s("K2", n) == pytest.approx(
        12 * n / counts.PEAK_BYTES_PER_S)
