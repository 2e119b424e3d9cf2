"""Tests of the port that need a CUDA card: the hand-written kernel has
no CPU mode.  Without a card every test here skips.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from fed_tgan_torch.features.transformer import output_info
from fed_tgan_torch.ops.activate_cuda import fused_apply_activate
from fed_tgan_torch.ops.segments import SegmentSpec, apply_activate
from fed_tgan_torch.serve.demo import build_random_artifact, intrusion_layout
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import open_model

pytestmark = pytest.mark.gpu

ATOL = 1e-5  # float32 exp/log on two code paths, logits scaled by 1/tau=5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _spec(info=None):
    if info is None:
        _, _, columns = intrusion_layout(np.random.default_rng(0))
        info = output_info(columns)
    return SegmentSpec.from_output_info(info)


@pytest.mark.parametrize("rows", [1, 5, 8, 300, 500, 4096])
def test_kernel_matches_plain(cuda, rows):
    spec = _spec()
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, spec.dim), generator=g, device=cuda) * 2.0
    u = torch.rand((rows, spec.dim), generator=g, device=cuda)
    before = fused_apply_activate.launches
    got = fused_apply_activate(x, spec, u)
    torch.cuda.synchronize()
    assert fused_apply_activate.launches == before + 1
    want = apply_activate(x, spec, u)
    assert (got - want).abs().max().item() <= ATOL


def test_kernel_wide_segments_and_no_underflow(cuda):
    """A 70-wide segment (the real Intrusion ``service`` column) and a
    distant huge logit: per-segment stabilisation keeps every segment
    summing to 1."""
    spec = _spec([(1, "tanh"), (70, "softmax"), (1, "tanh"), (3, "softmax")])
    x = torch.zeros((16, spec.dim), device=cuda)
    x[:, 0] = 50.0
    x[:, 72] = 30.0
    u = torch.rand(x.shape, generator=torch.Generator(device=cuda)
                   .manual_seed(0), device=cuda)
    got = fused_apply_activate(x, spec, u)
    assert (got - apply_activate(x, spec, u)).abs().max().item() <= ATOL
    sums = torch.stack([got[:, 1:71].sum(1), got[:, 72:75].sum(1)])
    assert (sums - 1).abs().max().item() <= 1e-5


def test_kernel_large_dim_uses_more_shared_memory(cuda):
    """A row too wide for 8 warps' default shared memory still runs."""
    spec = _spec([(1, "tanh"), (7000, "softmax"), (999, "softmax")])
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((33, spec.dim), generator=g, device=cuda)
    u = torch.rand(x.shape, generator=g, device=cuda)
    got = fused_apply_activate(x, spec, u)
    assert (got - apply_activate(x, spec, u)).abs().max().item() <= ATOL


def test_wrapper_rejects_bad_inputs(cuda):
    spec = _spec()
    x = torch.randn((4, spec.dim), device=cuda)
    u = torch.rand((4, spec.dim), device=cuda)
    with pytest.raises(TypeError):
        fused_apply_activate(x.double(), spec, u.double())
    with pytest.raises(ValueError):
        fused_apply_activate(x[:, :-1], spec, u[:, :-1])
    with pytest.raises(ValueError):
        fused_apply_activate(x, spec, u.cpu())
    xt = torch.randn((spec.dim, 4), device=cuda).T
    with pytest.raises(ValueError):
        fused_apply_activate(xt, spec, u)


def test_engine_on_card_chunked_equals_one_shot(cuda, tmp_path):
    build_random_artifact(str(tmp_path), seed=1)
    engine = SamplingEngine(open_model(str(tmp_path), device="cuda"))
    one = engine.sample_csv_bytes(1300, seed=4)
    parts = [engine.sample_csv_bytes(450, seed=4),
             engine.sample_csv_bytes(850, seed=4, offset=450, header=False)]
    assert b"".join(parts) == one
    assert engine.sample_csv_bytes(1300, seed=4) == one
