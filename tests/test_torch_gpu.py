"""Tests of the port that need a CUDA card: the hand-written kernels have
no CPU mode.  Without a card every test here skips.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from fed_tgan_torch.features.transformer import output_info
from fed_tgan_torch.ops.activate_cuda import (
    fused_activate_bwd,
    fused_apply_activate,
    launch_plan,
    plan_for,
)
from fed_tgan_torch.ops.segments import (
    SegmentSpec,
    apply_activate,
    apply_activate_bwd,
)
from fed_tgan_torch.serve.demo import build_random_artifact, intrusion_layout
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import open_model
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.sampler import CondSampler, RowSampler
from fed_tgan_torch.train.standalone import StandaloneSynthesizer

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


@pytest.mark.parametrize("rows", [1, 5, 500, 4096])
def test_bwd_kernel_matches_plain(cuda, rows):
    spec = _spec()
    g = torch.Generator(device=cuda).manual_seed(rows + 7)
    x = torch.randn((rows, spec.dim), generator=g, device=cuda) * 2.0
    out = fused_apply_activate(x, spec, torch.rand(x.shape, generator=g,
                                                   device=cuda))
    dy = torch.randn(x.shape, generator=g, device=cuda)
    before = fused_activate_bwd.launches
    got = fused_activate_bwd(dy, out, spec)
    torch.cuda.synchronize()
    assert fused_activate_bwd.launches == before + 1
    assert (got - apply_activate_bwd(dy, out, spec)).abs().max().item() <= ATOL


def test_bwd_kernel_wide_segment_and_large_dim(cuda):
    for info in ([(1, "tanh"), (70, "softmax"), (1, "tanh"), (3, "softmax")],
                 [(1, "tanh"), (7000, "softmax"), (999, "softmax")]):
        spec = _spec(info)
        g = torch.Generator(device=cuda).manual_seed(2)
        x = torch.randn((33, spec.dim), generator=g, device=cuda)
        out = fused_apply_activate(x, spec, torch.rand(x.shape, generator=g,
                                                       device=cuda))
        dy = torch.randn(x.shape, generator=g, device=cuda)
        got = fused_activate_bwd(dy, out, spec)
        want = apply_activate_bwd(dy, out, spec)
        assert (got - want).abs().max().item() <= ATOL


def test_activation_gradient_through_both_kernels(cuda):
    """d/dx sum(w * act(x)): K1 forward + K2 backward against autograd
    through the plain forward."""
    spec = _spec()
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((300, spec.dim), generator=g, device=cuda) * 2.0
    u = torch.rand(x.shape, generator=g, device=cuda)
    w = torch.randn(x.shape, generator=g, device=cuda)
    k1, k2 = fused_apply_activate.launches, fused_activate_bwd.launches
    xk = x.clone().requires_grad_(True)
    (w * fused_apply_activate(xk, spec, u)).sum().backward()
    xp = x.clone().requires_grad_(True)
    (w * apply_activate(xp, spec, u)).sum().backward()
    assert (fused_apply_activate.launches, fused_activate_bwd.launches) == (
        k1 + 1, k2 + 1)
    assert (xk.grad - xp.grad).abs().max().item() <= ATOL


def test_bwd_wrapper_rejects_bad_inputs(cuda):
    spec = _spec()
    dy = torch.randn((4, spec.dim), device=cuda)
    out = torch.rand((4, spec.dim), device=cuda)
    with pytest.raises(TypeError):
        fused_activate_bwd(dy.double(), out.double(), spec)
    with pytest.raises(ValueError):
        fused_activate_bwd(dy[:, :-1], out[:, :-1], spec)
    with pytest.raises(ValueError):
        fused_activate_bwd(dy, out.cpu(), spec)
    with pytest.raises(ValueError):
        fused_activate_bwd(torch.randn((spec.dim, 4), device=cuda).T, out,
                           spec)


def _both(spec, x, u, dy):
    """K1 on (x, u), then K2 on (dy, K1's output); each against its plain
    version."""
    out = fused_apply_activate(x, spec, u)
    dx = fused_activate_bwd(dy, out, spec)
    torch.cuda.synchronize()
    assert (out - apply_activate(x, spec, u)).abs().max().item() <= ATOL
    assert (dx - apply_activate_bwd(dy, out, spec)).abs().max().item() <= ATOL
    return out, dx


def _inputs(spec, rows, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn((rows, spec.dim), generator=g, device=device) * 2.0,
            torch.rand((rows, spec.dim), generator=g, device=device),
            torch.randn((rows, spec.dim), generator=g, device=device))


@pytest.mark.parametrize("rows", [7, 131, 3001, 8002, 64001])
def test_kernels_at_tile_edges(cuda, rows):
    """Fewer rows than SMs, and row counts that leave the last tile
    short."""
    spec = _spec()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = plan_for(torch.empty((rows, spec.dim), device=cuda), spec)
    assert rows < sms or (plan.rows_per_tile > 1
                          and rows % plan.rows_per_tile)
    _both(spec, *_inputs(spec, rows, rows, cuda))


def _misaligned(t):
    st = torch.empty(t.numel() + 1, device=t.device)
    st[1:].copy_(t.flatten())
    view = st[1:].view_as(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("rows", [1, 5, 500])
def test_kernels_on_a_misaligned_base(cuda, rows):
    """Operands whose base is only 4-byte aligned (a contiguous view at
    storage offset 1): the copies split on other element boundaries."""
    spec = _spec()
    x, u, dy = _inputs(spec, rows, 5, cuda)
    out, dx = _both(spec, *(_misaligned(t) for t in (x, u, dy)))
    aligned_out = fused_apply_activate(x, spec, u)
    assert torch.equal(out, aligned_out)
    assert torch.equal(dx, fused_activate_bwd(dy, aligned_out, spec))


def _largest_dim(sms, staged):
    """The largest D that launch_plan takes (``staged``: that it stages)
    for rows of 3 segments."""
    def fits(dim):
        try:
            plan = launch_plan(2, dim, 3, sms)
        except ValueError:
            return False
        return plan.staged or not staged

    lo, hi = 1, 1 << 16
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def test_kernels_at_dim_one_and_the_largest_dim(cuda):
    """D = 1; the widest rows that stage; D = 29,056, the widest the kernels
    take (one row of both operands fills a block), which runs unstaged."""
    for info in ([(1, "tanh")], [(1, "softmax")]):
        spec = _spec(info)
        _both(spec, *_inputs(spec, 300, 6, cuda))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    widest = _largest_dim(sms, staged=False)
    assert widest == 29056
    for dim in (_largest_dim(sms, staged=True), widest):
        spec = _spec([(1, "tanh"), (dim - 71, "softmax"), (70, "softmax")])
        x, u, dy = _inputs(spec, 3, 7, cuda)
        assert plan_for(x, spec).staged == (dim < widest)
        _both(spec, x, u, dy)
    wider = _spec([(1, "tanh"), (widest - 70, "softmax"), (70, "softmax")])
    xw, uw, _ = _inputs(wider, 2, 8, cuda)
    with pytest.raises(ValueError):
        fused_apply_activate(xw, wider, uw)


def test_stacked_clients_equal_separate_launches(cuda):
    """The stacked rows of 4 clients x 500 (the federated round) in one
    launch are bit-identical to one launch per client: a row's result does
    not depend on its position in a tile (the kernel-level twin of
    tests/test_pallas_activate.py's vmap case)."""
    spec = _spec()
    x, u, dy = _inputs(spec, 4 * 500, 9, cuda)
    out, dx = _both(spec, x, u, dy)
    parts = [slice(i * 500, (i + 1) * 500) for i in range(4)]
    outs = [fused_apply_activate(x[p], spec, u[p]) for p in parts]
    assert torch.equal(out, torch.cat(outs))
    assert torch.equal(dx, torch.cat([fused_activate_bwd(dy[p], o, spec)
                                      for p, o in zip(parts, outs)]))


def test_both_kernels_replay_in_a_cuda_graph(cuda):
    """K1 then K2 captured once and replayed on new inputs give what eager
    launches give: no allocation, synchronisation or host copy inside."""
    spec = _spec()
    x, u, dy = _inputs(spec, 500, 10, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fused_activate_bwd(dy, fused_apply_activate(x, spec, u), spec)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_apply_activate(x, spec, u)
        dx = fused_activate_bwd(dy, out, spec)
    for seed in (11, 12):
        for static, fresh in zip((x, u, dy), _inputs(spec, 500, seed, cuda)):
            static.copy_(fresh)
        graph.replay()
        want_out, want_dx = _both(spec, x, u, dy)
        assert torch.equal(out, want_out) and torch.equal(dx, want_dx)


def test_train_step_on_card_matches_cpu(cuda):
    """One small train step on the card and on the CPU from the same
    weights and draws."""
    info = [(1, "tanh"), (3, "softmax"), (4, "softmax"), (2, "softmax")]
    spec = _spec(info)
    cfg = steps.TrainConfig(embedding_dim=16, gen_dims=(32, 32),
                            dis_dims=(32, 32), batch_size=40)
    rng = np.random.default_rng(0)
    data = np.zeros((120, spec.dim), dtype=np.float32)
    data[:, 0] = rng.uniform(-0.9, 0.9, 120)
    for start, size in ((1, 3), (4, 4), (8, 2)):
        data[np.arange(120), start + rng.integers(0, size, 120)] = 1.0
    draws = steps.draw_step(torch.Generator().manual_seed(1),
                            steps.init_models(spec, cfg, 0, "cpu"))
    mets = []
    for dev in (cuda, torch.device("cpu")):
        models = steps.init_models(spec, cfg, 0, dev)
        mets.append(steps.train_step(
            models, torch.as_tensor(data, device=dev),
            CondSampler.from_data(data, spec, dev),
            RowSampler.from_data(data, spec, dev), draws.to(dev)))
    for k in mets[1]:
        assert float(mets[0][k]) == pytest.approx(float(mets[1][k]), rel=1e-4)


def test_standalone_trains_and_samples_on_card(cuda):
    rng = np.random.default_rng(11)
    n = 1200
    cont = rng.normal(0, 1, n)
    cat = rng.choice([0, 1, 2], n, p=[0.7, 0.2, 0.1]).astype(float)
    cfg = steps.TrainConfig(embedding_dim=16, gen_dims=(32, 32),
                            dis_dims=(32, 32), batch_size=100)
    k2 = fused_activate_bwd.launches
    synth = StandaloneSynthesizer(cfg, seed=0, device="cuda").fit(
        np.stack([cont, cat], axis=1), categorical_idx=[1], epochs=1)
    assert fused_activate_bwd.launches == k2 + 12
    out = synth.sample(300, seed=1)
    assert out.shape == (300, 2) and np.isfinite(out).all()
    assert set(np.unique(out[:, 1])) <= {0.0, 1.0, 2.0}
