"""Tests of the port that need a CUDA card: the hand-written kernels have
no CPU mode.  Without a card every test here skips.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from fed_tgan_torch.data.decode import decode_cells
from fed_tgan_torch.features.transformer import output_info
from fed_tgan_torch.ops import activate_cuda
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
    apply_activate_residual,
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


def test_monitor_probe_shape_launches_k1_once(cuda, tmp_path):
    """The monitor's probe: 10,000 rows (20 steps of 500) through the
    engine's device path are one K1 launch at (10000, D), and K1 at that
    shape matches its plain version."""
    build_random_artifact(str(tmp_path), seed=2)
    engine = SamplingEngine(open_model(str(tmp_path), device="cuda"))
    before = fused_apply_activate.launches
    rows = engine.decoded_on_device(10_000, seed=3, key_offset=31)
    torch.cuda.synchronize()
    assert fused_apply_activate.launches == before + 1
    assert rows.shape == (10_000, len(engine.model.synth.columns))
    assert rows.is_cuda and torch.isfinite(rows).all()
    spec = engine.spec
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((10_000, spec.dim), generator=g, device=cuda) * 2.0
    u = torch.rand(x.shape, generator=g, device=cuda)
    got = fused_apply_activate(x, spec, u)
    assert (got - apply_activate(x, spec, u)).abs().max().item() <= ATOL


def _small_federation():
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize

    rng = np.random.default_rng(5)
    tables = [{"x": rng.normal(0, 1, 240),
               "c": rng.choice(["a", "b", "c"], 240).astype(object)}
              for _ in range(2)]
    init = federated_initialize(
        [TablePreprocessor(table=t, categorical_columns=["c"])
         for t in tables], device="cpu")
    cfg = steps.TrainConfig(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),
                            batch_size=40, pac=4)
    return init, cfg


def test_federated_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """Saved on the card, loaded on the CPU (and back): weights, BatchNorm
    state and Adam moments equal; the generators are reseeded off their
    own device type.  On the card, a loaded run continues bit for bit."""
    from fed_tgan_torch.runtime.checkpoint import load_federated, save_federated
    from fed_tgan_torch.train.federated import FederatedTrainer

    init, cfg = _small_federation()
    tr = FederatedTrainer(init, cfg, seed=0, device="cuda").fit(1)
    save_federated(tr, str(tmp_path / "card"))
    host = load_federated(str(tmp_path / "card"), device="cpu")
    back = load_federated(str(tmp_path / "card"), device="cuda")
    for a, b, c in zip(tr.models, host.models, back.models):
        for x, y, z in zip(a.generator.state_dict().values(),
                           b.generator.state_dict().values(),
                           c.generator.state_dict().values()):
            assert torch.equal(x.cpu(), y) and torch.equal(x, z)
    save_federated(host, str(tmp_path / "cpu"))
    again = load_federated(str(tmp_path / "cpu"), device="cuda")
    assert again.models[0].generator.out.weight.is_cuda
    tr.fit(1)
    back.fit(1)
    for a, c in zip(tr.models, back.models):
        for x, z in zip(a.discriminator.parameters(),
                        c.discriminator.parameters()):
            assert torch.equal(x, z)


def test_pinned_snapshot_files_equal_a_blocking_copy(cuda, tmp_path):
    """The writer's pinned, non-blocking copies (waited on through a CUDA
    event on the writer thread) give the same file as the parts copied to
    the host with a blocking copy and written by the stdlib writer, and
    each snapshot's file is its own rows' even while the next round runs
    beside the writer."""
    from fed_tgan_torch.data.csvio import plain_csv_bytes
    from fed_tgan_torch.data.decode import decode_columns
    from fed_tgan_torch.train.federated import FederatedTrainer
    from fed_tgan_torch.train.snapshots import SnapshotWriter, result_path_fn

    init, cfg = _small_federation()
    tr = FederatedTrainer(init, cfg, seed=0, device="cuda")
    path_fn = result_path_fn(str(tmp_path), "toy")
    want = []

    def hook(e, trainer):
        writer(e, trainer)
        parts = trainer.sample_parts(3000, seed=1 + e)  # blocking copy
        want.append(plain_csv_bytes(decode_columns(
            trainer.decode.assemble(parts), init.global_meta,
            init.encoders)))

    with SnapshotWriter(init.global_meta, init.encoders, path_fn, rows=3000,
                        seed=1) as writer:
        tr.fit(3, sample_hook=hook)
    for e in range(3):
        assert open(path_fn(e), "rb").read() == want[e]


def _ragged_federation():
    """Three clients of 200, 120 and 30 rows: 5, 3 and 0 steps a round at
    batch 40."""
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize

    rng = np.random.default_rng(6)
    tables = [{"x": rng.normal(0, 1, n),
               "c": rng.choice(["a", "b", "c"], n).astype(object)}
              for n in (200, 120, 30)]
    init = federated_initialize(
        [TablePreprocessor(table=t, categorical_columns=["c"])
         for t in tables], device="cpu")
    cfg = steps.TrainConfig(embedding_dim=8, gen_dims=(16, 16),
                            dis_dims=(16, 16), batch_size=40, pac=4,
                            allow_zero_step_clients=True)
    return init, cfg


def test_stacked_rounds_repeat_bit_for_bit(cuda):
    """Two stacked runs of two ragged rounds from one seed end equal
    (``torch.equal``): weights, BatchNorm state, Adam state, counts and
    every client's generator state."""
    from fed_tgan_torch.train.federated import FederatedTrainer

    init, cfg = _ragged_federation()
    a, b = (FederatedTrainer(init, cfg, seed=0, device="cuda").fit(2)
            for _ in range(2))
    assert a.steps.tolist() == [5, 3, 0]
    for x, y in ((a.stack.generator.params, b.stack.generator.params),
                 (a.stack.generator.bn_state, b.stack.generator.bn_state),
                 (a.stack.discriminator.params, b.stack.discriminator.params),
                 (a.stack.opt_g.exp_avg_sq, b.stack.opt_g.exp_avg_sq),
                 (a.stack.opt_d.exp_avg, b.stack.opt_d.exp_avg),
                 (a.stack.opt_g.count, b.stack.opt_g.count)):
        assert torch.equal(x, y)
    for g, h in zip(a.gens, b.gens):
        assert torch.equal(g.get_state(), h.get_state())
    assert np.array_equal(a.last_metrics, b.last_metrics)
    assert (a.last_metrics[2] == 0).all()


def test_stacked_round_matches_the_per_client_loop_on_the_card(cuda):
    """One round's local steps on the card against each client's
    ``train_step`` loop on the card, from the same seeds: the CPU test's
    tolerance and set-aside rule (``test_torch_stacked.py``)."""
    from test_torch_stacked import _assert_client_equal, _loop_round

    from fed_tgan_torch.train.federated import FederatedTrainer

    init, cfg = _ragged_federation()
    tr = FederatedTrainer(init, cfg, seed=2, device="cuda")
    models, gens, metrics, tiny = _loop_round(init, cfg, 2, "cuda")
    got = tr._local_steps(0).cpu().numpy()
    np.testing.assert_allclose(got, metrics, atol=1e-5, rtol=1e-4)
    aside = total = 0
    for i, (a, b) in enumerate(zip(tr.models, models)):
        n_aside, n = _assert_client_equal(a, b, tiny, f"client {i}")
        aside, total = aside + n_aside, total + n
        assert torch.equal(tr.gens[i].get_state(), gens[i].get_state())
    assert aside <= 0.05 * total, (aside, total)


def test_stacked_round_launches_k1_and_k2_once_per_step(cuda):
    """A round launches K1 max(steps) * (d_steps + 1) times and K2
    max(steps) times, each over every client's rows at once."""
    from fed_tgan_torch.train.federated import FederatedTrainer

    init, cfg = _ragged_federation()
    tr = FederatedTrainer(init, cfg, seed=0, device="cuda")
    fused_apply_activate.launches = 0
    fused_activate_bwd.launches = 0
    tr.fit(2)
    n = int(tr.steps.max())
    assert fused_apply_activate.launches == 2 * n * (cfg.d_steps + 1)
    assert fused_activate_bwd.launches == 2 * n


# ------------------------------------------------------------ serving fleet


@pytest.fixture(scope="module")
def card_fleet(tmp_path_factory):
    """Four full-width Intrusion-shaped tenants on the card (``a`` and
    ``b`` with equal weights, ``c`` and ``d`` with others) and two
    Adult-shaped ones (``e``, ``f``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from fed_tgan_torch.serve.fleet import FleetRegistry

    base = tmp_path_factory.mktemp("card_fleet")
    fleet = FleetRegistry(device="cuda", log=lambda *a: None)
    for name, seed, table in (("a", 0, "intrusion"), ("b", 0, "intrusion"),
                              ("c", 1, "intrusion"), ("d", 2, "intrusion"),
                              ("e", 0, "adult"), ("f", 1, "adult")):
        fleet.load(name, build_random_artifact(str(base / name), seed=seed,
                                               table=table))
    return fleet


LANE_TENANTS = {"intrusion": (["a", "c", "b", "d"], "protocol_type", "udp"),
                "adult": (["e", "f"], "sex", "Female")}


def _card_members(fleet, table, lanes, steps, conditional):
    from fed_tgan_torch.serve.fleet import _FleetRequest, _Member

    names, column, value = LANE_TENANTS[table]
    out = []
    for i in range(lanes):
        name = names[i % len(names)]
        rt = fleet.get(name)
        snap = rt.engine.snapshot()
        B = snap.cfg.batch_size
        cond = rt.engine.resolve_condition(column, value) if conditional \
            else None
        n, offset = steps * B - 11, 11 + (i % 3) * B
        first, skip = divmod(offset, B)
        out.append(_Member(_FleetRequest(name, n, 7 * i + 1, offset, cond,
                                         True), rt, snap, first, skip))
    return out


@pytest.mark.parametrize("lanes", [1, 2, 3, 8])
@pytest.mark.parametrize("steps", [1, 16, 128])
@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("table", ["intrusion", "adult"])
def test_lane_rows_equal_single_engine_on_the_card(card_fleet, table, lanes,
                                                   steps, conditional):
    """Contract 1 on the card: every lane of one dispatch (one stacked
    generator pass, one K1 launch, one decode, one copy) equals its
    tenant's single-engine rows bit for bit, and so its CSV bytes."""
    from fed_tgan_torch.serve.fleet import FleetService

    members = _card_members(card_fleet, table, lanes, steps, conditional)
    svc = FleetService(card_fleet, max_lanes=8, log=lambda *a: None)
    before = fused_apply_activate.launches
    host = svc.lane_pass(members, steps)
    torch.cuda.synchronize()
    assert fused_apply_activate.launches == before + 1
    for i, m in enumerate(members):
        req = m.req
        want = m.rt.engine.sample_decoded(req.n, seed=req.seed,
                                          offset=req.offset,
                                          condition=req.condition)
        got = host[i, m.skip:m.skip + req.n]
        assert np.array_equal(got, want), f"lane {i}"
    if steps == 16:
        m = members[-1]
        assert m.snap.csv_plan.csv_bytes(decode_cells(
            host[lanes - 1, m.skip:m.skip + m.req.n], m.snap.model.meta,
            m.snap.model.encoders)) == m.rt.engine.sample_csv_bytes(
            m.req.n, seed=m.req.seed, offset=m.req.offset,
            condition=m.req.condition)


def test_fleet_dispatch_launches_k1_once_per_lane_dispatch(card_fleet):
    """A backlog of same-layout requests from four tenants: K1 launches
    exactly once per lane dispatch, and every body equals the tenant's
    single-engine bytes."""
    from fed_tgan_torch.serve.fleet import FleetService, _FleetRequest

    svc = FleetService(card_fleet, max_batch=16, max_lanes=8,
                       reload_interval_s=0, log=lambda *a: None)
    reqs = [_FleetRequest(n, 5000, s, 0, None, True)
            for n in ("a", "b", "c", "d") for s in (1, 2)]
    for r in reqs:
        assert svc.submit(card_fleet.get(r.tenant), r) is None
    before = fused_apply_activate.launches
    svc.start_workers()
    for r in reqs:
        assert r.done.wait(timeout=120) and r.status == 200, r.error
    svc.shutdown(drain=True)
    snap = svc.metrics.snapshot()
    assert snap["lane_dispatches_total"] == 1
    assert snap["lane_requests_total"] == 8
    assert fused_apply_activate.launches - before == 1
    for r in reqs:
        assert r.result == card_fleet.get(r.tenant).engine.sample_csv_bytes(
            5000, seed=r.seed)


@pytest.mark.parametrize("lanes", [1, 2, 3, 8])
@pytest.mark.parametrize("n_steps", [1, 16, 128])
@pytest.mark.parametrize("layout", [(95, 282), (71, 123)],
                         ids=["intrusion", "adult"])
def test_stacked_eval_generator_equals_generator_on_the_card(cuda, lanes,
                                                             n_steps, layout):
    """The eval-mode stacked generator (each lane's ``addmm`` per block,
    one BatchNorm over every lane) equals each lane's ``Generator`` over
    the same 500-row blocks bit for bit, at the Intrusion layout's widths
    (95 conditional options, 282 dims) and the Adult layout's (71, 123)."""
    from fed_tgan_torch.models.ctgan import Generator, StackedEvalGenerator

    cfg = steps.TrainConfig()  # the full widths
    n_opt, dim = layout
    gens = []
    for s in range(lanes):
        torch.manual_seed(s)
        g = Generator(cfg.embedding_dim + n_opt, cfg.gen_dims, dim)
        with torch.no_grad():
            for b in g.blocks:
                b.bn.running_mean.normal_(0, 0.5)
                b.bn.running_var.uniform_(0.5, 2.0)
        gens.append(g.to(cuda).eval())
    B = cfg.batch_size
    x = torch.randn((lanes, n_steps * B, cfg.embedding_dim + n_opt),
                    generator=torch.Generator(device=cuda).manual_seed(lanes),
                    device=cuda)
    got = StackedEvalGenerator(gens)(x, block_rows=B)
    with torch.no_grad():
        for i, g in enumerate(gens):
            want = torch.cat([g(b) for b in x[i].split(B)])
            assert torch.equal(got[i], want), f"lane {i}"


# ------------------------------------------------------------ the canary


def test_canary_scorer_on_the_card_matches_the_cpu(cuda):
    """The mixture-CDF W1 scorer at the canary's shape, (2, C, 256)
    mixtures on 512 grid points, card against CPU within 1e-5."""
    from fed_tgan_torch.federation.sketch import column_grids, wd_scores

    rng = np.random.default_rng(0)
    shape = (2, 22, 256)
    means = rng.uniform(0.0, 1.0, shape)
    stds = np.full(shape, 1e-3)
    weights = np.full(shape, 1.0 / 256)
    grid = column_grids(means, stds, weights)
    args = (means, stds, weights, np.array([1.0, 0.0]), grid)
    on = lambda dev: wd_scores(*(torch.tensor(a, dtype=torch.float32,
                                              device=dev) for a in args))
    got = on(cuda)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), on("cpu").numpy(),
                               rtol=0, atol=ATOL)


def test_canary_launches_k1_once_per_shadow_sample(cuda, tmp_path):
    """A clean republish is promoted and a degraded one rejected; every
    shadow sample the gate draws is one engine chunk, one K1 launch."""
    from fed_tgan_torch.runtime.checkpoint import SYNTH_DIR
    from fed_tgan_torch.serve.canary import CanaryConfig
    from fed_tgan_torch.serve.demo import (
        build_demo_artifact,
        republish_demo_candidate,
    )
    from fed_tgan_torch.serve.registry import ModelRegistry
    from fed_tgan_torch.serve.service import SamplingService
    from fed_tgan_torch.testing.faults import degrade_checkpoint

    root = build_demo_artifact(str(tmp_path / "art"), device="cuda")
    svc = SamplingService(ModelRegistry(root, device="cuda",
                                        log=lambda *a: None),
                          promote="canary", canary_config=CanaryConfig(),
                          log=lambda *a: None)
    for publish, promoted in (
            (lambda: republish_demo_candidate(root, device="cuda"), True),
            (lambda: degrade_checkpoint(
                f"{root}/models/{SYNTH_DIR}", 100.0), False)):
        publish()
        k1, drawn = fused_apply_activate.launches, svc.gate.shadow_samples
        svc._maybe_reload()
        assert svc.gate.last_decision["promoted"] is promoted
        n = svc.gate.shadow_samples - drawn
        assert n >= 1 and fused_apply_activate.launches - k1 == n


# ------------------------------------------------------ the bf16 variants


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``v`` (0 at 0)."""
    a = v.float().abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 7), torch.zeros_like(a))


def _offset(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of ``t`` starting ``k`` elements past a 16-byte
    boundary (``k`` = 1 puts a bf16 operand 2 bytes off, 2 puts it 4)."""
    st = torch.empty(t.numel() + k, device=t.device, dtype=t.dtype)
    st[k:].copy_(t.flatten())
    view = st[k:].view_as(t)
    assert view.data_ptr() % 16 == (k * t.element_size()) % 16
    return view


def _bf16_variants(spec, x, u, dy):
    """The three bf16 variants on (x, u) and (dy, K1's float32 result),
    each against its plain version: results within one bf16 ulp (K2's
    also within the float32 kernels' 1e-5 where dy - sum cancels), the
    float32 residual within 1e-5.  Returns (out, res, dx)."""
    before = (dict(fused_apply_activate.variant_launches),
              dict(fused_activate_bwd.variant_launches))
    out = fused_apply_activate(x, spec, u)
    out_t, res = activate_cuda._activate(x, spec, u, residual=True)
    dx = fused_activate_bwd(dy, res, spec)
    torch.cuda.synchronize()
    assert (out.dtype, out_t.dtype, res.dtype, dx.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16)
    k1, k2 = (fused_apply_activate.variant_launches,
              fused_activate_bwd.variant_launches)
    assert (k1["bf16"] - before[0]["bf16"],
            k1["bf16_train"] - before[0]["bf16_train"],
            k2["bf16"] - before[1]["bf16"]) == (1, 1, 1)
    want, want_res = apply_activate_residual(x, spec, u)
    for got in (out, out_t):
        assert ((got.float() - want.float()).abs()
                <= _bf16_ulp(want)).all()
    assert (res - want_res).abs().max().item() <= ATOL
    want_dx = apply_activate_bwd(dy, res, spec)
    assert ((dx.float() - want_dx.float()).abs()
            <= _bf16_ulp(want_dx) + ATOL).all()
    return out, res, dx


@pytest.mark.parametrize("offset", [0, 1, 2], ids=["aligned", "2B", "4B"])
@pytest.mark.parametrize("rows", [1, 5, 500, 2000, 8000])
def test_bf16_variants_match_plain(cuda, rows, offset):
    """K1 (sampling and training) and K2 in bf16 at the main path's row
    counts, the bf16 operands aligned, 2 bytes and 4 bytes off a 16-byte
    boundary (``cp.async`` has no 2-byte size: the ragged ends take plain
    loads); misaligned results equal aligned ones bit for bit."""
    spec = _spec()
    x, u, dy = _inputs(spec, rows, 20 + rows, cuda)
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    aligned = _bf16_variants(spec, x, u, dy)
    if offset:
        got = _bf16_variants(spec, _offset(x, offset), _offset(u, 1),
                             _offset(dy, offset))
        for a, b in zip(got, aligned):
            assert torch.equal(a, b)


def test_bf16_variants_wide_and_unstaged(cuda):
    """The 70-wide segment at 64,000 rows and the widest rows (run
    unstaged: the sampling K1 keeps its logits in a float32 scratch)."""
    for info, rows in (([(1, "tanh"), (70, "softmax"), (1, "tanh"),
                         (3, "softmax")], 64000),
                       ([(1, "tanh"), (29056 - 71, "softmax"),
                         (70, "softmax")], 3)):
        spec = _spec(info)
        x, u, dy = _inputs(spec, rows, 30, cuda)
        x = x.to(torch.bfloat16)
        assert plan_for(x, spec).staged == (rows > 3)
        _bf16_variants(spec, x, u, dy.to(torch.bfloat16))


def test_bf16_wrappers_refuse_other_dtype_pairs(cuda):
    """A CUDA tensor of another dtype pair raises: nothing is cast to
    reach a variant."""
    spec = _spec()
    x, u, dy = _inputs(spec, 4, 31, cuda)
    for a, b in ((x.half(), u), (x.bfloat16(), u.bfloat16()),
                 (x, u.bfloat16())):
        with pytest.raises(TypeError):
            fused_apply_activate(a, spec, b)
    with pytest.raises(TypeError):
        fused_activate_bwd(dy.bfloat16(), u.bfloat16(), spec)
    with pytest.raises(TypeError):
        fused_activate_bwd(dy, u.bfloat16(), spec)


def test_bf16_variants_replay_in_a_cuda_graph(cuda):
    """The bf16 K1 (training variant) then K2 captured once and replayed
    on new inputs give what eager launches give."""
    spec = _spec()
    x, u, dy = _inputs(spec, 500, 40, cuda)
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            _, r = activate_cuda._activate(x, spec, u, residual=True)
            fused_activate_bwd(dy, r, spec)
            fused_apply_activate(x, spec, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, res = activate_cuda._activate(x, spec, u, residual=True)
        dx = fused_activate_bwd(dy, res, spec)
        sampled = fused_apply_activate(x, spec, u)
    for seed in (41, 42):
        fx, fu, fdy = _inputs(spec, 500, seed, cuda)
        x.copy_(fx)
        u.copy_(fu)
        dy.copy_(fdy)
        graph.replay()
        want_out, want_res, want_dx = _bf16_variants(spec, x, u, dy)
        assert torch.equal(out, want_out) and torch.equal(res, want_res)
        assert torch.equal(dx, want_dx) and torch.equal(sampled, want_out)


def test_bf16_training_on_card_repeats_bit_for_bit(cuda):
    """Two small bf16 trainings on the card from one seed end bit-equal;
    each step launches the bf16 sampling K1 (critic), the training K1 and
    K2 (generator) once, and no float32 variant; masters stay float32."""
    from fed_tgan_torch.serve.demo import intrusion_like_table

    m, cat, _, _ = intrusion_like_table(600, 0)
    cfg = steps.TrainConfig(embedding_dim=32, gen_dims=(64, 64),
                            dis_dims=(64, 64), batch_size=100,
                            precision="bf16")
    runs = []
    for _ in range(2):
        activate_cuda.reset_launches()
        synth = StandaloneSynthesizer(cfg, seed=3, device=cuda).fit(
            m, cat, epochs=2)
        torch.cuda.synchronize()
        assert fused_apply_activate.variant_launches == {
            "f32": 0, "bf16": 12, "bf16_train": 12}
        assert fused_activate_bwd.variant_launches == {"f32": 0, "bf16": 12}
        params = [p.detach().clone() for p in
                  [*synth.models.generator.parameters(),
                   *synth.models.discriminator.parameters()]]
        assert all(p.dtype == torch.float32 for p in params)
        runs.append(params)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    one = synth.sample_encoded(1500, seed=2)
    assert one.dtype == np.float32 and np.isfinite(one).all()


# ------------------------------------------------- onboarding and churn


@pytest.mark.parametrize("mates", [7, 300, 5631])
def test_bucketed_fit_is_independent_of_its_batch_on_the_card(cuda, mates):
    """One column fitted alone and among ``mates`` columns of its row
    bucket (5,631: an N = 256 cohort's 22 columns but one) gives the same
    bits on the card: every sum of the fit runs in a fixed order."""
    from fed_tgan_torch.features.bgm import fit_columns

    rng = np.random.default_rng(mates)
    col = np.concatenate([rng.normal(-2, 0.5, 90), rng.normal(4, 1, 110)])
    others = [rng.normal(rng.uniform(-5, 5), 1, 200) for _ in range(mates)]
    alone = fit_columns([col], device="cuda")[0]
    among = fit_columns(others[:3] + [col] + others[3:], device="cuda")[3]
    for f in ("means", "stds", "weights", "mean_precision", "dof",
              "stick_a", "stick_b"):
        assert np.array_equal(getattr(alone, f), getattr(among, f)), f


@pytest.mark.parametrize("slots", [4, 8])
def test_kernels_at_the_elastic_shape(cuda, slots):
    """K1 and K2 over ``slots`` x 500 rows of the Intrusion layout (an
    elastic trainer's stacked step at capacity ``slots``) against their
    plain versions."""
    spec = _spec()
    rows = slots * 500
    g = torch.Generator(device=cuda).manual_seed(slots)
    x = torch.randn((rows, spec.dim), generator=g, device=cuda) * 2.0
    u = torch.rand((rows, spec.dim), generator=g, device=cuda)
    dy = torch.randn((rows, spec.dim), generator=g, device=cuda)
    out = fused_apply_activate(x, spec, u)
    assert (out - apply_activate(x, spec, u)).abs().max().item() <= ATOL
    got = fused_activate_bwd(dy, out, spec)
    assert (got - apply_activate_bwd(dy, out, spec)).abs().max().item() \
        <= ATOL


def test_elastic_rounds_repeat_bit_for_bit_with_exact_launches(cuda):
    """An elastic trainer (capacity 8 over the ragged federation's 3
    clients) launches K1 max(steps) * (d_steps + 1) and K2 max(steps)
    times a round over all 8 slots' rows, and two runs from one seed end
    equal."""
    from fed_tgan_torch.train.federated import FederatedTrainer

    init, cfg = _ragged_federation()
    fused_apply_activate.launches = 0
    fused_activate_bwd.launches = 0
    a = FederatedTrainer(init, cfg, seed=0, device="cuda", capacity=8).fit(2)
    n = int(a.steps.max())
    assert fused_apply_activate.launches == 2 * n * (cfg.d_steps + 1)
    assert fused_activate_bwd.launches == 2 * n
    b = FederatedTrainer(init, cfg, seed=0, device="cuda", capacity=8).fit(2)
    for x, y in ((a.stack.generator.params, b.stack.generator.params),
                 (a.stack.generator.bn_state, b.stack.generator.bn_state),
                 (a.stack.discriminator.params, b.stack.discriminator.params),
                 (a.stack.opt_g.exp_avg_sq, b.stack.opt_g.exp_avg_sq)):
        assert torch.equal(x, y)
    assert (a.last_metrics[3:] == 0).all()


# ------------------------------------------------------- round-scale paths


@pytest.mark.parametrize("rows", [4000, 2000], ids=["cohort", "mdgan"])
def test_kernels_at_the_cohort_and_mdgan_shapes(cuda, rows):
    """K1 and K2 over a cohort of 8 clients' batches (4,000 rows) and 4
    MD-GAN clients' batches (2,000 rows) of the Intrusion layout against
    their plain versions."""
    spec = _spec()
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, spec.dim), generator=g, device=cuda) * 2.0
    u = torch.rand((rows, spec.dim), generator=g, device=cuda)
    dy = torch.randn((rows, spec.dim), generator=g, device=cuda)
    out = fused_apply_activate(x, spec, u)
    assert (out - apply_activate(x, spec, u)).abs().max().item() <= ATOL
    got = fused_activate_bwd(dy, out, spec)
    assert (got - apply_activate_bwd(dy, out, spec)).abs().max().item() \
        <= ATOL


def _population(n: int = 6, rows: int = 80):
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize

    rng = np.random.default_rng(8)
    tables = [{"x": rng.normal(0, 1, rows),
               "c": rng.choice(["a", "b", "c"], rows).astype(object)}
              for _ in range(n)]
    init = federated_initialize(
        [TablePreprocessor(table=t, categorical_columns=["c"])
         for t in tables], device="cpu")
    cfg = steps.TrainConfig(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),
                            batch_size=40, pac=4)
    return init, cfg


def _state(tr):
    if hasattr(tr, "gen"):
        return [tr.gen.params, tr.gen.state, tr.gen.opt.exp_avg_sq,
                tr.disc.stack.params, tr.disc.opt.exp_avg]
    st = tr.stack
    return [st.generator.params, st.generator.bn_state,
            st.discriminator.params, st.opt_g.exp_avg_sq, st.opt_d.exp_avg,
            st.opt_d.count] + list(tr.ema or [])


def test_cohort_rounds_repeat_bit_for_bit_with_exact_launches(cuda):
    """A cohort of 3 of 6 with the EMA, 3 rounds in one chunk: K1 launches
    2 and K2 once a step over the cohort's 3 x 40 rows; a second run in
    chunks of one round ends equal (``torch.equal``), cohorts included."""
    import dataclasses

    from fed_tgan_torch.train.federated import FederatedTrainer

    init, cfg = _population()
    cfg = dataclasses.replace(cfg, cohort=3, ema_decay=0.9)
    activate_cuda.reset_launches()
    a = FederatedTrainer(init, cfg, seed=0, device="cuda")
    a.fit(3, max_rounds_per_call=3)
    assert fused_apply_activate.launches == 3 * 2 * 2
    assert fused_activate_bwd.launches == 3 * 2
    assert a.host_copies == 1
    b = FederatedTrainer(init, cfg, seed=0, device="cuda").fit(3)
    assert b.host_copies == 3
    assert np.array_equal(a.last_cohort, b.last_cohort)
    for x, y in zip(_state(a), _state(b)):
        assert torch.equal(x, y)


def test_mdgan_rounds_repeat_bit_for_bit_with_exact_launches(cuda):
    """Two MD-GAN runs of two rounds from one seed end equal; K1 launches
    twice and K2 once a step over every client's rows."""
    from fed_tgan_torch.train.mdgan import MDGANTrainer

    init, cfg = _population(4)
    activate_cuda.reset_launches()
    a = MDGANTrainer(init, cfg, seed=0, device="cuda").fit(2)
    n = int(a.steps.max())
    assert fused_apply_activate.launches == 2 * n * 2
    assert fused_activate_bwd.launches == 2 * n
    b = MDGANTrainer(init, cfg, seed=0, device="cuda").fit(2)
    for x, y in zip(_state(a), _state(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a.disc.stack.params[0], a.disc.stack.params[1])


# ------------------------------------------------------- multi-process

CONCURRENT_KERNELS = r'''
import sys
import numpy as np
import torch
from fed_tgan_torch.features.transformer import output_info
from fed_tgan_torch.ops.activate_cuda import (fused_activate_bwd,
                                              fused_apply_activate)
from fed_tgan_torch.ops.segments import (SegmentSpec, apply_activate,
                                         apply_activate_bwd)
from fed_tgan_torch.serve.demo import intrusion_layout

_, _, columns = intrusion_layout(np.random.default_rng(0))
spec = SegmentSpec.from_output_info(output_info(columns))
g = torch.Generator(device="cuda").manual_seed(int(sys.argv[1]))
worst = 0.0
for _ in range(200):
    x = torch.randn((500, spec.dim), generator=g, device="cuda") * 2.0
    u = torch.rand((500, spec.dim), generator=g, device="cuda")
    dy = torch.randn((500, spec.dim), generator=g, device="cuda")
    out = fused_apply_activate(x, spec, u)
    worst = max(worst, (out - apply_activate(x, spec, u)).abs().max().item(),
                (fused_activate_bwd(dy, out, spec)
                 - apply_activate_bwd(dy, out, spec)).abs().max().item())
print(worst, fused_apply_activate.launches, fused_activate_bwd.launches)
'''


def test_k1_and_k2_at_the_participant_shape_from_two_processes(cuda,
                                                                tmp_path):
    """Two processes launch K1 and K2 at a participant's shape (500, D)
    on one card at once, as a world's participants do: each agrees with
    the plain versions (1e-5) and counts its own 200 launches of each."""
    import subprocess
    import sys

    from test_torch_world import world_env

    procs = [subprocess.Popen([sys.executable, "-c", CONCURRENT_KERNELS,
                               str(seed)], env=world_env(),
                              stdout=subprocess.PIPE, text=True)
             for seed in (1, 2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    for out in outs:
        worst, k1, k2 = out.split()
        assert float(worst) <= ATOL and int(k1) == int(k2) == 200


def test_two_participant_world_on_the_card(cuda, tmp_path):
    """A world of rank 0 and 2 participants sharing the card (gloo: the
    round's buffer staged through pinned host memory), one round: every
    rank exits 0, the ranks' generator and EMA are equal, and the
    generator is the in-process trainer's on the card (same shards and
    seed) by the round tolerance: at least 99% of the model's entries
    within atol 1e-5 + rtol 1e-3 (a 1-slot stack's GEMMs may round
    otherwise than the 2-slot stack's, and Adam's first update turns a
    tiny gradient's rounding into a full step); whether bit-equal is
    printed."""
    from fed_tgan_torch.data.csvio import read_csv, write_csv
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.data.sharding import shard_table
    from fed_tgan_torch.datasets import PRESETS, preprocessor_kwargs
    from fed_tgan_torch.federation.init import federated_initialize
    from fed_tgan_torch.serve.demo import write_intrusion_csv
    from fed_tgan_torch.train.federated import FederatedTrainer
    from test_torch_world import launch_world

    table = read_csv(write_intrusion_csv(str(tmp_path / "t.csv"), 2000, 0))
    shards = []
    for i, part in enumerate(shard_table(table, 2, "iid", seed=1)):
        shards.append(str(tmp_path / f"shard{i + 1}.csv"))
        write_csv(part, shards[-1])
    out = tmp_path / "out"
    res = launch_world(str(tmp_path), [
        "--dataset", "intrusion", "-epochs", "1", "--sample-rows", "1000",
        "--batch-size", "100", "--embedding-dim", "32", "--seed", "1",
        "--ema-decay", "0.9", "--out-dir", str(out), "--params-out",
        str(out / "params")], shards)
    assert [rc for rc, _, _ in res] == [0, 0, 0], res
    assert "collective backend gloo" in res[1][1]
    a, b = (torch.load(out / "params" / f"params_rank{r}.pt")
            for r in (1, 2))
    for part in ("generator", "ema"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])
    kw = preprocessor_kwargs(PRESETS["intrusion"])
    sel = kw.pop("selected_columns", None)
    tables = [read_csv(p) for p in shards]
    pres = [TablePreprocessor(table=t, name="Intrusion",
                              selected_columns=list(sel or tables[0]), **kw)
            for t in tables]
    init = federated_initialize(pres, seed=1)
    cfg = steps.TrainConfig(batch_size=100, embedding_dim=32, ema_decay=0.9)
    tr = FederatedTrainer(init, cfg, seed=1).fit(1)
    equal, inside, total = True, 0, 0
    for k, v in tr._global_model(use_ema=False).items():
        got, want = a["generator"][k], v.cpu()
        equal &= torch.equal(got, want)
        if got.is_floating_point():
            close = (got - want).abs() <= 1e-5 + 1e-3 * want.abs()
            inside += int(close.sum())
            total += close.numel()
    assert inside >= 0.99 * total, (inside, total)
    print(f"world on the card vs in-process after a round: {inside} of "
          f"{total} entries within the tolerance, bit-equal {equal}")


# ------------------------------------------------------------ the observatory


def _sync_count(fn):
    """Synchronising calls of ``fn()``: one warning each under
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def test_journaled_round_on_the_card_equals_the_plain_round(cuda, tmp_path):
    """Two rounds with a journal, the exporter, a tracer and the first
    chunk's program_cost (FlopCounterMode and the bytes mode around the
    real dispatch) end torch.equal to two plain rounds, with as many
    synchronising calls; the cost counts K1 and K2's bytes."""
    from fed_tgan_torch.obs import (
        RunJournal,
        TelemetryExporter,
        read_journal,
        set_journal,
        start_tracing,
        stop_tracing,
    )
    from fed_tgan_torch.train.federated import FederatedTrainer

    init, cfg = _population()
    # a process's first rounds (and its first rounds under the sync
    # debug mode) make synchronising calls of their own
    warm = FederatedTrainer(init, cfg, seed=0, device="cuda")
    _sync_count(lambda: warm.fit(2))
    plain = FederatedTrainer(init, cfg, seed=0, device="cuda")
    n_plain = _sync_count(lambda: plain.fit(2))
    obs = FederatedTrainer(init, cfg, seed=0, device="cuda")
    journal = RunJournal(str(tmp_path / "j.jsonl"), validate=True)
    set_journal(journal)
    start_tracing()
    try:
        with TelemetryExporter(port=0):
            n_obs = _sync_count(lambda: obs.fit(2))
    finally:
        set_journal(None)
        journal.close()
        stop_tracing()
    assert n_obs == n_plain
    for x, y in zip(_state(plain), _state(obs)):
        assert torch.equal(x, y)
    events = list(read_journal(journal.path))
    assert not [e for e in events if e["type"] == "schema_violation"]
    cost = [e for e in events if e["type"] == "program_cost"]
    assert len(cost) == 1 and cost[0]["flops"] > 0
    assert cost[0]["peak_bytes"] > 0
    assert cost[0]["bytes_accessed"] > 12 * 6 * 40 * obs.spec.dim
    assert len([e for e in events if e["type"] == "client_contribution"]) == 2


def test_device_trace_holds_k1_and_k2_and_the_spans(cuda, tmp_path):
    """A round under runtime/profiling.py::device_trace: the Chrome trace
    names K1 and K2 (as many launches as the counters) beside the round's
    host spans, and the journal records the trace ok."""
    import json
    import os

    from fed_tgan_torch.obs import RunJournal, read_journal, set_journal
    from fed_tgan_torch.runtime.profiling import device_trace
    from fed_tgan_torch.train.federated import FederatedTrainer

    init, cfg = _population()
    tr = FederatedTrainer(init, cfg, seed=0, device="cuda")
    tr.fit(1)
    journal = RunJournal(str(tmp_path / "j.jsonl"), validate=True)
    set_journal(journal)
    activate_cuda.reset_launches()
    try:
        with device_trace(str(tmp_path / "prof")) as d:
            assert d is not None
            tr.fit(1)
    finally:
        set_journal(None)
        journal.close()
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert sum("activate_fwd_kernel" in k for k in kernels) \
        == fused_apply_activate.launches > 0
    assert sum("activate_bwd_kernel" in k for k in kernels) \
        == fused_activate_bwd.launches > 0
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"train.local_steps", "train.aggregate.sync"} <= spans
    traced = [e for e in read_journal(journal.path)
              if e["type"] == "device_trace"]
    assert [e["ok"] for e in traced] == [True]


# ------------------------------------------------------ the sanitizers

def test_a_real_sync_trips_the_guard_and_another_thread_does_not(cuda):
    """Under ``set_sync_debug_mode("warn")`` a ``.item()``, a copy to the
    host and a blocking copy to the card inside a steady hot region raise
    SyncGuardError naming the region; the warm-up entry, a sanctioned
    copy and another thread's syncs do not."""
    import threading

    from fed_tgan_torch.analysis import sanitizers

    x = torch.ones(10, device=cuda)
    errors = []

    def other():
        try:
            for _ in range(20):
                x.sum().item()
        except Exception as exc:  # noqa: BLE001 -- the failure
            errors.append(exc)

    with sanitizers.sanitize(deterministic=False):
        assert torch.cuda.get_sync_debug_mode() == 1
        with sanitizers.hot_region("gpu.test"):
            x.sum().item()  # warm-up
        for fn in (lambda: x.sum().item(), lambda: x.cpu(),
                   lambda: torch.tensor([1.0]).to(cuda)):
            with pytest.raises(sanitizers.SyncGuardError,
                               match="gpu.test"):
                with sanitizers.hot_region("gpu.test"):
                    fn()
        with sanitizers.hot_region("gpu.test"):
            with sanitizers.sanctioned_sync():
                x.cpu()
            t = threading.Thread(target=other)
            t.start()
            t.join()
    assert errors == []
    assert torch.cuda.get_sync_debug_mode() == 0


def test_the_nan_guard_names_k1_at_its_output(cuda):
    """A NaN logit fed to K1 (a ctypes launch no dispatch mode sees)
    raises FloatingPointError naming K1 at the wrapper's check."""
    from fed_tgan_torch.analysis import sanitizers

    spec = _spec()
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((500, spec.dim), generator=g, device=cuda)
    u = torch.rand((500, spec.dim), generator=g, device=cuda)
    clean = fused_apply_activate(x, spec, u)
    x[3, 5] = float("nan")
    with sanitizers.sanitize(nan_debug=True, deterministic=False):
        with pytest.raises(FloatingPointError, match="K1"):
            fused_apply_activate(x, spec, u)
    x[3, 5] = 0.0
    with sanitizers.sanitize(nan_debug=True, deterministic=False):
        again = fused_apply_activate(x, spec, u)
    assert torch.isfinite(again).all() and again.shape == clean.shape


def test_build_budgets_and_steady_syncs_on_the_card(cuda, tmp_path):
    """A sanitized 2-client trainer builds one K1/K2 table set and one
    launch plan per stacked row count, and its steady round chunk makes
    no unsanctioned sync; an engine over two chunk sizes keeps the
    serving budget."""
    from fed_tgan_torch.analysis import sanitizers
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize
    from fed_tgan_torch.train.federated import FederatedTrainer

    rng = np.random.default_rng(5)
    tables = [{"x": np.round(rng.normal(0, 1, 120), 3),
               "c": rng.choice(["a", "b", "c"], 120).astype(object)}
              for _ in range(2)]
    init = federated_initialize(
        [TablePreprocessor(table=t, categorical_columns=["c"])
         for t in tables], seed=0, device="cuda")
    cfg = steps.TrainConfig(embedding_dim=8, gen_dims=(16,), dis_dims=(16,),
                            batch_size=40, pac=4)
    activate_cuda._plan.cache_clear()
    activate_cuda._prepared.cache_clear()
    art = build_random_artifact(str(tmp_path / "art"), seed=1, cfg=cfg)
    with sanitizers.sanitize(deterministic=False) as counter:
        tr = FederatedTrainer(init, cfg, seed=0, device="cuda")
        tr.fit(3)
        assert counter.count("tables[activate:") == 1
        assert sanitizers.check_training_budget(tr, counter) == []
        steady = [c for c in sanitizers.sync_census()
                  if c["region"] and c["entry"] > 1 and not c["sanctioned"]]
        assert steady == []
        eng = SamplingEngine(open_model(art, device="cuda"))
        eng.sample_csv_bytes(40, seed=3)
        eng.sample_csv_bytes(120, seed=3)
        eng.sample_csv_bytes(120, seed=4)
        assert len(eng.chunk_rows) == 2
        assert sanitizers.check_serving_budget(eng, counter) == []


def _raw_intrusion(n: int, seed: int):
    """An Intrusion-shaped raw table as a (rows, 42) object array and its
    categorical column indices."""
    from fed_tgan_torch.serve.demo import intrusion_like_raw

    raw = intrusion_like_raw(n, seed)
    data = np.empty((n, len(raw)), dtype=object)
    for i, v in enumerate(raw.values()):
        data[:, i] = v
    return data, [i for i, v in enumerate(raw.values()) if v.dtype.kind != "f"]


@pytest.mark.parametrize("name", ["binning", "minmax_sigmoid", "minmax_tanh",
                                  "grid"])
def test_zoo_card_tensors_equal_the_cpu(cuda, name):
    """The closed-form encoders of the zoo compute in float64 on the card
    and cast as on the CPU: the card's tensors equal the CPU's."""
    from fed_tgan_torch.features import zoo

    data, cat = _raw_intrusion(2000, 3)
    make = {"binning": lambda d: zoo.BinningTransformer(32, device=d),
            "minmax_sigmoid": lambda d: zoo.MinMaxTransformer(device=d),
            "minmax_tanh": lambda d: zoo.MinMaxTransformer("tanh", device=d),
            "grid": lambda d: zoo.GridTransformer(7, device=d)}[name]
    out = {}
    for dev in ("cuda", "cpu"):
        enc = make(dev)
        enc.fit(data, categorical_columns=cat)
        out[dev] = enc.transform(data)
        assert out[dev].device.type == dev
    assert torch.equal(out["cuda"].cpu(), out["cpu"])


def test_contract_recorder_on_the_card(cuda):
    """The program contracts' recorder on the card: each K1/K2 call is
    one kernel entry held to the wrapper's launch count, a copy to the
    host is one cross-device copy with its bytes, ``.item()`` one sync;
    host-side ops stay out of the census."""
    from fed_tgan_torch.analysis.contracts.ir import DispatchRecorder

    spec = _spec()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((64, spec.dim), generator=gen, device="cuda",
                    requires_grad=True)
    u = torch.rand((64, spec.dim), generator=gen, device="cuda")
    k1, k2 = (fused_apply_activate.launches, fused_activate_bwd.launches)
    with DispatchRecorder("cuda") as rec:
        out = fused_apply_activate(x, spec, u)
        out.sum().backward()
        host = out.detach().cpu()
        total = out.detach().sum().item()
        torch.ones(3, dtype=torch.float64).sum()  # on the host
    fp = rec.fingerprint((x, u), (host, total))
    assert (fused_apply_activate.launches - k1,
            fused_activate_bwd.launches - k2) == (1, 1)
    assert fp.kernels == {"K1[f32]": 1, "K2[f32]": 1}
    assert fp.transfers["copies"] == 1
    assert fp.transfers["copy_bytes"] == 64 * spec.dim * 4
    assert fp.transfers["syncs"] == 1 and "f64" not in fp.dtypes
    assert fp.transfers["n_inputs"] == 2 and fp.transfers["n_outputs"] == 1
