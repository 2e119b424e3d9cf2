"""The client-stacked federated round on the CPU, against what it stacks.

- ``StackedGenerator`` / ``StackedDiscriminator`` (``fed_tgan_torch.
  models.ctgan``) against per-client ``Generator`` / ``Discriminator``
  modules: outputs, gradients (the penalty's double backward included)
  and each client's BatchNorm running statistics within atol 1e-6 + rtol
  1e-5.
- ``StackedAdam`` (``train.steps``) against per-client ``torch.optim.Adam``
  + ``LambdaLR`` under ragged masks, constant and cosine schedules:
  parameters and moments within atol 1e-7 + rtol 1e-6, counts equal.
- The stacked samplers and draws against the per-client ones: equal.
- One round (``FederatedTrainer``, each client's own generator draws) on
  ragged shards, one with no step, against N sequential ``train_step``
  loops on per-client ``Models`` from the same seeds: every client's
  weights, BatchNorm state, Adam state, last gradient and metrics within
  atol 1e-5 + rtol 1e-4, the aggregate too; the draw streams consumed
  equal.  As in the JAX parity tests (``test_torch_federated.py``),
  parameter entries whose gradient fell below 1e-6 (and was not exactly
  0, as a dropped unit's is on both sides) in some step of the loop are
  set aside and counted (at most 5%): Adam turns such a gradient
  (a Linear bias before a BatchNorm has none but rounding noise) into a
  full step of either sign, so its entries follow the noise, and so does
  the running mean of a set-aside bias's feature.
- A masked client's NaN draws reach nothing; the checkpoint keeps the
  per-client layout (keys, shapes, dtypes) of the per-client trainer.
- ``serve.demo.adult_like_table`` equals ``bench.py::_adult_like``.
"""

import json
import os

import numpy as np
import pytest
import torch

import bench
from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.models.ctgan import (
    Discriminator,
    Generator,
    StackedDiscriminator,
    StackedGenerator,
)
from fed_tgan_torch.models.losses import gradient_penalty
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.parallel.fedavg import agg_leaves, robust_aggregate
from fed_tgan_torch.runtime.checkpoint import save_federated
from fed_tgan_torch.serve.demo import adult_like_table
from fed_tgan_torch.serve.engine import step_seed
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.federated import FederatedTrainer, METRICS
from fed_tgan_torch.train.sampler import (
    CondSampler,
    RowSampler,
    StackedCondSampler,
    StackedRowSampler,
)

torch.set_num_threads(1)
CFG = dict(embedding_dim=8, gen_dims=(16, 16), dis_dims=(16, 16),
           batch_size=40, pac=4)
SHARDS = (200, 120, 60, 30)  # 5, 3, 1 and 0 steps a round at batch 40
TINY = 1e-6


@pytest.fixture(scope="module")
def ragged_init(toy_frame, toy_spec):
    table = {c: toy_frame[c].to_numpy() for c in toy_frame}
    bounds = np.cumsum((0,) + SHARDS)
    tables = [{c: v[a:b] for c, v in table.items()}
              for a, b in zip(bounds[:-1], bounds[1:])]
    return federated_initialize(
        [TablePreprocessor(table=t, **toy_spec) for t in tables], seed=0,
        device="cpu")


def _close(a, b, atol, rtol, what=""):
    torch.testing.assert_close(torch.as_tensor(a).float(),
                               torch.as_tensor(b).float(), atol=atol,
                               rtol=rtol, msg=lambda m: f"{what}: {m}")


# ------------------------------------------------------------ the layers


def test_stacked_generator_matches_per_client_modules():
    torch.manual_seed(0)
    n, rows = 3, 20
    gens = [Generator(10, (16, 12), 7).train() for _ in range(n)]
    for g in gens:
        for b in g.blocks:
            b.bn.running_mean.uniform_()
            b.bn.running_var.uniform_(0.5, 1.5)
    stack = StackedGenerator.from_modules(gens)
    x = torch.randn(n, rows, 10)
    w = torch.randn(n, rows, 7)
    out = stack(x)
    (out * w).sum().backward()
    for i, g in enumerate(gens):
        want = g(x[i])
        (want * w[i]).sum().backward()
        _close(out[i].detach(), want.detach(), 1e-6, 1e-5, "output")
        grads = torch.cat([p.grad.reshape(-1) for p in g.parameters()])
        _close(stack.params.grad[i], grads, 1e-6, 1e-5, "gradient")
        state = stack.client_state(i)
        assert sorted(state) == sorted(g.state_dict())
        for k, v in g.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue  # the trainer advances it per step (masked)
            _close(state[k], v, 1e-6, 1e-5, k)
    back = stack.unstack(1)
    assert back.training
    for k, v in stack.client_state(1).items():
        assert torch.equal(back.state_dict()[k], v), k
    again = StackedGenerator(n, 10, (16, 12), 7, device="cpu")
    again.load_state_dicts(stack.state_dicts())
    assert torch.equal(again.params, stack.params)
    assert torch.equal(again.bn_state, stack.bn_state)


def test_stacked_discriminator_matches_per_client_modules():
    torch.manual_seed(1)
    n, rows, pac = 3, 20, 4
    diss = [Discriminator(9, (16, 8), pac) for _ in range(n)]
    stack = StackedDiscriminator.from_modules(diss)
    real, fake = torch.randn(n * rows, 9), torch.randn(n * rows, 9)
    alpha = torch.rand(n * rows, 1)
    keep = [torch.rand(s) < 0.5 for s in stack.keep_shapes(rows)]
    scores = stack(fake, keep)
    pen = gradient_penalty(lambda v: stack(v, keep), real, fake, alpha,
                           pac=pac, clients=n)
    (scores.mean(dim=(1, 2)).sum() + pen.sum()).backward()
    assert scores.shape == (n, rows // pac, 1) and pen.shape == (n,)
    for i, d in enumerate(diss):
        sl = slice(i * rows, (i + 1) * rows)
        k = [m[i] for m in keep]
        want = d(fake[sl], keep=k)
        want_pen = gradient_penalty(lambda v: d(v, keep=k), real[sl],
                                    fake[sl], alpha[sl], pac=pac)
        (want.mean() + want_pen).backward()
        _close(scores[i].detach(), want.detach(), 1e-6, 1e-5, "scores")
        _close(pen[i].detach(), want_pen.detach(), 1e-6, 1e-5, "penalty")
        grads = torch.cat([p.grad.reshape(-1) for p in d.parameters()])
        _close(stack.params.grad[i], grads, 1e-6, 1e-5, "gradient")


# -------------------------------------------------------------- the Adam


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_stacked_adam_matches_torch_adam(schedule):
    """Ragged masks (client 2 never steps, client 1 skips some steps)
    and both optimizers (L2 on G's): the stacked optimizer equals each
    client's torch Adam stepped only on its active steps."""
    cfg = steps.TrainConfig(**CFG, lr_schedule=schedule, lr_decay_steps=4)
    spec = SegmentSpec.from_output_info([(1, "tanh"), (3, "softmax")])
    models = [steps.init_models(spec, cfg, seed, "cpu") for seed in range(3)]
    stack = steps.stack_models(models)
    gen = torch.Generator().manual_seed(3)
    masks = [[1, 1, 0], [1, 0, 0], [1, 1, 0], [1, 1, 0], [1, 0, 0],
             [1, 1, 0], [1, 1, 0]]
    for mask in masks:
        active = torch.tensor(mask, dtype=torch.bool)
        for opt, sopt, part, sched in (
                ("opt_g", stack.opt_g, "generator", "sched_g"),
                ("opt_d", stack.opt_d, "discriminator", "sched_d")):
            grad = torch.randn(sopt.params.shape, generator=gen)
            sopt.step(grad, active)
            for i, m in enumerate(models):
                if not mask[i]:
                    continue
                params = list(getattr(m, part).parameters())
                for p, g in zip(params, grad[i].split(
                        [p.numel() for p in params])):
                    p.grad = g.view_as(p).clone()
                getattr(m, opt).step()
                getattr(m, sched).step()
    for i, m in enumerate(models):
        back = stack.to_models(i)
        for opt in ("opt_g", "opt_d"):
            want, got = getattr(m, opt), getattr(back, opt)
            assert want.param_groups[0]["lr"] == pytest.approx(
                got.param_groups[0]["lr"], rel=1e-12)
            for p, q in zip(want.param_groups[0]["params"],
                            got.param_groups[0]["params"]):
                _close(q, p, 1e-7, 1e-6, f"client {i} {opt} parameter")
                if p not in want.state:
                    assert q not in got.state
                    continue
                for k in ("exp_avg", "exp_avg_sq"):
                    _close(got.state[q][k], want.state[p][k], 1e-7, 1e-6, k)
                assert float(got.state[q]["step"]) == float(
                    want.state[p]["step"])
    assert stack.opt_g.count.tolist() == [7, 5, 0]


# ----------------------------------------------- the samplers and draws


def test_stacked_samplers_match_per_client(ragged_init):
    spec = SegmentSpec.from_output_info(ragged_init.output_info)
    mats = [np.asarray(m, np.float32) for m in ragged_init.client_matrices]
    stride = max(len(m) for m in mats)
    conds = [CondSampler.from_data(m, spec, "cpu") for m in mats]
    rows = [RowSampler.from_data(m, spec, "cpu") for m in mats]
    scond = StackedCondSampler.stack(conds)
    srows = StackedRowSampler.stack(rows, stride)
    gen = torch.Generator().manual_seed(0)
    n, batch = len(mats), 64
    col = torch.randint(0, spec.n_discrete, (n, batch), generator=gen)
    r = torch.rand((n, batch, 1), generator=gen)
    u = torch.rand((n, batch), generator=gen)
    c1, m1, _, opt = scond.train_from_draws(col, r)
    idx = srows.sample_rows(col, opt, u).view(n, batch)
    uni = srows.sample_uniform(u).view(n, batch)
    for i in range(n):
        wc, wm, _, wo = conds[i].train_from_draws(col[i], r[i])
        sl = slice(i * batch, (i + 1) * batch)
        assert torch.equal(c1[sl], wc) and torch.equal(m1[sl], wm)
        assert torch.equal(opt[i], wo)
        if len(mats[i]):
            want = rows[i].sample_rows(col[i], opt[i], u[i])
            assert torch.equal(idx[i] - i * stride, want)
            assert torch.equal(uni[i] - i * stride,
                               rows[i].sample_uniform(u[i]))
        # never another client's rows
        assert ((idx[i] >= i * stride) & (idx[i] < (i + 1) * stride)).all()


def test_draws_into_a_client_slice_equal_draw_step():
    cfg = steps.TrainConfig(**CFG, d_steps=2)
    spec = SegmentSpec.from_output_info([(1, "tanh"), (3, "softmax"),
                                         (2, "softmax")])
    models = steps.init_models(spec, cfg, 0, "cpu")
    keep = models.discriminator.keep_shapes(cfg.batch_size)
    buf = steps.stacked_draws(spec, cfg, 3, keep, "cpu")
    a, b = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want = steps.draw_step(a, models)
    got = steps.draw_step(b, models, out=steps.client_draws(buf, 1))
    for x, y, z in zip(want.tensors(), got.tensors(),
                       steps.client_draws(buf, 1).tensors()):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert torch.equal(a.get_state(), b.get_state())
    # the other slices keep their valid placeholders
    assert torch.equal(buf.d[0].perm[0], torch.arange(cfg.batch_size))


# ------------------------------------------------------------- the round


def _loop_round(init, cfg, seed, device="cpu"):
    """The per-client loop the stacked round replaces: each client's
    ``train_step``s on its own ``Models`` with its own generator.  Also
    returns, per part, which parameter entries had a nonzero gradient
    below ``TINY`` in some step of some client."""
    spec = SegmentSpec.from_output_info(init.output_info)
    models, gens, metrics, tiny = [], [], [], {}
    for i, m in enumerate(init.client_matrices):
        m = np.asarray(m, np.float32)
        models.append(steps.init_models(spec, cfg, seed, device))
        gens.append(torch.Generator(device=device).manual_seed(
            step_seed(seed, i)))
        data = torch.as_tensor(m, device=device)
        cond = CondSampler.from_data(m, spec, device)
        rows = RowSampler.from_data(m, spec, device)
        met = {k: torch.tensor(0.0) for k in METRICS}
        for _ in range(len(m) // cfg.batch_size):
            met = steps.train_step(models[-1], data, cond, rows,
                                   steps.draw_step(gens[-1], models[-1]))
            for part in ("generator", "discriminator"):
                now = [(p.grad != 0) & (p.grad.abs() < TINY)
                       for p in getattr(models[-1], part).parameters()]
                tiny[part] = [a | b for a, b in zip(tiny.get(part, now),
                                                    now)]
        metrics.append([float(met[k]) for k in METRICS])
    return models, gens, np.asarray(metrics), tiny


def _assert_client_equal(got: steps.Models, want: steps.Models, tiny: dict,
                         what: str) -> tuple:
    """Within atol 1e-5 + rtol 1e-4 outside the ``tiny`` entries; returns
    (entries set aside, entries compared) of the parameters."""
    atol, rtol = 1e-5, 1e-4
    aside = total = 0
    for part in ("generator", "discriminator"):
        masks = dict(zip((k for k, _ in getattr(want, part)
                          .named_parameters()), tiny[part]))
        masks.update({k.replace("fc.bias", "bn.running_mean"): m
                      for k, m in list(masks.items())
                      if k.endswith("fc.bias")})
        for (k, a), b in zip(getattr(got, part).state_dict().items(),
                             getattr(want, part).state_dict().values()):
            m = masks.get(k, torch.zeros(b.shape, dtype=torch.bool,
                                         device=b.device))
            _close(a[~m], b[~m], atol, rtol, f"{what} {part}.{k}")
            if k.endswith(("weight", "bias")):
                aside, total = aside + int(m.sum()), total + m.numel()
        for p, q, m in zip(getattr(got, part).parameters(),
                           getattr(want, part).parameters(), tiny[part]):
            if q.grad is None:  # a client that never stepped
                assert p.grad is None
                continue
            _close(p.grad[~m], q.grad[~m], atol, rtol,
                   f"{what} {part} gradient")
    for opt, part in (("opt_g", "generator"), ("opt_d", "discriminator")):
        a, b = getattr(got, opt), getattr(want, opt)
        assert a.param_groups[0]["lr"] == pytest.approx(
            b.param_groups[0]["lr"], rel=1e-12)
        assert len(a.state) == len(b.state)
        for p, q, m in zip(a.param_groups[0]["params"],
                           b.param_groups[0]["params"], tiny[part]):
            if q in b.state:
                assert float(a.state[p]["step"]) == float(b.state[q]["step"])
                for k in ("exp_avg", "exp_avg_sq"):
                    _close(a.state[p][k][~m], b.state[q][k][~m], atol, rtol,
                           f"{what} {opt} {k}")
    return aside, total


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_round_matches_the_per_client_loop(ragged_init, schedule):
    cfg = steps.TrainConfig(**CFG, allow_zero_step_clients=True,
                            lr_schedule=schedule, lr_decay_steps=6)
    tr = FederatedTrainer(ragged_init, cfg, seed=2, device="cpu")
    assert tr.steps.tolist() == [5, 3, 1, 0]
    models, gens, metrics, tiny = _loop_round(ragged_init, cfg, seed=2)
    with torch.no_grad():
        prev = [x[0].clone() for x in agg_leaves(tr.stack)]
    got = tr._local_steps(0).numpy()
    np.testing.assert_allclose(got, metrics, atol=1e-5, rtol=1e-4)
    assert (got[3] == 0).all()
    aside = total = 0
    for i, (a, b) in enumerate(zip(tr.models, models)):
        n_aside, n = _assert_client_equal(a, b, tiny, f"client {i}")
        aside, total = aside + n_aside, total + n
        assert torch.equal(tr.gens[i].get_state(), gens[i].get_state())
    assert aside <= 0.05 * total, (aside, total)
    # the aggregate, as the per-client trainer computed it, written into
    # a stack of the loop's clients
    want = steps.stack_models(models)
    agg, quar = robust_aggregate(prev, agg_leaves(want),
                                 torch.as_tensor(tr.weights),
                                 torch.as_tensor(tr.steps))
    assert not quar.any() and not tr._aggregate(prev).any()
    with torch.no_grad():
        for x, w in zip(agg_leaves(want), agg):
            x.copy_(w)
    for part in ("generator", "discriminator"):
        got, ref = getattr(tr.stack, part), getattr(want, part)
        m = torch.cat([t.reshape(-1) for t in tiny[part]]).expand_as(
            ref.params)
        _close(got.params.detach()[~m], ref.params.detach()[~m], 1e-5, 1e-4,
               f"aggregated {part}")
    g = want.generator
    names = [k for k, _ in g.shapes]
    m = torch.zeros_like(g.bn_state, dtype=torch.bool)
    start = 0
    for j, h in enumerate(g.widths):  # running means of set-aside biases
        bias = tiny["generator"][names.index(f"blocks.{j}.fc.bias")]
        m[start:start + g.n * h] = bias.repeat(g.n)
        start += 2 * g.n * h
    _close(tr.stack.generator.bn_state[~m], g.bn_state[~m], 1e-5, 1e-4,
           "aggregated BatchNorm state")


def test_masked_client_draws_reach_nothing(ragged_init):
    """Client 3 trains no step: NaN in its slice of the draws (noise,
    Gumbel uniforms, option uniforms, slerp positions) changes nothing of
    any client, its own state included.  Row-index uniforms stay valid:
    a draw is in [0, 1) by construction, and an index made from NaN would
    leave the table."""
    cfg = steps.TrainConfig(**CFG, allow_zero_step_clients=True)
    runs = []
    for poison in (False, True):
        tr = FederatedTrainer(ragged_init, cfg, seed=1, device="cpu")
        if poison:  # every float draw but the uniforms behind row indices
            draws = steps.client_draws(tr._draws, 3)
            rows_u = {id(d.row_u) for d in draws.d}
            for t in draws.tensors():
                if t.is_floating_point() and id(t) not in rows_u:
                    t.fill_(float("nan"))
        tr.fit(2)
        runs.append(tr)
    clean, poisoned = runs
    assert np.array_equal(clean.last_metrics, poisoned.last_metrics)
    assert (poisoned.last_metrics[3] == 0).all()
    for a, b in ((clean.stack.generator.params,
                  poisoned.stack.generator.params),
                 (clean.stack.generator.bn_state,
                  poisoned.stack.generator.bn_state),
                 (clean.stack.opt_d.exp_avg_sq, poisoned.stack.opt_d.exp_avg_sq),
                 (clean.stack.opt_g.count, poisoned.stack.opt_g.count)):
        assert torch.equal(a, b)
    assert poisoned.stack.opt_g.count.tolist() == [10, 6, 2, 0]
    assert torch.isfinite(poisoned.stack.discriminator.params).all()


def test_checkpoint_keeps_the_per_client_layout(ragged_init, tmp_path):
    """Keys, shapes and dtypes of every client entry are the ones the
    per-client trainer wrote: module ``state_dict``s, torch Adam states
    (none for a client that never stepped), the generator state."""
    cfg = steps.TrainConfig(**CFG, allow_zero_step_clients=True)
    tr = FederatedTrainer(ragged_init, cfg, seed=0, device="cpu").fit(1)
    save_federated(tr, str(tmp_path / "c"))
    want = {}
    for i, m in enumerate(tr.models):
        pre = f"client_{i:03d}"
        for part in ("generator", "discriminator"):
            for k, v in getattr(m, part).state_dict().items():
                want[f"{pre}.{part}.{k}"] = (v.shape, v.numpy().dtype)
        for part in ("opt_g", "opt_d"):
            for idx, st in getattr(m, part).state_dict()["state"].items():
                for k, v in st.items():
                    want[f"{pre}.{part}.{idx}.{k}"] = (v.shape,
                                                       v.numpy().dtype)
        want[f"{pre}.rng"] = (tr.gens[i].get_state().shape, np.uint8)
    with np.load(tmp_path / "c" / "arrays.npz") as data:
        got = {k: (data[k].shape, data[k].dtype) for k in data.files
               if k.startswith("client_")}
    assert got == {k: (tuple(s), np.dtype(d)) for k, (s, d) in want.items()}
    assert not any(k.startswith("client_003.opt_") for k in got)
    with open(tmp_path / "c" / "host.json") as f:
        clients = json.load(f)["clients"]
    assert [c["opt_g"]["sched_step"] for c in clients] == [5, 3, 1, 0]
    assert clients[0]["opt_d"]["lr"] == cfg.lr
    assert os.path.exists(tmp_path / "c" / "COMPLETE")


# ----------------------------------------------------------- Adult table


@pytest.mark.parametrize("n,seed", [(7000, 11), (300, 3)])
def test_adult_table_matches_the_reference_generator(n, seed):
    want = bench._adult_like(n, seed)
    got = adult_like_table(n, seed)
    assert list(got) == list(want.columns)
    for name in want.columns:
        np.testing.assert_array_equal(got[name], want[name].to_numpy(),
                                      err_msg=name)
