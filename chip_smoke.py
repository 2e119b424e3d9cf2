#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fed_tgan_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed S] [--rows N]
    python3 chip_smoke.py --ab TREE

Phases, each fatal on failure:

1. build the fused activation kernels (``fed_tgan_torch/csrc/activate.cu``:
   K1 forward, K2 backward) with nvcc for sm_90a;
2. hold K1 against its plain PyTorch version on the card within atol 1e-5
   at 1, 5, 500, 8,000 (the chunk of phase 4) and 64,000 rows of the
   282-wide Intrusion layout, a distant-dim underflow case, a 70-wide
   segment at 64,000 rows, the widest rows the kernels take (3 rows of
   29,056 dims, which run unstaged), operands at a 4-byte-aligned base,
   and 4 stacked clients of 500 rows (one launch bit-identical to four); at
   each shape time the kernel with CUDA events (back-to-back launches:
   the slower of host and device), its device time per launch from a
   ``torch.profiler`` trace filtered by the kernel's name, and the host's
   microseconds per call, beside the plain version and the bound, with
   the launch plan (rows per tile, blocks, shared memory);
3. the same for K2 (``out`` from K1), then the gradient of
   ``sum(w * activation(x))`` through K1 + K2 against autograd through the
   plain forward;
4. serving, slice 1's main path: build a full-width Intrusion-shaped
   artifact with random weights from ``--seed`` (embedding 128, generator
   (256, 256), batch 500), serve it over HTTP on localhost on the card and
   answer N rows unconditional (several times), the same rows in 3
   offset-contiguous chunks (must be byte-identical), one conditional
   request and ``/healthz``; every status 200, every row count right,
   every number finite; K1 must launch; then the card's output against
   the CPU's on the same injected draws, and the stages of one request
   (draws, generator, activation, decode and copy to the host, CSV);
5. training, slice 2's main path: the standalone CTGAN at full width
   (``TrainConfig()`` defaults, pac 10) on a 10,000-row Intrusion-shaped
   table for 2 epochs of 20 steps: finite losses, weights moved, K1
   launched ``epochs * steps * (d_steps + 1)`` times and K2
   ``epochs * steps`` times;
6. one train step on the card against the same step on the CPU, from
   identical weights and injected draws;
7. the trained model saved as an artifact, opened on the card and sampled
   one-shot and in 3 offset chunks (byte-identical), known codes only;
8. the stages of one train step (draws, D step, G forward, G backward
   with K2, Adam on G) one by one, then 20 steps back to back, then 20
   steps under ``torch.profiler`` for the card's busy time per step and
   K1's and K2's share of it.

``--ab TREE`` runs none of the phases: it builds the kernels of the
``fed_tgan_torch`` package under TREE (for example a ``git archive`` of an
earlier commit) and times them against this tree's in turns (other, this,
this, other) at the training batch, the serving chunk, a 128-step chunk
and the 70-wide segment, and prints one ``{"ab": ...}`` line.

Prints the card's name and power limit beside every number, a JSON line
with the training numbers, the card's line, a JSON line with the kernels'
numbers (one entry per kernel and path: K1 serving, K1 training, K2
training), and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, with no result line, when CUDA is not available.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.parse
import urllib.request

import numpy as np
import torch

from fed_tgan_torch.data.csvio import csv_bytes
from fed_tgan_torch.data.decode import decode_columns
from fed_tgan_torch.features.transformer import (
    DiscreteColumn,
    ModeNormalizer,
    output_info,
)
from fed_tgan_torch.interop import params_to_jax_layout
from fed_tgan_torch.ops import activate_cuda
from fed_tgan_torch.ops.activate_cuda import (
    fused_activate_bwd,
    fused_apply_activate,
)
from fed_tgan_torch.ops.decode import layout_decode
from fed_tgan_torch.ops.segments import (
    SegmentSpec,
    apply_activate,
    apply_activate_bwd,
)
from fed_tgan_torch.serve.demo import (
    build_random_artifact,
    intrusion_layout,
    intrusion_like_table,
    write_artifact,
)
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import open_model
from fed_tgan_torch.serve.service import SamplingService
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.sampler import CondSampler, RowSampler
from fed_tgan_torch.train.standalone import StandaloneSynthesizer

REPO = os.path.dirname(os.path.abspath(__file__))
ATOL = 1e-5
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense float32 (non-tensor) rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# per element K1 reads x and u and writes out (4 bytes each) and does about
# 10 float operations (2 logs, 1 exp, add, scale, max, subtract, sum,
# divide, select); K2 reads dy and out and writes dx and does about 5
# (multiply-add into the segment sum, subtract, multiply, divide)
BYTES_PER_ELEM = 12
OPS_PER_ELEM = {"K1": 10, "K2": 5}
TRAIN_ROWS = 10_000  # about the reference's Intrusion_test.csv (10,098 rows)
TRAIN_EPOCHS = 2


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(rows: int, dim: int, kernel: str = "K1") -> tuple[float, str]:
    t_bytes = BYTES_PER_ELEM * rows * dim / PEAK_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEM[kernel] * rows * dim / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SIZES = (("rows500", 500), ("rows8000", 8000), ("rows64000", 64000),
         ("rows5", 5), ("rows1", 1))
KERNEL_NAMES = {"K1": "activate_fwd_kernel", "K2": "activate_bwd_kernel"}
WIDE70 = [(1, "tanh"), (70, "softmax"), (1, "tanh"), (3, "softmax")]
# the widest rows the kernels take: one row of both operands fills a block
WIDEST = [(1, "tanh"), (activate_cuda.SMEM_BLOCK // 8 - 71, "softmax"),
          (70, "softmax")]
CLIENTS, CLIENT_ROWS = 4, 500  # the stacked-client rows of the federated round


def host_us(fn, n: int = 200) -> float:
    """Host time of one call of ``fn`` in microseconds, from ``n`` calls
    back to back with no synchronisation: the card's queue holds them all,
    so the host never waits for the device."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def kernel_device_ms(fn, kernel: str, n: int = 50):
    """Per-launch device time of the kernel ``kernel`` ("K1"/"K2") over
    ``n`` calls of ``fn``, from a ``torch.profiler`` trace filtered by the
    kernel's name; None when the trace holds no such kernel."""
    fn()
    torch.cuda.synchronize()
    try:
        per_name = device_events(fn, n)
    except RuntimeError:
        return None
    hits = [v for k, v in per_name.items() if KERNEL_NAMES[kernel] in k]
    if not hits:
        return None
    return sum(t for _, t in hits) / sum(c for c, _ in hits) / 1e3


def kernel_times(kernel: str, fn, rows: int) -> dict:
    """Times of one kernel call ``fn``: CUDA events over back-to-back
    calls (``ms``: the slower of host and device), the profiler's
    per-launch device time (``device_ms``) and the host's time per call
    (``host_us``)."""
    iters = 20 if rows >= 64000 else 200
    return {"ms": cuda_ms(fn, iters), "device_ms": kernel_device_ms(fn, kernel),
            "host_us": host_us(fn)}


def measure(kernel: str, fn, plain, rows: int, dim: int) -> dict:
    """:func:`kernel_times` beside the plain version's time and the
    bound."""
    bound, bound_by = bound_ms(rows, dim, kernel)
    return {**kernel_times(kernel, fn, rows),
            "plain_ms": cuda_ms(plain, 20 if rows >= 64000 else 200),
            "bound_ms": bound, "bound_by": bound_by}


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base is 4 bytes past a 16-byte
    boundary (a view at storage offset 1)."""
    st = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    st[1:].copy_(t.flatten())
    return st[1:].view_as(t)


def _cases(spec: SegmentSpec, gen, sizes, extra: bool) -> list:
    """(name, spec, x) for each shape; with ``extra`` also a distant-dim
    underflow case, the 70-wide segment at 64,000 rows, the widest rows,
    a misaligned base and the stacked clients of one round."""
    randn = lambda rows, sp=spec: torch.randn(
        (rows, sp.dim), generator=gen, device="cuda") * 2.0
    cases = [(name, spec, randn(rows)) for name, rows in sizes]
    if extra:
        x = torch.zeros((8, spec.dim), device="cuda")
        x[:, 0] = 50.0  # a huge tanh pre-activation
        x[:, 1] = 30.0  # one hot logit in the next softmax segment
        wide = SegmentSpec.from_output_info(WIDE70)
        widest = SegmentSpec.from_output_info(WIDEST)
        cases += [("underflow", spec, x), ("wide70", wide, randn(64000, wide)),
                  ("widest", widest, randn(3, widest)),
                  ("misaligned", spec, randn(500)),
                  ("stacked", spec, randn(CLIENTS * CLIENT_ROWS))]
    return cases


def _stacked_equal(fn, *args) -> None:
    """One launch over the stacked clients' rows is bit-identical to one
    launch per client."""
    whole = fn(*args)
    parts = [fn(*(a[i * CLIENT_ROWS:(i + 1) * CLIENT_ROWS] for a in args))
             for i in range(CLIENTS)]
    if not torch.equal(whole, torch.cat(parts)):
        raise AssertionError("stacked launch differs from per-client launches")


def _report(kernel, name, rows, spec, err, times, plan, card) -> dict:
    print(f"{kernel} {name}: ({rows}, {spec.dim}) max_abs_err {err!r} (atol "
          f"{ATOL}) kernel {times['ms']!r} ms, device {times['device_ms']!r} "
          f"ms, host {times['host_us']!r} us; plain {times['plain_ms']!r} ms; "
          f"bound {times['bound_ms']!r} ms ({times['bound_by']}); plan "
          f"{plan}  [{card}]", flush=True)
    if not err <= ATOL:
        raise AssertionError(f"{kernel} {name}: max_abs_err {err} > {ATOL}")
    return {"shape": [rows, spec.dim], "case": name, "max_abs_err": err,
            **times, "plan": plan}


def check_kernel(spec: SegmentSpec, card: str, sizes=SIZES,
                 extra: bool = True) -> list[dict]:
    """Phase 2: K1 against its plain version at each shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name, sp, x in _cases(spec, gen, sizes, extra):
        rows = x.shape[0]
        u = torch.rand(x.shape, generator=gen, device="cuda")
        if name == "misaligned":
            x, u = misaligned(x), misaligned(u)
        if name == "stacked":
            _stacked_equal(lambda a, b: fused_apply_activate(a, sp, b), x, u)
        got = fused_apply_activate(x, sp, u)
        want = apply_activate(x, sp, u)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        times = measure("K1", lambda: fused_apply_activate(x, sp, u),
                        lambda: apply_activate(x, sp, u), rows, sp.dim)
        plan = activate_cuda.plan_for(x, sp).as_dict()
        results.append(_report("K1", name, rows, sp, err, times, plan, card))
    return results


def check_bwd_kernel(spec: SegmentSpec, card: str, sizes=SIZES,
                     extra: bool = True) -> list[dict]:
    """Phase 3: K2 against its plain version at each shape (``out`` from
    K1), then the gradient through K1 + K2 against autograd through the
    plain forward."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = []
    for name, sp, x in _cases(spec, gen, sizes, extra):
        rows = x.shape[0]
        u = torch.rand(x.shape, generator=gen, device="cuda")
        out = fused_apply_activate(x, sp, u)
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        if name == "misaligned":
            dy, out = misaligned(dy), misaligned(out)
        if name == "stacked":
            _stacked_equal(lambda a, b: fused_activate_bwd(a, b, sp), dy, out)
        got = fused_activate_bwd(dy, out, sp)
        want = apply_activate_bwd(dy, out, sp)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        times = measure("K2", lambda: fused_activate_bwd(dy, out, sp),
                        lambda: apply_activate_bwd(dy, out, sp), rows, sp.dim)
        plan = activate_cuda.plan_for(dy, sp).as_dict()
        results.append(_report("K2", name, rows, sp, err, times, plan, card))

    # the gradient of sum(w * activation(x)) through the autograd Function
    x = torch.randn((500, spec.dim), generator=gen, device="cuda") * 2.0
    u = torch.rand(x.shape, generator=gen, device="cuda")
    w = torch.randn(x.shape, generator=gen, device="cuda")
    k1, k2 = fused_apply_activate.launches, fused_activate_bwd.launches
    xg = x.clone().requires_grad_(True)
    (w * fused_apply_activate(xg, spec, u)).sum().backward()
    xp = x.clone().requires_grad_(True)
    (w * apply_activate(xp, spec, u)).sum().backward()
    torch.cuda.synchronize()
    if (fused_apply_activate.launches - k1, fused_activate_bwd.launches - k2) \
            != (1, 1):
        raise AssertionError("the autograd path did not launch K1 and K2 once")
    err = (xg.grad - xp.grad).abs().max().item()
    print(f"K1+K2 autograd: d/dx sum(w * act(x)) at (500, {spec.dim}) vs "
          f"autograd through the plain forward: max_abs_err {err!r} "
          f"(atol {ATOL})  [{card}]", flush=True)
    if not err <= ATOL:
        raise AssertionError(f"activation gradient error {err} > {ATOL}")
    results.append({"shape": [500, spec.dim], "case": "autograd",
                    "max_abs_err": err})
    return results


def load_parent(root: str):
    """Another tree's ``fed_tgan_torch/ops/activate_cuda.py`` (its own
    kernel source and build directory) as a module of its own; it shares
    this tree's plain versions and ``SegmentSpec``."""
    import importlib.util

    path = os.path.join(root, "fed_tgan_torch", "ops", "activate_cuda.py")
    mod_spec = importlib.util.spec_from_file_location("parent_activate_cuda",
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def main_shapes(seed: int) -> list:
    """(name, spec, rows) of the main path's kernel shapes: the training
    batch (500 rows of the layout the trainer fits to the training table),
    the serving chunk (8,000), a 128-step chunk (64,000) and the 70-wide
    segment at 64,000 rows."""
    matrix, cat_idx, _, _ = intrusion_like_table(TRAIN_ROWS, seed)
    train_spec = SegmentSpec.from_output_info(
        ModeNormalizer(device="cuda").fit(matrix, cat_idx).output_info)
    _, _, columns = intrusion_layout(np.random.default_rng(seed))
    spec = SegmentSpec.from_output_info(output_info(columns))
    return [("train", train_spec, 500), ("rows8000", spec, 8000),
            ("rows64000", spec, 64000),
            ("wide70", SegmentSpec.from_output_info(WIDE70), 64000)]


def _operands(sp: SegmentSpec, rows: int, gen) -> tuple:
    x = torch.randn((rows, sp.dim), generator=gen, device="cuda") * 2.0
    u = torch.rand(x.shape, generator=gen, device="cuda")
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    return x, u, dy, apply_activate(x, sp, u)


def ab_phase(parent_root: str, shapes: list, card: str) -> list[dict]:
    """The other tree's K1 and K2 against this tree's on the same inputs,
    in turns (other, this, this, other), at ``shapes``."""
    parent = load_parent(parent_root)
    t0 = time.perf_counter()
    parent.build()
    print(f"built the other tree's kernels in {time.perf_counter() - t0!r} s"
          f"  [{card}]", flush=True)
    sides = {"parent": (parent.fused_apply_activate, parent.fused_activate_bwd),
             "change": (fused_apply_activate, fused_activate_bwd)}
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = []
    for name, sp, rows in shapes:
        x, u, dy, out = _operands(sp, rows, gen)
        for kernel in ("K1", "K2"):
            want = out if kernel == "K1" else apply_activate_bwd(dy, out, sp)
            runs = []
            for side in ("parent", "change", "change", "parent"):
                fwd, bwd = sides[side]
                fn = ((lambda: fwd(x, sp, u)) if kernel == "K1"
                      else (lambda: bwd(dy, out, sp)))
                err = (fn() - want).abs().max().item()
                if not err <= ATOL:
                    raise AssertionError(f"{side} {kernel} {name}: max_abs_err"
                                         f" {err} > {ATOL}")
                runs.append({"side": side, "max_abs_err": err,
                             **kernel_times(kernel, fn, rows)})
            bound, bound_by = bound_ms(rows, sp.dim, kernel)
            entry = {"kernel": kernel, "case": name, "shape": [rows, sp.dim],
                     "bound_ms": bound, "bound_by": bound_by, "runs": runs}
            for side in ("parent", "change"):
                mine = [r for r in runs if r["side"] == side]
                entry[side] = {k: statistics.mean(r[k] for r in mine)
                               if all(r[k] is not None for r in mine) else None
                               for k in ("ms", "device_ms", "host_us")}
            print(f"A/B {kernel} {name} ({rows}, {sp.dim}): other tree "
                  f"{entry['parent']}, this tree {entry['change']}; bound "
                  f"{bound!r} ms  [{card}]", flush=True)
            results.append(entry)
    return results


def train_phase(seed: int, card: str):
    """Phase 5: the standalone trainer at full width on the card."""
    rows = TRAIN_ROWS
    matrix, cat_idx, meta, encoders = intrusion_like_table(rows, seed)
    cfg = steps.TrainConfig()
    synth = StandaloneSynthesizer(cfg, seed=seed, device="cuda")
    fused_apply_activate.launches = 0
    fused_activate_bwd.launches = 0
    synth.fit(matrix, cat_idx, epochs=TRAIN_EPOCHS)
    launches = {"K1": fused_apply_activate.launches,
                "K2": fused_activate_bwd.launches}
    steps_per_epoch = rows // cfg.batch_size
    total = TRAIN_EPOCHS * steps_per_epoch
    want = {"K1": total * (cfg.d_steps + 1), "K2": total}
    m = synth.metrics
    epoch_ms = [t * 1e3 / steps_per_epoch for t in synth.timings["epoch_s"]]
    print(f"train: {rows} x {matrix.shape[1]} table -> layout width "
          f"{synth.spec.dim} (conditional {synth.spec.n_opt}), "
          f"{TRAIN_EPOCHS} epochs x {steps_per_epoch} steps of "
          f"{cfg.batch_size} rows; BGM fit {synth.timings['bgm_fit_s']!r} s; "
          f"ms/step by epoch {epoch_ms!r}; last loss_d {m['loss_d']!r} pen "
          f"{m['pen']!r} loss_g {m['loss_g']!r}; launches {launches} "
          f"(expected {want})  [{card}]", flush=True)
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"non-finite training losses {m}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    fresh = steps.init_models(synth.spec, cfg, seed, "cpu")
    for name, a, b in (("generator", fresh.generator, synth.models.generator),
                       ("discriminator", fresh.discriminator,
                        synth.models.discriminator)):
        if all(torch.equal(p, q.cpu()) for p, q in
               zip(a.parameters(), b.parameters())):
            raise AssertionError(f"the {name}'s weights did not move")
    return synth, meta, encoders, {
        "rows": rows, "dim": synth.spec.dim, "n_opt": synth.spec.n_opt,
        "epochs": TRAIN_EPOCHS, "steps_per_epoch": steps_per_epoch,
        "bgm_fit_s": synth.timings["bgm_fit_s"], "ms_per_step": epoch_ms[-1],
        "ms_per_step_by_epoch": epoch_ms, "launches": launches, "losses": m}


def _close(name, a, b, atol, rtol, skip=None) -> tuple[float, int]:
    """Assert ``a`` close to ``b`` outside ``skip``; returns the worst
    excess ``|a - b| - rtol |b|`` and the number of skipped entries."""
    keep = np.ones(a.shape, dtype=bool) if skip is None else ~skip
    diff = np.abs(a - b)[keep]
    if diff.size and not (diff <= atol + rtol * np.abs(b[keep])).all():
        raise AssertionError(f"{name}: card vs CPU max abs diff "
                             f"{diff.max()} (atol {atol}, rtol {rtol})")
    return float(diff.max()) if diff.size else 0.0, int((~keep).sum())


def step_reference_phase(synth, seed: int, card: str) -> dict:
    """Phase 6: one train step on the card against the CPU, from the same
    initial weights and the same injected draws."""
    train = synth.train_data.cpu().numpy()
    spec, cfg = synth.spec, synth.cfg
    draws = steps.draw_step(torch.Generator().manual_seed(seed + 2),
                            steps.init_models(spec, cfg, seed + 1, "cpu"))
    runs = {}
    for dev in ("cuda", "cpu"):
        models = steps.init_models(spec, cfg, seed + 1, dev)
        met = steps.train_step(
            models, torch.as_tensor(train, device=dev),
            CondSampler.from_data(train, spec, dev),
            RowSampler.from_data(train, spec, dev), draws.to(dev))
        runs[dev] = ({k: float(v) for k, v in met.items()},
                     params_to_jax_layout(models),
                     params_to_jax_layout(models, of=lambda p: p.grad))
    (met_c, par_c, grad_c), (met_h, par_h, grad_h) = runs["cuda"], runs["cpu"]
    for k in met_h:
        if not math.isclose(met_c[k], met_h[k], rel_tol=1e-4, abs_tol=1e-6):
            raise AssertionError(f"{k}: card {met_c[k]} vs CPU {met_h[k]}")
    flat = lambda tree: [np.asarray(x) for x in _leaves(tree)]
    grad_err, par_err, skipped = 0.0, 0.0, 0
    for part in ("params_g", "params_d"):
        for gc, gh, pc, ph in zip(flat(grad_c[part]), flat(grad_h[part]),
                                  flat(par_c[part]), flat(par_h[part])):
            grad_err = max(grad_err, _close("gradient", gc, gh, 1e-5, 1e-3)[0])
            # Adam's first update is g / (|g| + 1e-8): a gradient below
            # 1e-6 may take the other sign on the other device
            err, n = _close("parameter", pc, ph, 1e-6, 0.0,
                            skip=np.abs(gh) < 1e-6)
            par_err, skipped = max(par_err, err), skipped + n
    print(f"train step: card vs CPU from the same weights and draws: losses "
          f"{met_c} vs {met_h} (rtol 1e-4); gradients max abs diff "
          f"{grad_err!r} (atol 1e-5 + rtol 1e-3); parameters max abs diff "
          f"{par_err!r} (atol 1e-6) with {skipped} tiny-gradient entries set "
          f"aside  [{card}]", flush=True)
    return {"losses_card": met_c, "losses_cpu": met_h, "grad_max_diff":
            grad_err, "param_max_diff": par_err, "tiny_grad_entries": skipped}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serve_trained_phase(synth, meta, encoders, rows: int, seed: int,
                        card: str) -> None:
    """Phase 7: the trained model as an artifact, sampled on the card."""
    build_root = os.path.join(REPO, "fed_tgan_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    art = tempfile.mkdtemp(prefix="chip_smoke_trained_", dir=build_root)
    try:
        write_artifact(art, synth.to_saved(), meta, encoders)
        engine = SamplingEngine(open_model(art, device="cuda"))
        one = engine.sample_csv_bytes(rows, seed=seed)
        parts, done = [], 0
        for i, n in enumerate((rows // 3, rows // 3, rows - 2 * (rows // 3))):
            parts.append(engine.sample_csv_bytes(n, seed=seed, offset=done,
                                                 header=i == 0))
            done += n
        if b"".join(parts) != one:
            raise AssertionError("trained model: chunked bytes differ")
        mat = engine.sample_decoded(rows, seed=seed)
        for j, col in enumerate(engine.model.synth.columns):
            if isinstance(col, DiscreteColumn):
                if not np.isin(mat[:, j], col.codes).all():
                    raise AssertionError(f"column {col.name}: unknown code")
            elif not np.isfinite(mat[:, j]).all():
                raise AssertionError(f"column {col.name}: non-finite value")
    finally:
        shutil.rmtree(art, ignore_errors=True)
    print(f"serve trained: {rows} rows one-shot == 3 offset chunks "
          "(byte-identical); categorical columns hold known codes only, "
          f"continuous ones finite  [{card}]", flush=True)


def train_stage_breakdown(synth, seed: int, card: str,
                          repeats: int = 5) -> dict:
    """Phase 8: where one train step's time goes, stage by stage (host
    clock, the device synchronised at every boundary), medians over
    ``repeats`` after one warm-up; then ``ms_per_step``, 20 steps back to
    back with one synchronisation."""
    models = steps.init_models(synth.spec, synth.cfg, seed, "cuda")
    data, cond, rows = synth.train_data, synth.cond, synth.rows
    gen = torch.Generator(device="cuda").manual_seed(seed)
    times: dict = {k: [] for k in ("draws", "d_step", "g_forward",
                                   "g_backward", "adam_g")}

    def tick(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[name].append(t1 - t0)
        return t1

    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        draws = steps.draw_step(gen, models)
        t = tick("draws", t)
        for d in draws.d:
            steps.d_update(models, data, cond, rows, d)
        t = tick("d_step", t)
        loss = steps.g_loss(models, cond, draws.g)
        t = tick("g_forward", t)
        params = list(models.generator.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        t = tick("g_backward", t)
        models.opt_g.step()
        models.sched_g.step()
        tick("adam_g", t)
    ms = {k: statistics.median(v[1:]) * 1e3 for k, v in times.items()}
    total = sum(ms.values())
    n = 20
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        steps.train_step(models, data, cond, rows, steps.draw_step(gen, models))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / n
    print(f"stages of one train step (batch {synth.cfg.batch_size}, layout "
          f"{synth.spec.dim}), median ms: " + ", ".join(
              f"{k} {v!r} ({100 * v / total:.1f}%)" for k, v in ms.items())
          + f"; {n} steps back to back: {step_ms!r} ms/step  [{card}]",
          flush=True)
    device = device_profile(
        lambda: steps.train_step(models, data, cond, rows,
                                 steps.draw_step(gen, models)), n)
    if device.get("busy_ms_per_step") is not None:
        device["busy_share"] = device["busy_ms_per_step"] / step_ms
    print(f"train step on the device ({n} steps under torch.profiler): "
          f"{json.dumps(device)}; busy share of the unprofiled "
          f"{step_ms!r} ms/step  [{card}]", flush=True)
    return {"stages_ms": ms, "ms_per_step_steady": step_ms,
            "device": device}


def device_events(fn, n: int) -> dict:
    """Name -> (count, summed microseconds) of the device events of ``n``
    calls of ``fn`` in a ``torch.profiler`` trace.  A record_function
    range (such as Optimizer.step) also shows on the device timeline,
    spanning kernels that are counted anyway, so annotation ranges are
    left out.  Raises the profiler's own RuntimeError."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            cnt, tot = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (cnt + 1, tot + e.time_range.elapsed_us())
    return per_name


def device_profile(fn, n: int) -> dict:
    """Device work of ``n`` calls of ``fn``: kernels and copies per call,
    their summed device time per call (one stream, so the sum is the busy
    time), the five kernels that take the most of it, and K1's and K2's
    time per call and share of the busy time.  ``busy_ms_per_step`` is
    None when the trace holds no device events."""
    fn()
    torch.cuda.synchronize()
    try:
        per_name = device_events(fn, n)
    except RuntimeError as exc:  # the profiler itself, not the step
        return {"busy_ms_per_step": None, "error": str(exc)[:200]}
    if not per_name:
        return {"busy_ms_per_step": None}
    busy_us = sum(t for _, t in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:5]
    activation = {}
    for kernel, name in KERNEL_NAMES.items():
        hits = [v for k, v in per_name.items() if name in k]
        us = sum(t for _, t in hits)
        activation[kernel] = {
            "per_step": sum(c for c, _ in hits) / n,
            "ms_per_step": us / 1e3 / n, "share_of_busy": us / busy_us}
    return {
        "busy_ms_per_step": busy_us / 1e3 / n,
        "device_ops_per_step": sum(c for c, _ in per_name.values()) / n,
        "top": [{"name": k[:80], "per_step": c / n, "ms_per_step": t / 1e3 / n}
                for k, (c, t) in top],
        "activation": activation,
    }


def fetch(url: str) -> tuple[int, bytes, float]:
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=300) as resp:
        body = resp.read()
        status = resp.status
    return status, body, time.perf_counter() - t0


def check_csv(blob: bytes, rows: int, header: bool, numeric: list) -> None:
    lines = list(csv.reader(io.StringIO(blob.decode())))
    if len(lines) != rows + header:
        raise AssertionError(f"expected {rows} rows, got {len(lines) - header}")
    for line in lines[header:]:
        for i in numeric:
            if not math.isfinite(float(line[i])):
                raise AssertionError(f"non-finite value in row {line}")


def serve_phase(art: str, rows: int, seed: int, card: str) -> dict:
    """Phase 4: the HTTP service on the card."""
    model = open_model(art, device="cuda")
    names = model.meta.column_names
    numeric = [i for i, n in enumerate(names)
               if n in model.meta.continuous_columns]
    service = SamplingService(model).start()
    try:
        q = lambda **kw: f"{service.url}/sample?{urllib.parse.urlencode(kw)}"
        status, one_shot, first_s = fetch(q(rows=rows, seed=seed))
        assert status == 200, status
        check_csv(one_shot, rows, True, numeric)
        latencies = []
        for _ in range(5):
            status, body, dt = fetch(q(rows=rows, seed=seed))
            assert status == 200 and body == one_shot, "repeat differs"
            latencies.append(dt)
        parts, done = [], 0
        for i, n in enumerate((rows // 3, rows // 3, rows - 2 * (rows // 3))):
            status, body, _ = fetch(q(rows=n, seed=seed, offset=done,
                                      header=int(i == 0)))
            assert status == 200, status
            check_csv(body, n, i == 0, numeric)
            parts.append(body)
            done += n
        if b"".join(parts) != one_shot:
            raise AssertionError("chunked bytes differ from the one-shot")
        status, body, _ = fetch(q(rows=600, seed=seed + 1,
                                  column="protocol_type", value="tcp"))
        assert status == 200, status
        check_csv(body, 600, True, numeric)
        status, body, _ = fetch(f"{service.url}/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok", health
        assert health["device"].startswith("cuda"), health
    finally:
        service.shutdown()
    p50 = statistics.median(latencies)
    rate = rows * len(latencies) / sum(latencies)
    print(f"serve: {rows} rows x {len(latencies)} requests: {rate!r} rows/s, "
          f"p50 latency {p50 * 1e3!r} ms (first request {first_s * 1e3!r} "
          f"ms); chunked == one-shot; health {health}  [{card}]", flush=True)
    return {"rows_per_s": rate, "p50_ms": p50 * 1e3}


def stage_breakdown(art: str, rows: int, seed: int, card: str,
                    repeats: int = 5) -> dict:
    """Where one ``rows``-row request's time goes, stage by stage (host
    clock, the device synchronised at every stage boundary), medians over
    ``repeats`` after one warm-up.  The stages are the engine's own steps
    run one by one, so their sum exceeds the unsynchronised request."""
    engine = SamplingEngine(open_model(art, device="cuda"))
    synth, cfg, spec = engine.model.synth, engine.cfg, engine.spec
    B = cfg.batch_size
    steps = -(-rows // B)
    steps = engine._chunk_plan(0, steps)[0][1]
    times: dict = {k: [] for k in ("draws", "generator", "activation",
                                   "decode_d2h", "csv")}

    def tick(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        times[name].append(t1 - t0)
        return t1

    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        z, c, u = engine._draw(seed + synth.key_offset, 0, steps, None, None)
        t = tick("draws", t)
        with torch.no_grad():
            x = torch.cat([z, c], dim=1)
            raw = torch.cat([synth.generator(b) for b in x.split(B)])
        t = tick("generator", t)
        enc = fused_apply_activate(raw, spec, u)
        t = tick("activation", t)
        mat = layout_decode(enc, engine._tables).cpu().numpy()[:rows]
        t = tick("decode_d2h", t)
        csv_bytes(decode_columns(mat, engine.model.meta,
                                 engine.model.encoders))
        tick("csv", t)
    ms = {k: statistics.median(v[1:]) * 1e3 for k, v in times.items()}
    total = sum(ms.values())
    print(f"stages of one {rows}-row request ({steps} steps x {B} rows), "
          "median ms: " + ", ".join(
              f"{k} {v!r} ({100 * v / total:.1f}%)" for k, v in ms.items())
          + f"  [{card}]", flush=True)
    return ms


def reference_phase(art: str, seed: int, card: str) -> None:
    """Serving on the card vs the CPU on the same injected draws (2
    steps)."""
    gpu = SamplingEngine(open_model(art, device="cuda"))
    cpu = SamplingEngine(open_model(art, device="cpu"))
    cfg, spec = gpu.cfg, gpu.spec
    cond = cpu.model.synth.cond

    def draws(step):
        r = np.random.default_rng([seed, step])
        col = torch.as_tensor(r.integers(0, spec.n_discrete, cfg.batch_size))
        c = cond.empirical_from_draws(
            col, torch.as_tensor(r.random((cfg.batch_size, 1)),
                                 dtype=torch.float32)).numpy()
        return (r.standard_normal((cfg.batch_size, cfg.embedding_dim)), c,
                r.random((cfg.batch_size, spec.dim)))

    n = 2 * cfg.batch_size
    enc_g = gpu.sample_encoded(n, seed=seed, draws=draws)
    enc_c = cpu.sample_encoded(n, seed=seed, draws=draws)
    err = float(np.abs(enc_g - enc_c).max())
    dec_g = gpu.sample_decoded(n, seed=seed, draws=draws)
    dec_c = cpu.sample_decoded(n, seed=seed, draws=draws)
    # a row whose softmax segment has two outputs within 1e-3 may take the
    # other argmax on the other device: excluded and counted
    near = np.zeros(n, dtype=bool)
    for start, size in zip(np.cumsum([0] + [s for s, _ in spec.output_info]),
                           [s for s, _ in spec.output_info]):
        if size > 1:
            top = np.sort(enc_c[:, start:start + size], axis=1)
            near |= (top[:, -1] - top[:, -2]) < 1e-3
    np.testing.assert_allclose(dec_g[~near], dec_c[~near], rtol=1e-4,
                               atol=1e-5)
    print(f"reference: card vs CPU on injected draws, {n} rows: encoded "
          f"max_abs_err {err!r} (atol 1e-4); decoded rtol 1e-4 on "
          f"{int((~near).sum())} rows ({int(near.sum())} near-tie rows "
          f"excluded)  [{card}]", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"card vs CPU encoded error {err} > 1e-4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=5000)
    ap.add_argument("--ab", metavar="TREE",
                    help="instead of the phases: time the kernels of the "
                    "fed_tgan_torch package under TREE against this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib, log = activate_cuda.build()
    print(f"built {os.path.relpath(lib, REPO)} in "
          f"{time.perf_counter() - t0!r} s  [{card}]", flush=True)
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")

    if args.ab:
        print(json.dumps({"ab": ab_phase(args.ab, main_shapes(args.seed),
                                         card)}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    _, _, columns = intrusion_layout(np.random.default_rng(args.seed))
    spec = SegmentSpec.from_output_info(output_info(columns))
    shapes = check_kernel(spec, card)
    bwd_shapes = check_bwd_kernel(spec, card)

    build_root = os.path.join(REPO, "fed_tgan_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    art = tempfile.mkdtemp(prefix="chip_smoke_art_", dir=build_root)
    try:
        build_random_artifact(art, seed=args.seed)
        fused_apply_activate.launches = 0
        fused_activate_bwd.launches = 0
        serving = serve_phase(art, args.rows, args.seed, card)
        serve_launches = fused_apply_activate.launches
        serve_k2 = fused_activate_bwd.launches
        print(f"K1 launches during serving: {serve_launches} (K2: "
              f"{serve_k2})  [{card}]", flush=True)
        if serve_launches <= 0:
            raise AssertionError("the served path never launched K1")
        reference_phase(art, args.seed, card)
        serving["stages_ms"] = stage_breakdown(art, args.rows, args.seed, card)
    finally:
        shutil.rmtree(art, ignore_errors=True)

    synth, meta, encoders, training = train_phase(args.seed, card)
    # both kernels again at the shape training gave them: (batch, the
    # fitted layout's width)
    train_size = (("train", synth.cfg.batch_size),)
    shapes += check_kernel(synth.spec, card, train_size, extra=False)
    bwd_shapes += check_bwd_kernel(synth.spec, card, train_size, extra=False)
    training["card_vs_cpu"] = step_reference_phase(synth, args.seed, card)
    serve_trained_phase(synth, meta, encoders, args.rows, args.seed, card)
    training.update(train_stage_breakdown(synth, args.seed, card))

    def entry(name, replaces, path, results, main_case, launches):
        """One kernel on one path: its time and bound at the shape that
        path gives it, and its launches during that path's run."""
        main = next(r for r in results if r["case"] == main_case)
        return {
            "name": name, "route": "cuda",
            "source": "fed_tgan_torch/csrc/activate.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "device_ms": main["device_ms"], "host_us": main["host_us"],
            "plan": main["plan"],
            # no single PyTorch call computes a segmented Gumbel-softmax
            # or its gradient
            "library_ms": None, "path": path, "shape": main["shape"],
            "shapes": results,
        }

    fwd, bwd = ("fed_tgan_tpu/ops/activate_pallas.py:81",
                "fed_tgan_tpu/ops/activate_pallas.py:102")
    kernels = [
        # K1 on slice 1's serving path keeps the name, shape (the 8,000-row
        # chunk) and launch count it has had since that slice
        entry("fused_gumbel_activation_fwd", fwd, "serving", shapes,
              "rows8000", serve_launches),
        entry("fused_gumbel_activation_fwd_train", fwd, "training", shapes,
              "train", training["launches"]["K1"]),
        entry("fused_gumbel_activation_bwd", bwd, "training", bwd_shapes,
              "train", training["launches"]["K2"]),
    ]
    print(json.dumps({"training": training}))
    print(card)
    print(json.dumps({"kernels": kernels, "serving": serving}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
