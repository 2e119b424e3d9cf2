#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fed_tgan_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed S] [--rows N]

Phases, each fatal on failure:

1. build the fused activation kernel (``fed_tgan_torch/csrc/activate.cu``)
   with nvcc for sm_90a;
2. hold the kernel against its plain PyTorch version on the card at the
   serving shapes (500 and 64,000 rows of the 282-wide Intrusion layout,
   the 8,000-row chunk of phase 4, 5 rows, and a distant-dim underflow
   case) within atol 1e-5, and time both with CUDA events;
3. build a full-width Intrusion-shaped artifact with random weights from
   ``--seed`` (embedding 128, generator (256, 256), batch 500);
4. serve it over HTTP on localhost on the card and answer: N rows
   unconditional (several times), the same rows in 3 offset-contiguous
   chunks (must be byte-identical), one conditional request and
   ``/healthz``; every status 200, every row count right, every number
   finite; the kernel's launch count must rise during this phase;
5. hold the card's output against the CPU's on the same injected draws;
6. time the stages of one request (draws, generator, activation, decode
   and copy to the host, CSV) one by one.

Prints the card's name and power limit beside every number, one JSON
line with the kernel's numbers, and last
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
from fed_tgan_torch.features.transformer import output_info
from fed_tgan_torch.ops import activate_cuda
from fed_tgan_torch.ops.activate_cuda import fused_apply_activate
from fed_tgan_torch.ops.decode import layout_decode
from fed_tgan_torch.ops.segments import SegmentSpec, apply_activate
from fed_tgan_torch.serve.demo import build_random_artifact, intrusion_layout
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import open_model
from fed_tgan_torch.serve.service import SamplingService

REPO = os.path.dirname(os.path.abspath(__file__))
ATOL = 1e-5
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense float32 (non-tensor) rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# per element: the kernel reads x and u and writes out (4 bytes each), and
# does about 10 float operations (2 logs, 1 exp, add, scale, max, subtract,
# sum, divide, select)
BYTES_PER_ELEM = 12
OPS_PER_ELEM = 10


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


def bound_ms(rows: int, dim: int) -> tuple[float, str]:
    t_bytes = BYTES_PER_ELEM * rows * dim / PEAK_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEM * rows * dim / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(spec: SegmentSpec, card: str) -> list[dict]:
    """Phase 2: the kernel against the plain version at each shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, rows in (("rows500", 500), ("rows8000", 8000),
                       ("rows64000", 64000), ("rows5", 5)):
        x = torch.randn((rows, spec.dim), generator=gen, device="cuda") * 2.0
        cases.append((name, x))
    x = torch.zeros((8, spec.dim), device="cuda")
    x[:, 0] = 50.0  # a huge tanh pre-activation
    x[:, 1] = 30.0  # one hot logit in the next softmax segment
    cases.append(("underflow", x))
    results = []
    for name, x in cases:
        rows = x.shape[0]
        u = torch.rand(x.shape, generator=gen, device="cuda")
        got = fused_apply_activate(x, spec, u)
        want = apply_activate(x, spec, u)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        iters = 20 if rows >= 64000 else 200
        ms = cuda_ms(lambda: fused_apply_activate(x, spec, u), iters)
        plain = cuda_ms(lambda: apply_activate(x, spec, u), iters)
        bound, bound_by = bound_ms(rows, spec.dim)
        print(f"K1 {name}: ({rows}, {spec.dim}) max_abs_err {err!r} "
              f"(atol {ATOL}) kernel {ms!r} ms plain {plain!r} ms bound "
              f"{bound!r} ms ({bound_by})  [{card}]", flush=True)
        if not err <= ATOL:
            raise AssertionError(f"K1 {name}: max_abs_err {err} > {ATOL}")
        results.append({"shape": [rows, spec.dim], "case": name,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bound, "bound_by": bound_by})
    return results


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


def serve_phase(art: str, rows: int, seed: int, card: str,
                device: str = "cuda") -> dict:
    """Phase 4: the HTTP service on ``device``."""
    model = open_model(art, device=device)
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
        assert health["device"].startswith(device), health
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


def reference_phase(art: str, seed: int, card: str,
                    device: str = "cuda") -> None:
    """Phase 5: ``device`` vs CPU on the same injected draws (2 steps)."""
    gpu = SamplingEngine(open_model(art, device=device))
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

    _, _, columns = intrusion_layout(np.random.default_rng(args.seed))
    spec = SegmentSpec.from_output_info(output_info(columns))
    shapes = check_kernel(spec, card)

    build_root = os.path.join(REPO, "fed_tgan_torch", "_build")
    os.makedirs(build_root, exist_ok=True)
    art = tempfile.mkdtemp(prefix="chip_smoke_art_", dir=build_root)
    try:
        build_random_artifact(art, seed=args.seed)
        fused_apply_activate.launches = 0
        serving = serve_phase(art, args.rows, args.seed, card)
        launches = fused_apply_activate.launches
        print(f"K1 launches during serving: {launches}  [{card}]", flush=True)
        if launches <= 0:
            raise AssertionError("the served path never launched K1")
        reference_phase(art, args.seed, card)
        serving["stages_ms"] = stage_breakdown(art, args.rows, args.seed, card)
    finally:
        shutil.rmtree(art, ignore_errors=True)

    main_shape = next(s for s in shapes if s["case"] == "rows8000")
    kernel = {
        "name": "fused_gumbel_activation_fwd",
        "route": "cuda",
        "source": "fed_tgan_torch/csrc/activate.cu",
        "replaces": "fed_tgan_tpu/ops/activate_pallas.py:81",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,  # no single PyTorch call is a segmented Gumbel-softmax
        "shapes": shapes,
    }
    print(card)
    print(json.dumps({"kernels": [kernel], "serving": serving}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
