"""Run one cell of the port's benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs an NVIDIA GPU: without one, or with fewer than the cell asks for,
it exits 2 and prints no result.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: every
number compared with its limit), and the numbers compared are also the
last lines of standard error.
"""

import os
import sys
import time

if os.environ.get("PYTHONHASHSEED") != "0":
    # one layout of string hashes in every run: a random one moved the
    # host's dispatch time by ~10% from run to run on the H100's host
    os.environ["PYTHONHASHSEED"] = "0"
    os.environ["FED_TGAN_BENCH_T0"] = repr(time.time())
    os.execv(sys.executable, [sys.executable, *sys.argv])
# set-up counts from the first interpreter's start
T_START = time.perf_counter() - (time.time() - float(
    os.environ.pop("FED_TGAN_BENCH_T0", repr(time.time()))))

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "benchmark_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / "benchmark_cache" / "triton"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process driving the card with few threads: no CPU thread pool
# spinning beside the dispatch thread and the snapshot writer
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness import forbidden_modules, run_cell

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, spec=spec, log=log)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}: the port must run without JAX",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
