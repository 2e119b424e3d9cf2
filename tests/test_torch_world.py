"""The harness that launches the port's multi-process worlds in tests
(rank 0 and one participant per shard CSV, each a process of its own),
and its own checks.  It imports neither jax nor the JAX package, so the
card's tests (``tests/test_torch_gpu.py``) use it too.

Subprocesses get the repository prepended to ``PYTHONPATH`` (the rest of
the caller's path kept), one CPU thread, a process-group timeout of 120 s
(``FED_TGAN_TORCH_TRANSPORT_TRAIN_MS``) and a wall-clock deadline of
their own; ports come from a PID-derived base below Linux's ephemeral
range, two per world (the transport's and the process group's store).
"""

import os
import socket
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "fed_tgan_tpu", "pandas", "pyarrow", "sklearn")
# every world gets a deadline of its own; the group's collectives time out
# well inside it
PROC_TIMEOUT = 240
WORLD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
             "FED_TGAN_TORCH_TRANSPORT_TRAIN_MS": "120000"}
_next = [24000 + (os.getpid() * 17) % 5000]


def next_port() -> int:
    """A port p with p and p + 1 free now: PID-derived, below Linux's
    ephemeral range (32768-60999), so concurrent test workers and the
    kernel's own outgoing ports do not collide with it."""
    while True:
        p = _next[0]
        _next[0] += 2
        try:
            for q in (p, p + 1):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", q))
            return p
        except OSError:
            continue


def world_env(env=None) -> dict:
    return {**os.environ, **WORLD_ENV, **(env or {}),
            "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             "")}


def launch_world(tmp, common, shards, env=None, blocked=False, tag="w",
                 timeout=PROC_TIMEOUT):
    """Rank 0 and one participant per shard CSV, each ``python -m
    fed_tgan_torch <common> -ip 127.0.0.1 -port P ...`` in a process of
    its own (``blocked``: a fresh interpreter where jax, the JAX package,
    pandas, pyarrow and sklearn cannot be imported).  Returns per rank
    ``(returncode, stdout, stderr)``; fails, after killing every process,
    if any outlives ``timeout`` seconds."""
    port = next_port()
    base = list(common) + ["-ip", "127.0.0.1", "-port", str(port)]
    argvs = [base + ["-rank", "0", "-world_size", str(len(shards) + 1)]]
    argvs += [base + ["-rank", str(r), "-datapath", s]
              for r, s in enumerate(shards, start=1)]
    procs = []
    for rank, argv in enumerate(argvs):
        if blocked:
            cmd = [sys.executable, "-c",
                   "import sys\n"
                   f"for name in {BLOCKED!r}:\n"
                   "    sys.modules[name] = None\n"
                   "from fed_tgan_torch.cli import main\n"
                   f"sys.exit(main({argv!r}))\n"]
        else:
            cmd = [sys.executable, "-m", "fed_tgan_torch", *argv]
        out = open(os.path.join(tmp, f"{tag}.r{rank}.out"), "w+")
        err = open(os.path.join(tmp, f"{tag}.r{rank}.err"), "w+")
        procs.append((subprocess.Popen(cmd, cwd=tmp, env=world_env(env),
                                       stdout=out, stderr=err), out, err))
    deadline = time.monotonic() + timeout
    hung = []
    for rank, (p, _, _) in enumerate(procs):
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung.append(rank)
    results = []
    for p, out, err in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        out.seek(0)
        err.seek(0)
        results.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    assert not hung, (hung, results)
    return results


def test_next_port_gives_distinct_free_pairs():
    a, b = next_port(), next_port()
    assert a != b and abs(a - b) >= 2 and max(a, b) + 1 < 32768


def test_a_participant_that_never_arrives_ends_the_world(tmp_path):
    """Rank 1 cannot read its shard and exits before the rendezvous: rank
    0 stops at the transport's accept deadline
    (``FED_TGAN_TORCH_TRANSPORT_CONNECT_MS``) with a non-zero code, inside
    the harness's timeout."""
    t0 = time.monotonic()
    res = launch_world(str(tmp_path), [
        "--dataset", "intrusion", "-epochs", "1", "--device", "cpu",
        "--out-dir", str(tmp_path / "out")], [str(tmp_path / "none.csv")],
        env={"FED_TGAN_TORCH_TRANSPORT_CONNECT_MS": "3000"}, timeout=120)
    assert res[1][0] != 0 and res[0][0] != 0, res
    assert "accept" in res[0][2]
    assert time.monotonic() - t0 < 120
