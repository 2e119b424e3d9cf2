"""The port's host transport and its init protocol across processes
(``fed_tgan_torch.runtime.transport``, ``fed_tgan_torch.federation.
distributed``), over localhost in threads on the CPU.

- The JAX package's transport cases (``tests/test_transport.py:29-66``,
  ``tests/test_faults.py:223-270``): a round trip, a ~2 MB payload, a
  client timeout, a connection severed after a send that reconnects with
  no duplicate, and a delayed send that still delivers.
- The init protocol (``server_initialize`` / ``client_initialize``)
  against JAX's in-process ``federated_initialize`` on the same frames:
  the weights within 1e-6 (``tests/test_torch_federation_init.py``'s
  tolerance), the global meta's columns, encoded width, ``output_info``
  and the pooled condition counts equal; and against the port's own
  in-process init bit for bit.
- A client that dies mid-protocol with ``min_clients`` set is dropped and
  the weights renormalise over the survivors (``tests/test_faults.py:
  318``); a client whose mixtures hold a NaN is dropped the same way.
"""

import os
import threading

import numpy as np
import pytest
import torch

from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.federation import distributed as dist_init
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.runtime.transport import (
    ClientTransport,
    Deadlines,
    ServerTransport,
    TransportError,
)
from fed_tgan_torch.testing.faults import FaultPlan, install_plan
from fed_tgan_torch.train.sampler import CondSampler
from fed_tgan_tpu.data.ingest import TablePreprocessor as JaxPre
from fed_tgan_tpu.data.sharding import shard_dataframe
from fed_tgan_tpu.federation.init import (
    federated_initialize as jax_federated_initialize,
)

torch.set_num_threads(1)
# PID-derived and below Linux's ephemeral range (32768-60999), apart from
# the JAX transport tests' range
PORT = 30000 + (os.getpid() * 11) % 2500


@pytest.fixture(autouse=True)
def _no_fault_plan():
    install_plan(None)
    yield
    install_plan(None)


def _serve(port, n, fn, clients, timeout=60, deadlines=None):
    """Run ``clients[r](transport)`` for r in 1..n in threads against a
    server running ``fn(server)``; returns (server result, client
    results)."""
    out = {}

    def run(rank):
        with ClientTransport("127.0.0.1", port, rank,
                             timeout_ms=20_000) as c:
            try:
                out[rank] = clients[rank](c)
            except TransportError as exc:  # a dropped client's last word
                out[rank] = exc

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(1, n + 1)]
    for t in threads:
        t.start()
    with ServerTransport(port, n, timeout_ms=20_000,
                         deadlines=deadlines) as server:
        res = fn(server)
    for t in threads:
        t.join(timeout=timeout)
    return res, out


def test_transport_roundtrip_objects():
    def client(c):
        c.send_obj({"rank": c.rank, "data": np.arange(c.rank)})
        return c.recv_obj()

    def server(s):
        gathered = s.gather()
        s.broadcast({"ok": True, "n": 3})
        return gathered

    gathered, out = _serve(PORT, 3, server, {r: client for r in (1, 2, 3)})
    assert [g["rank"] for g in gathered] == [1, 2, 3]
    assert gathered[2]["data"].tolist() == [0, 1, 2]
    assert all(out[r] == {"ok": True, "n": 3} for r in (1, 2, 3))


def test_transport_large_payload():
    big = np.random.default_rng(0).normal(size=(500, 500))  # ~2 MB pickled

    def client(c):
        c.send_obj(big)
        return c.recv_obj()

    def server(s):
        s.send_obj(1, s.recv_obj(1))

    _, out = _serve(PORT + 1, 1, server, {1: client})
    assert np.array_equal(out[1], big)


def test_transport_client_timeout():
    with pytest.raises(TransportError):
        ClientTransport("127.0.0.1", PORT + 2, 1, timeout_ms=300)


def test_transport_sever_reconnect_no_duplicates():
    """``sever_conn:rank=1,after=1``: the connection severed after the
    first send reconnects with backoff and a sequence resync, and every
    payload arrives exactly once on both sides."""
    install_plan(FaultPlan.parse("sever_conn:rank=1,after=1"))
    got_client = []

    def client(c):
        for i in range(3):
            c.send_obj({"seq": i})  # send #1 severs its own socket
            got_client.append(c.recv_obj())

    def server(s):
        got = []
        for _ in range(3):
            got.append(s.recv_obj(1))
            s.send_obj(1, {"echo": got[-1]["seq"]})
        return got

    got_server, _ = _serve(PORT + 3, 1, server, {1: client})
    assert got_server == [{"seq": i} for i in range(3)]
    assert got_client == [{"echo": i} for i in range(3)]


def test_transport_delay_fault_still_delivers():
    plan = FaultPlan.parse("delay_msg:ms=30")
    install_plan(plan)
    assert plan.delay_ms == 30

    def client(c):
        c.send_obj("ping")
        return c.recv_obj()

    _, out = _serve(PORT + 4, 1, lambda s: s.send_obj(1, s.recv_obj(1)),
                    {1: client})
    assert out[1] == "ping"


def test_deadlines_read_the_port_prefix(monkeypatch):
    monkeypatch.setenv("FED_TGAN_TORCH_TRANSPORT_HEARTBEAT_TIMEOUT_MS", "1234")
    monkeypatch.setenv("FED_TGAN_TPU_TRANSPORT_TRAIN_MS", "5")
    dl = Deadlines.from_env()
    assert dl.heartbeat_timeout_ms == 1234
    assert dl.train_ms == Deadlines().train_ms


# ------------------------------------------------------- the init protocol

KW = dict(categorical_columns=["color", "flag"],
          non_negative_columns=["amount"], target_column="flag",
          problem_type="binary_classification")


def toy_frames(n_clients):
    import pandas as pd

    rng = np.random.default_rng(7)
    n = 600
    frame = pd.DataFrame({
        "amount": np.exp(rng.normal(2.0, 1.0, n)).round(2),
        "score": np.concatenate([rng.normal(-4.0, 0.5, n // 2),
                                 rng.normal(3.0, 1.0, n - n // 2)]),
        "color": rng.choice(["red", "green", "blue"], n, p=[0.6, 0.3, 0.1]),
        "flag": rng.choice(["yes", "no"], n, p=[0.8, 0.2]),
    })
    return shard_dataframe(frame, n_clients, "iid", seed=4)


def port_pre(frame):
    table = {c: frame[c].to_numpy() for c in frame.columns}
    return TablePreprocessor(table=table, **KW)


def run_protocol(port, pres, min_clients=None, dying=(), poisoned=(),
                 deadlines=None):
    """The protocol with ``pres[r - 1]`` at rank r; a rank in ``dying``
    sends its meta and vanishes, one in ``poisoned`` sends mixtures with a
    NaN mean."""
    def client_fn(rank):
        def run(c):
            if rank in dying:
                c.send_obj(pres[rank - 1].local_meta())
                return None
            if rank in poisoned:
                real = c.send_obj

                def send(obj, *a, **k):
                    if isinstance(obj, dict) and "gmms" in obj:
                        g = next(x for x in obj["gmms"] if x is not None)
                        g.means[0] = np.nan
                    return real(obj, *a, **k)
                c.send_obj = send
            return dist_init.client_initialize(c, pres[rank - 1], seed=0,
                                               device="cpu")
        return run

    return _serve(port, len(pres),
                  lambda s: dist_init.server_initialize(
                      s, seed=0, min_clients=min_clients, device="cpu",
                      run_name="toy"),
                  {r: client_fn(r) for r in range(1, len(pres) + 1)},
                  deadlines=deadlines)


def test_init_protocol_matches_jax_and_the_in_process_init():
    frames = toy_frames(2)
    pres = [port_pre(f) for f in frames]
    server, out = run_protocol(PORT + 5, pres)
    jax_init = jax_federated_initialize(
        [JaxPre(frame=f, **KW) for f in frames], seed=0, backend="jax")
    np.testing.assert_allclose(server["weights"], jax_init.weights,
                               atol=1e-6)
    assert ([c.name for c in server["global_meta"].columns]
            == [c.name for c in jax_init.global_meta.columns])
    spec = SegmentSpec.from_output_info(out[1]["transformer"].output_info)
    assert tuple(out[1]["transformer"].output_info) == tuple(
        tuple(x) for x in jax_init.output_info)
    jax_counts = sum(CondSampler.count_matrix(np.asarray(m), spec)
                     for m in jax_init.client_matrices)
    np.testing.assert_array_equal(server["cond_counts"], jax_counts)
    for rank in (1, 2):
        assert out[rank]["matrix"].shape == np.shape(
            jax_init.client_matrices[rank - 1])
        np.testing.assert_array_equal(out[rank]["weights"],
                                      server["weights"])
        assert out[rank]["run_name"] == "toy"
    # the port's in-process init: the same bits
    ref = federated_initialize(pres, seed=0, device="cpu")
    np.testing.assert_array_equal(server["weights"], ref.weights)
    for rank in (1, 2):
        np.testing.assert_array_equal(out[rank]["matrix"],
                                      ref.client_matrices[rank - 1])


@pytest.mark.parametrize("kind", ["dies", "nonfinite"])
def test_init_protocol_drops_a_client_and_renormalizes(kind):
    """Rank 3 dies after its meta (dropped on its heartbeat lapse) or
    sends a NaN mixture (dropped by the screen); with ``min_clients=2``
    the init completes over ranks 1 and 2, whose weights sum to 1."""
    pres = [port_pre(f) for f in toy_frames(3)]
    dl = Deadlines(init_ms=30_000, heartbeat_timeout_ms=5_000)
    server, out = run_protocol(
        PORT + 6 + (kind == "nonfinite"), pres, min_clients=2,
        dying=(3,) if kind == "dies" else (),
        poisoned=(3,) if kind == "nonfinite" else (), deadlines=dl)
    assert server["live_ranks"] == [1, 2] and 3 in server["dropped"]
    assert len(server["weights"]) == 2
    np.testing.assert_allclose(np.sum(server["weights"]), 1.0, atol=1e-6)
    for rank in (1, 2):
        np.testing.assert_allclose(out[rank]["weights"], server["weights"],
                                   atol=1e-6)
