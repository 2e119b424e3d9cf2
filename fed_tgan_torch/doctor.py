"""Environment triage: ``python -m fed_tgan_torch.doctor [--device cuda|cpu]``
(counterpart of ``fed_tgan_tpu/doctor.py``).

Checks each layer a run of the port depends on, bottom-up, and prints one
``OK``/``FAIL`` line per check, then ``N/M checks passed``: the runtime
(and on a card its name and power limit), the backend probe (the card
answering ``torch.cuda.init()`` in a subprocess, each card's name and
power limit), the device, the hand-written
kernels (K1 and K2 built and held against their plain versions), the
host transport's loopback, the robust aggregators, mixed precision,
rounds in chunks, cohorts, onboarding, elastic membership, the journal,
the live observatory, the cost ledger, serving (decode parity), the
fleet, the front door, the canary, the static analyses (locklint
with a lockwatch-armed burst, obslint, the J01-J06 + L01-L04 lint gate),
the program contracts (a subprocess on the device), the unified
``analysis --all`` gate, the backend seam (``tpu`` and ``plugin:<name>``
refused by name, the CPU backend spawning no probe, the probe's
process-group answer equal to the world's, one contracted family through
the probed backend equal to its contracts) and the pod launcher's
torch-free ``--dry-run`` plan: 25 checks.  The three analysis
subprocesses (the contracts, ``--all``, the seam's family) start before
the in-process checks and run beside them.  Every check runs
small models on the device asked for: ``cuda`` by default (the backend
and device checks fail where there is no card: the doctor never falls
back to the CPU unasked), ``--device cpu`` on the CPU, where the backend
and kernel checks say why they do not apply.

``--wait-healthy`` runs no check: it blocks until the card answers a
fresh probe (:func:`wait_healthy`), deferring while the host is loaded
and holding a quiet window after a failed probe; ``--wait-timeout-min``,
``--quiet-window-min`` and ``--probe-timeout`` tune it.

The JAX package's checks of XLA (the virtual mesh, the compile cache)
have no counterpart here: the port runs on one card and compiles no XLA
program.

Exit code 0 when every check passes, 1 otherwise.  Read-only except for
loopback sockets and temporary directories.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

def _line(ok: bool, name: str, detail: str) -> bool:
    print(f"{'OK  ' if ok else 'FAIL'} {name}: {detail}", flush=True)
    return ok


def _check(name: str):
    """Run the decorated check; an exception is its FAIL line."""
    def wrap(fn):
        def run(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 -- the check's verdict
                return _line(False, name, f"{exc!r}")
        run.__name__ = fn.__name__
        return run
    return wrap


def _silent(*args, **kwargs) -> None:
    pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, timeout: float = 120.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _small_cfg(**kw):
    from fed_tgan_torch.train.steps import TrainConfig

    return TrainConfig(embedding_dim=8, gen_dims=(16, 16), dis_dims=(16, 16),
                       batch_size=40, pac=4, **kw)


def _clients(n: int, rows: int = 120, seed: int = 7) -> list:
    """``n`` IID shards of the demo table as preprocessors."""
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.serve.demo import demo_frame

    frame = demo_frame(n * rows, seed)
    return [TablePreprocessor(table={c: v[i::n] for c, v in frame.items()},
                              name="doctor",
                              categorical_columns=["color", "flag"],
                              non_negative_columns=["amount"])
            for i in range(n)]


def _trainer(device, n: int = 2, **cfg_kw):
    from fed_tgan_torch.federation.init import federated_initialize
    from fed_tgan_torch.train.federated import FederatedTrainer

    init = federated_initialize(_clients(n), seed=0, device=device)
    return FederatedTrainer(init, _small_cfg(**cfg_kw), seed=0,
                            device=device)


def _state(tr) -> list:
    st = tr.stack
    return [st.generator.params, st.generator.bn_state,
            st.discriminator.params]


def _equal(a: list, b: list) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


class _Artifacts:
    """Demo artifacts built once per diagnosis and shared by the serving
    checks (each check that changes one copies it first)."""

    def __init__(self, device):
        self.device = device
        self.root = tempfile.mkdtemp(prefix="fed_tgan_doctor_")
        self._built = None

    def demo(self) -> str:
        from fed_tgan_torch.serve.demo import build_demo_artifact

        if self._built is None:
            self._built = build_demo_artifact(
                os.path.join(self.root, "demo"), rows=200, epochs=1,
                device=self.device)
        return self._built

    def copy(self, name: str) -> str:
        dst = os.path.join(self.root, name)
        shutil.copytree(self.demo(), dst)
        return dst

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


# ------------------------------------------------------------ the checks


def check_runtime(device: str) -> bool:
    import torch

    detail = (f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        try:
            proc = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30)
            card = proc.stdout.strip().splitlines()[0]
        except (OSError, IndexError, subprocess.TimeoutExpired):
            card = f"{torch.cuda.get_device_name(0)} (nvidia-smi unreadable)"
        detail += f"; card {card}"
    return _line(True, "runtime", detail)


@_check("backend")
def check_backend(device: str, timeout_s: int = 120) -> bool:
    """The card answers ``torch.cuda.init()`` in a fresh interpreter
    within ``timeout_s`` (the CLI's probe, its stamp honoured); on the CPU
    the probe does not apply."""
    from fed_tgan_torch.runtime.backend import get_backend

    if device != "cuda":
        return _line(True, "backend", "does not apply: --device cpu runs no "
                     "probe (the CLI's policy)")
    t0 = time.perf_counter()
    health = get_backend("gpu").probe(timeout_s=timeout_s)
    if not health:
        return _line(False, "backend", f"{health.reason} (--device cpu to "
                     "diagnose the CPU path)")
    cards = "; ".join(f"cuda:{c['index']} {c['name']} (sm {c['capability']}"
                      f", {c.get('power_limit') or 'power limit unread'})"
                      for c in health.info.get("cards", []))
    how = ("cached probe stamp" if health.cached
           else f"{time.perf_counter() - t0:.1f}s probe")
    return _line(True, "backend", f"responsive ({how}): {cards}")


@_check("device")
def check_device(device: str) -> bool:
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        return _line(False, "device", "CUDA is not available (pass --device "
                     "cpu to diagnose the CPU path)")
    x = torch.randn((256, 256), generator=torch.Generator().manual_seed(0))
    want = x @ x
    got = (x.to(device) @ x.to(device)).cpu()
    if not torch.allclose(got, want, atol=1e-3):
        return _line(False, "device", "a 256x256 matrix product disagrees "
                     "with the CPU's")
    if device == "cuda":
        props = torch.cuda.get_device_properties(0)
        where = (f"{props.name}, {props.multi_processor_count} SMs, "
                 f"{props.total_memory / 2**30:.1f} GiB")
    else:
        where = "the CPU (asked for with --device cpu)"
    return _line(True, "device", f"{where}; a matrix product agrees with "
                 "the CPU's")


def _layout(width: int):
    """The Intrusion layout (282 dims) or, for 285, the fitted training
    layout's width: the same plus one 3-way softmax segment."""
    from fed_tgan_torch.features.transformer import output_info
    from fed_tgan_torch.ops.segments import SegmentSpec
    from fed_tgan_torch.serve.demo import intrusion_layout

    _, _, columns = intrusion_layout(np.random.default_rng(0))
    info = list(output_info(columns))
    if width == 285:
        info.append((3, "softmax"))
    spec = SegmentSpec.from_output_info(info)
    assert spec.dim == width, spec.dim
    return spec


@_check("kernels")
def check_kernels(device: str) -> bool:
    if device != "cuda":
        return _line(True, "kernels", "does not apply on the CPU: K1 and K2 "
                     "(csrc/activate.cu) run on a CUDA card; CPU tensors "
                     "take their plain versions")
    import torch

    from fed_tgan_torch.analysis.sanitizers import sanctioned_sync
    from fed_tgan_torch.ops import activate_cuda
    from fed_tgan_torch.ops.segments import (
        apply_activate_bwd,
        apply_activate_residual,
    )

    activate_cuda.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = []
    for rows, width in ((500, 285), (8000, 282)):
        spec = _layout(width)
        x = torch.randn((rows, width), generator=gen, device="cuda")
        u = torch.rand((rows, width), generator=gen, device="cuda")
        dy = torch.randn((rows, width), generator=gen, device="cuda")
        out = activate_cuda.fused_apply_activate(x, spec, u)
        # each launch against its plain version on the host: the check's
        # copies are there by design
        with sanctioned_sync():
            want = apply_activate_residual(x.cpu(), spec, u.cpu())[0]
            dx = activate_cuda.fused_activate_bwd(dy, out, spec)
            want_dx = apply_activate_bwd(dy.cpu(), out.cpu(), spec)
            e1 = float((out.cpu() - want).abs().max())
            e2 = float((dx.cpu() - want_dx).abs().max())
        errs.append(f"({rows}, {width}) K1 {e1:.2e} K2 {e2:.2e}")
        if not (e1 <= 1e-5 and e2 <= 1e-5):
            return _line(False, "kernels", f"beyond atol 1e-5 of the plain "
                         f"versions: {errs[-1]}")
    return _line(True, "kernels", "K1 and K2 built and within atol 1e-5 of "
                 "their plain versions: " + "; ".join(errs))


@_check("transport")
def check_transport(device: str) -> bool:
    from fed_tgan_torch.runtime.transport import (
        ClientTransport,
        ServerTransport,
    )

    port = _free_port()
    result: dict = {}

    def client() -> None:
        try:
            with ClientTransport("127.0.0.1", port, 1,
                                 timeout_ms=10_000) as c:
                c.send_obj({"ping": 1})
                result["echo"] = c.recv_obj()
                # sever our own socket, then send again: the transport
                # must reconnect with backoff and resync its sequence
                c._lib.ft_peer_close(c._handle, 0)
                c.send_obj({"ping": 2})
                result["echo2"] = c.recv_obj()
        except Exception as exc:  # noqa: BLE001 -- reported below
            result["err"] = repr(exc)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    with ServerTransport(port, 1, timeout_ms=10_000) as server:
        for _ in range(2):
            server.send_obj(1, server.recv_obj(1))
    t.join(timeout=10)
    if result.get("echo") != {"ping": 1} or result.get("echo2") != {
            "ping": 2}:
        return _line(False, "transport",
                     result.get("err", "echo mismatch or client timeout"))
    return _line(True, "transport", "C++ loopback roundtrip + "
                 f"sever/reconnect ok (port {port})")


@_check("robust-agg")
def check_robust_aggregation(device: str) -> bool:
    import torch

    from fed_tgan_torch.analysis.sanitizers import sanctioned_sync
    from fed_tgan_torch.parallel.fedavg import AGGREGATORS, robust_aggregate

    rng = np.random.default_rng(0)
    prev = [torch.zeros((3, 2)), torch.zeros(3)]
    clean = [[p + 0.1 + 0.01 * torch.from_numpy(
        rng.standard_normal(p.shape).astype(np.float32)) for p in prev]
        for _ in range(4)]
    poisons = {"nan": [torch.full_like(p, float("nan")) for p in prev],
               "scale": [p + 1000.0 * (x - p)
                         for p, x in zip(prev, clean[3])]}
    mean = [torch.stack([c[i] for c in clean[:3]]).mean(0)
            for i in range(len(prev))]
    weights, steps = torch.full((4,), 0.25), torch.ones(4)
    for pname, poison in poisons.items():
        new = [torch.stack([c[i] for c in clean[:3]] + [poison[i]]).to(device)
               for i in range(len(prev))]
        for agg in AGGREGATORS:
            out, quar = robust_aggregate(
                [p.to(device) for p in prev], new, weights.to(device),
                steps.to(device), aggregator=agg)
            with sanctioned_sync():  # the check reads on the host
                quar = quar.cpu().numpy()
                outs = [o.cpu() for o in out]
            if not quar[3] or quar[:3].any():
                return _line(False, "robust-agg", f"{agg}/{pname}: gate "
                             f"flagged {quar} (expected only client 3)")
            for o, m in zip(outs, mean):
                if not torch.isfinite(o).all() or float(
                        (o - m).abs().max()) > 0.05:
                    return _line(False, "robust-agg", f"{agg}/{pname}: "
                                 "left the clean mean")
    return _line(True, "robust-agg", f"{'/'.join(AGGREGATORS)} all "
                 "quarantined the poisoned client (nan + 1000x-scale) and "
                 "stayed on the clean mean")


@_check("precision")
def check_precision(device: str) -> bool:
    import torch

    from fed_tgan_torch.ops import activate_cuda

    before = dict(activate_cuda.fused_activate_bwd.variant_launches)
    tr = _trainer(device, precision="bf16")
    tr.fit(2)
    bf16_k2 = (activate_cuda.fused_activate_bwd.variant_launches["bf16"]
               - before["bf16"])
    if device == "cuda" and bf16_k2 <= 0:
        return _line(False, "precision", "the bf16 rounds launched no bf16 "
                     "K2")
    if not np.isfinite(tr.last_metrics).all():
        return _line(False, "precision", f"non-finite bf16 losses "
                     f"{tr.last_metrics.tolist()}")
    if torch.isnan(tr.stack.generator.params.float()).any():
        return _line(False, "precision", "non-finite bf16 weights")
    kernels = (f", {bf16_k2} bf16 K2 launches" if device == "cuda"
               else "")
    return _line(True, "precision", "2 rounds at --precision bf16: finite "
                 f"losses and weights{kernels}")


@_check("rounds-per-program")
def check_rounds_per_program(device: str) -> bool:
    fused, plain = _trainer(device), _trainer(device)
    fused.fit(4, max_rounds_per_call=4)
    plain.fit(4)
    if not _equal(_state(fused), _state(plain)):
        return _line(False, "rounds-per-program",
                     "4 rounds in one chunk differ from 4 chunks of one")
    return _line(True, "rounds-per-program", "4 rounds in one chunk "
                 f"bit-equal to 4 single rounds ({fused.host_copies} host "
                 f"copy against {plain.host_copies})")


@_check("cohort")
def check_cohort_scale(device: str) -> bool:
    tr = _trainer(device, n=4, cohort=2)
    tr.fit(2)
    if tr.last_cohort is None or len(tr.last_cohort) != 2:
        return _line(False, "cohort", f"cohort {tr.last_cohort}")
    if not np.isfinite(tr.last_metrics).all():
        return _line(False, "cohort", "non-finite cohort losses")
    return _line(True, "cohort", "2 rounds of cohort 2 of 4: finite, "
                 f"last cohort {tr.last_cohort.tolist()}")


@_check("onboarding")
def check_onboarding(device: str) -> bool:
    from fed_tgan_torch.federation.init import federated_initialize

    root = tempfile.mkdtemp(prefix="fed_tgan_doctor_init_")
    try:
        cold = federated_initialize(_clients(4), seed=0, device=device,
                                    similarity="sketch", cache=root)
        warm = federated_initialize(_clients(4), seed=0, device=device,
                                    similarity="sketch", cache=root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not np.array_equal(cold.weights, warm.weights):
        return _line(False, "onboarding", "the warm init's weights differ "
                     "from the cold init's")
    same = all(np.array_equal(a, b) for a, b in
               zip(cold.client_matrices, warm.client_matrices))
    if not same:
        return _line(False, "onboarding", "the warm init's matrices differ")
    return _line(True, "onboarding", "4 clients: cold sketch init into an "
                 "init cache, warm restore bit-identical (weights "
                 f"{np.round(cold.weights, 4).tolist()})")


@_check("elastic")
def check_elastic_federation(device: str) -> bool:
    from fed_tgan_torch.federation.elastic import ElasticFederation
    from fed_tgan_torch.federation.init import federated_initialize
    from fed_tgan_torch.federation.streaming import OnboardingSession
    from fed_tgan_torch.testing.faults import FaultPlan
    from fed_tgan_torch.train.federated import FederatedTrainer

    residents, pool = _clients(4)[:2], _clients(4, seed=8)
    init = federated_initialize(residents, seed=0, similarity="sketch",
                                device=device)
    tr = FederatedTrainer(init, _small_cfg(), seed=0, capacity=4,
                          min_clients=1, device=device)
    el = ElasticFederation(tr, OnboardingSession(init, device=device),
                           list(residents))
    plan = FaultPlan.parse("join:round=2,count=1;leave:client=1,round=3")
    tr = el.run(4, plan=plan,
                newcomer_factory=lambda count, rnd: pool[:count])
    if tr.n_clients != 3 or tr.dropped_clients != {1}:
        return _line(False, "elastic", f"population {tr.n_clients}, "
                     f"dropped {tr.dropped_clients}")
    if not np.isfinite(tr.last_metrics).all():
        return _line(False, "elastic", "non-finite losses after churn")
    return _line(True, "elastic", "4 elastic rounds: a join at round 2 (2 "
                 "-> 3 clients), client 1 left at round 3, losses finite")


@_check("observability")
def check_observability(device: str) -> bool:
    from fed_tgan_torch.obs.journal import RunJournal, read_journal
    from fed_tgan_torch.obs.report import report_main

    root = tempfile.mkdtemp(prefix="fed_tgan_doctor_obs_")
    try:
        jpath = os.path.join(root, "journal.jsonl")
        with RunJournal(jpath, run_id="doctor", validate=True) as j:
            j.emit("round", first=0, last=0, rounds=1, per_round_s=0.01)
        if j.schema_violations:
            return _line(False, "observability", f"{j.schema_violations} "
                         "journal schema violation(s) -- run python -m "
                         "fed_tgan_torch.analysis --telemetry")
        types = [e.get("type") for e in read_journal(jpath)]
        if types != ["run_start", "round", "run_end"]:
            return _line(False, "observability",
                         f"journal round-trip produced {types}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = report_main([jpath], fmt="json")
        summary = json.loads(buf.getvalue())
        if rc != 0 or summary.get("events") != 3 or summary.get(
                "run_id") != "doctor":
            return _line(False, "observability",
                         f"obs report said rc {rc}: {summary}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return _line(True, "observability", "journal round-trips under "
                 "validation; obs report summarized 3 events")


@_check("observatory")
def check_observatory(device: str) -> bool:
    from fed_tgan_torch.obs.exporter import TelemetryExporter
    from fed_tgan_torch.obs.journal import RunJournal, set_journal

    tr = _trainer(device)
    root = tempfile.mkdtemp(prefix="fed_tgan_doctor_obs_")
    journal = RunJournal(os.path.join(root, "journal.jsonl"),
                         run_id="doctor", validate=True)
    prev = set_journal(journal)
    try:
        with TelemetryExporter(port=0) as exp:
            tr.fit(2)
            metrics = _get(exp.url + "/metrics").decode()
            tail = _get(exp.url + "/journal").decode()
            health = json.loads(_get(exp.url + "/healthz"))
    finally:
        set_journal(prev)
        journal.close()
        shutil.rmtree(root, ignore_errors=True)
    contrib = sum('"client_contribution"' in ln for ln in tail.splitlines())
    if "fed_tgan_client_weight{" not in metrics:
        return _line(False, "observatory", "/metrics lacks the per-client "
                     "ledger series")
    if health.get("status") != "training" or health.get("round") != 1:
        return _line(False, "observatory", f"/healthz {health}")
    if contrib != 2 or journal.schema_violations:
        return _line(False, "observatory", f"{contrib} client_contribution "
                     f"events for 2 rounds, {journal.schema_violations} "
                     "schema violations")
    return _line(True, "observatory", "live exporter scraped after 2 "
                 "rounds: per-client ledger on /metrics, round progress on "
                 "/healthz, 2 client_contribution events on /journal")


@_check("cost-ledger")
def check_cost_ledger(device: str) -> bool:
    from fed_tgan_torch.obs.ledger import CostLedger, port_cost_ledger

    entries = port_cost_ledger(device=device, ledger=CostLedger(),
                               journal=False)
    hollow = [n for n, e in entries.items()
              if not (e.flops > 0 and e.bytes_accessed > 0
                      and (e.peak_bytes > 0 or device != "cuda"))]
    if not entries or hollow:
        return _line(False, "cost-ledger", f"hollow entries {hollow}")
    peak = "peak bytes" if device == "cuda" else "(no peak on the CPU)"
    return _line(True, "cost-ledger", f"{len(entries)} programs of "
                 f"{len({e.family for e in entries.values()})} families "
                 f"with nonzero flops, bytes {peak}")


@_check("serving")
def check_serving(device: str, arts: _Artifacts) -> bool:
    from fed_tgan_torch.__main__ import sample_main
    from fed_tgan_torch.serve.registry import ModelRegistry
    from fed_tgan_torch.serve.service import SamplingService

    root = arts.demo()
    svc = SamplingService(ModelRegistry(root, device=device, log=_silent),
                          port=0, log=_silent).start()
    try:
        health = json.loads(_get(f"{svc.url}/healthz", 30))
        if health.get("status") != "ok":
            return _line(False, "serving", f"healthz said {health}")
        served = _get(f"{svc.url}/sample?rows=40&seed=7")
    finally:
        svc.shutdown(drain=False)
    out = os.path.join(arts.root, "oneshot.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = sample_main(["--sample-from", root, "--sample-rows", "40",
                          "--seed", "7", "--out", out, "--device", device])
    with open(out, "rb") as f:
        oneshot = f.read()
    if rc != 0 or served != oneshot:
        return _line(False, "serving", f"served {len(served)} bytes differ "
                     f"from the one-shot --sample-from CSV (rc {rc})")
    return _line(True, "serving", f"model {health['model_id']} served 40 "
                 "rows; response byte-identical to the one-shot "
                 "--sample-from path")


@_check("fleet")
def check_serving_fleet(device: str, arts: _Artifacts) -> bool:
    from fed_tgan_torch.serve.engine import SamplingEngine
    from fed_tgan_torch.serve.fleet import (
        FleetRegistry,
        FleetService,
        ProgramCache,
        _FleetRequest,
        _Member,
    )
    from fed_tgan_torch.serve.registry import ModelRegistry

    roots = {"alpha": arts.demo(), "beta": arts.copy("beta")}
    cache = ProgramCache(max_entries=16)
    fleet = FleetRegistry(program_cache=cache, device=device, log=_silent)
    for name, root in roots.items():
        fleet.load(name, root)
    svc = FleetService(fleet, port=0, reload_interval_s=0, max_lanes=2,
                       log=_silent).start()
    results: dict = {}
    try:
        def fetch(tenant):
            results[tenant] = _get(f"{svc.url}/t/{tenant}/sample?rows=25"
                                   "&seed=3")

        threads = [threading.Thread(target=fetch, args=(t,)) for t in roots]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        status = json.loads(_get(f"{svc.url}/fleet", 30))
    finally:
        svc.shutdown(drain=True)
    want = SamplingEngine(ModelRegistry(roots["alpha"], device=device,
                                        log=_silent).get()
                          ).sample_csv_bytes(25, seed=3)
    bad = [t for t in roots if results.get(t) != want]
    if bad:
        return _line(False, "fleet", f"tenants {bad} differ from the "
                     "single-model engine")
    # one lane dispatch over both tenants: each lane its engine's rows
    members = []
    for name in roots:
        rt = fleet.get(name)
        members.append(_Member(_FleetRequest(name, 25, 3, 0, None, True),
                               rt, rt.engine.snapshot(), 0, 0))
    lanes = FleetService(fleet, max_lanes=2, log=_silent).lane_pass(
        members, 1)
    rows = fleet.get("alpha").engine.sample_decoded(25, seed=3)
    if not all(np.array_equal(lanes[i, :25], rows) for i in range(2)):
        return _line(False, "fleet", "a lane's rows differ from its "
                     "engine's")
    return _line(True, "fleet", f"{len(status['tenants'])} tenants served "
                 "over HTTP and in one 2-lane dispatch; each tenant's bytes "
                 "and rows identical to the single-model engine's (lane "
                 f"cache {cache.stats()['entries']} entr(ies))")


@_check("front-door")
def check_front_door(device: str, arts: _Artifacts) -> bool:
    from fed_tgan_torch.serve.fleet import (
        FleetRegistry,
        FleetService,
        ProgramCache,
        _FleetRequest,
    )

    root = arts.demo()

    def run(workers: int):
        fleet = FleetRegistry(program_cache=ProgramCache(max_entries=16),
                              device=device, log=_silent)
        rt = fleet.load("alpha", root)
        svc = FleetService(fleet, port=0, max_batch=8, queue_size=64,
                           max_lanes=4, reload_interval_s=0,
                           workers=workers, log=_silent)
        reqs = [_FleetRequest(tenant="alpha", n=5, seed=2, offset=5 * i,
                              condition=None, header=True)
                for i in range(32)]
        for r in reqs:
            err = svc.submit(rt, r)
            if err is not None:
                raise RuntimeError(f"submit shed a request: {err}")
        svc.start_workers()
        for r in reqs:
            if not r.done.wait(timeout=300) or r.status != 200:
                raise RuntimeError(f"request failed: {r.status} {r.error}")
        svc.shutdown(drain=True)
        return [r.result for r in reqs], svc.metrics.snapshot()

    multi, snap = run(4)
    single, _ = run(1)
    if multi != single:
        return _line(False, "front-door", "4-worker bytes differ from the "
                     "single-worker path")
    if snap["batch_occupancy"] < 4.0:
        return _line(False, "front-door", "coalescer starved under "
                     f"backlog: occupancy {snap['batch_occupancy']} < 4")
    return _line(True, "front-door", "4-worker bytes == single-worker bytes "
                 f"for 32 requests; batch_occupancy "
                 f"{snap['batch_occupancy']} >= 4")


@_check("canary")
def check_quality_canary(device: str, arts: _Artifacts) -> bool:
    from fed_tgan_torch.serve.canary import CanaryConfig, CanaryGate
    from fed_tgan_torch.serve.demo import republish_demo_candidate
    from fed_tgan_torch.serve.engine import SamplingEngine
    from fed_tgan_torch.serve.registry import ModelRegistry
    from fed_tgan_torch.testing.faults import degrade_checkpoint

    root = arts.copy("canary")
    registry = ModelRegistry(root, device=device, log=_silent)
    engine = SamplingEngine(registry.get())
    gate = CanaryGate(registry, engine, config=CanaryConfig(shadow_rows=128),
                      log=_silent)
    first = registry.get().model_id
    republish_demo_candidate(root, device=device)
    clean = gate.consider()
    if clean is None or not clean["promoted"] \
            or registry.get().model_id == first:
        return _line(False, "canary", f"clean republish not promoted "
                     f"({clean})")
    engine.adopt(registry.get())
    promoted = registry.get().model_id
    degrade_checkpoint(os.path.join(root, "models", "synthesizer_torch"),
                       100.0)
    decision = gate.consider()
    if decision is None or decision["promoted"]:
        return _line(False, "canary", f"degraded generation not rejected "
                     f"({decision})")
    if registry.get().model_id != promoted or not decision["tripped"]:
        return _line(False, "canary", "the rejection replaced the serving "
                     "model or carried no forensics")
    return _line(True, "canary", f"clean generation promoted; degraded one "
                 f"rejected (tripped {decision['tripped']}), the promoted "
                 "model kept serving")


@_check("locklint")
def check_locklint(device: str, arts: _Artifacts) -> bool:
    from fed_tgan_torch.analysis import lockwatch
    from fed_tgan_torch.analysis.lint import (
        LOCK_RULES,
        apply_baseline,
        load_baseline,
        run_lint,
    )
    from fed_tgan_torch.serve.fleet import (
        FleetRegistry,
        FleetService,
        ProgramCache,
    )

    new, _, _ = apply_baseline(run_lint(rules=LOCK_RULES), load_baseline())
    if new:
        return _line(False, "locklint", f"static findings: "
                     f"{new[0].render(with_hint=False)} -- run python -m "
                     "fed_tgan_torch.analysis")
    roots = {"alpha": arts.demo(), "beta": arts.copy("beta_lw")}
    with lockwatch.watch(on_deadlock="record"):
        fleet = FleetRegistry(program_cache=ProgramCache(max_entries=8),
                              device=device, log=_silent)
        for name, root in roots.items():
            fleet.load(name, root)
        svc = FleetService(fleet, port=0, reload_interval_s=0,
                           log=_silent).start()
        try:
            def burst(tenant):
                for _ in range(3):
                    _get(f"{svc.url}/t/{tenant}/sample?rows=10&seed=1")

            threads = [threading.Thread(target=burst, args=(t,))
                       for t in roots for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            svc.shutdown(drain=True)
        bad = lockwatch.reports("cycle") + lockwatch.reports("reentry")
        summary = lockwatch.summary()
    if bad:
        return _line(False, "locklint", f"{len(bad)} runtime report(s): "
                     f"{bad[0].detail}")
    acq = sum(s["acquisitions"] for s in summary.values())
    return _line(True, "locklint", "L01-L04 clean package-wide; "
                 f"lockwatch-armed 2-tenant burst: {len(summary)} lock(s) "
                 f"watched, {acq} acquisition(s), no order cycle, no "
                 "re-entry")


@_check("obslint")
def check_obslint(device: str) -> bool:
    from fed_tgan_torch.analysis.lint import apply_baseline, load_baseline
    from fed_tgan_torch.analysis.telemetry import run_telemetry

    findings, cov = run_telemetry()
    new, _, _ = apply_baseline(findings, load_baseline())
    if new:
        return _line(False, "obslint", f"{new[0].render(with_hint=False)} "
                     "-- run python -m fed_tgan_torch.analysis --telemetry")
    if (cov["emit_sites_covered"] != cov["emit_sites"]
            or cov["metric_sites_covered"] != cov["metric_sites"]):
        return _line(False, "obslint", f"schema coverage {cov}")
    return _line(True, "obslint", f"O01-O05 clean; schema covers "
                 f"{cov['emit_sites']}/{cov['emit_sites']} emit site(s), "
                 f"{cov['metric_sites']}/{cov['metric_sites']} metric "
                 "site(s)")


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(argv: list):
    """A subprocess of this interpreter from the repo, its output piped;
    one CPU thread unless the caller set ``OMP_NUM_THREADS`` (it runs
    beside the other checks, and its small ops gain nothing from more)."""
    env = {"OMP_NUM_THREADS": "1", **os.environ}
    return subprocess.Popen([sys.executable, *argv], cwd=_REPO, text=True,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def _spawn_analysis(args: list, device: str, contracts_dir=None,
                    families=()):
    """``python -m fed_tgan_torch.analysis ARGS`` against ``device``'s
    backend (``--backend gpu`` on the card)."""
    args = list(args) + [a for f in families for a in ("--family", f)]
    if contracts_dir is not None:
        args += ["--contracts-dir", str(contracts_dir)]
    return _spawn(["-m", "fed_tgan_torch.analysis", *args, "--backend",
                   "gpu" if device == "cuda" else "cpu"])


def _finish(proc, timeout: int):
    """``(exit code, stdout, stderr)`` of ``proc``, or None once it has
    run past ``timeout`` (then it is killed)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return None
    return proc.returncode, out or "", err or ""


def _analysis(proc, timeout: int):
    """An analysis subprocess's ``(exit code, output lines)``, or None on
    a timeout."""
    res = _finish(proc, timeout)
    if res is None:
        return None
    rc, out, err = res
    return rc, [ln for ln in (out or err).splitlines() if ln.strip()]


@_check("static-analysis")
def check_static_analysis(device: str, paths=None, baseline=None) -> bool:
    """The lint gate (``fed_tgan_tpu/doctor.py:170``): the rules J01-J06 +
    L01-L04 over the package (or ``paths``), against the checked-in
    baseline (or ``baseline``).  Pure AST: no torch."""
    from fed_tgan_torch.analysis.lint import (
        apply_baseline,
        load_baseline,
        run_lint,
    )

    findings = run_lint(paths)
    new, _old, stale = apply_baseline(findings, load_baseline(baseline))
    if new:
        heads = ", ".join(f.key for f in new[:3])
        more = f" (+{len(new) - 3} more)" if len(new) > 3 else ""
        return _line(False, "static-analysis",
                     f"{len(new)} non-baselined finding(s): {heads}{more} "
                     "-- run python -m fed_tgan_torch.analysis")
    return _line(True, "static-analysis",
                 f"torchlint clean: {len(findings)} finding(s) all "
                 f"baselined ({len(stale)} stale baseline entr"
                 f"{'y' if len(stale) == 1 else 'ies'}, rules J01-J06 + "
                 "L01-L04)")


@_check("program-contracts")
def check_program_contracts(device: str, contracts_dir=None, families=(),
                            timeout: int = 600, proc=None) -> bool:
    """The contract gate (``fed_tgan_tpu/doctor.py:315``): a subprocess
    dispatches every contracted entry point on ``device`` and diffs the
    fingerprints against that backend's contracts (``analysis/contracts/``
    on the CPU, ``analysis/contracts/gpu/`` on the card).  ``proc``: that
    subprocess, already started (:func:`main` starts it early)."""
    res = _analysis(proc or _spawn_analysis(
        ["--contracts"], device, contracts_dir, families), timeout)
    if res is None:
        return _line(False, "program-contracts",
                     f"timed out after {timeout}s")
    rc, lines = res
    summary = lines[-1] if lines else "no output"
    if rc == 2:
        return _line(False, "program-contracts", "exit 2 (the harness "
                     "cannot run or a contract is unreadable): " + summary)
    if rc != 0:
        return _line(False, "program-contracts",
                     f"{' | '.join(lines[:2])} -- run python -m "
                     "fed_tgan_torch.analysis --contracts --explain")
    return _line(True, "program-contracts", summary)


@_check("analysis-all")
def check_analysis_all(device: str, contracts_dir=None, families=(),
                       timeout: int = 900, proc=None) -> bool:
    """The unified gate (``fed_tgan_tpu/doctor.py:197``): ``python -m
    fed_tgan_torch.analysis --all`` (torchlint+locklint, obslint, program
    contracts on ``device``) must exit 0.  ``proc``: that subprocess,
    already started."""
    res = _analysis(proc or _spawn_analysis(
        ["--all"], device, contracts_dir, families), timeout)
    if res is None:
        return _line(False, "analysis-all", f"timed out after {timeout}s")
    rc, lines = res
    table = lines[lines.index("analysis --all summary:") + 1:] \
        if "analysis --all summary:" in lines else lines[-3:]
    rows = [" ".join(ln.split()) for ln in table]
    if rc != 0:
        bad = [r for r in rows if not r.endswith(" ok")]
        return _line(False, "analysis-all",
                     f"exit {rc}: {'; '.join(bad) or ' | '.join(lines[-2:])}"
                     " -- run python -m fed_tgan_torch.analysis --all")
    return _line(True, "analysis-all", f"{len(rows)} prong(s) ok: "
                 + ", ".join(r.rsplit(None, 1)[0] for r in rows))


def _spawn_seam(device: str, contracts_dir=None):
    """The contract half of the seam in a subprocess: ``parallel_fedavg``
    recorded through the probed backend and held, program by program,
    against that backend's contract directory (exact fingerprints)."""
    backend = "gpu" if device == "cuda" else "cpu"
    code = (
        "import json, sys\n"
        "from fed_tgan_torch.analysis.contracts.check import load_contracts\n"
        "from fed_tgan_torch.analysis.contracts.harness import (\n"
        "    ENTRYPOINT_FAMILIES, record_fingerprints)\n"
        "from fed_tgan_torch.runtime.backend import contracts_dir_for\n"
        f"backend = {backend!r}\n"
        f"path = {None if contracts_dir is None else str(contracts_dir)!r}\n"
        "fam = 'parallel_fedavg'\n"
        "cur = record_fingerprints({fam: ENTRYPOINT_FAMILIES[fam]},\n"
        "    device='cuda' if backend == 'gpu' else 'cpu')\n"
        "stored = load_contracts([fam], path or contracts_dir_for(backend))\n"
        "progs = (stored[fam] or {}).get('programs', {})\n"
        "bad = [n for n, fp in cur[fam].items() if fp.to_dict() != {\n"
        "    k: v for k, v in progs.get(n, {}).items() if k != 'require'}]\n"
        "print(json.dumps({'programs': len(cur[fam]), 'bad': bad}))\n")
    return _spawn(["-c", code])


def _seam_contracts(device: str, contracts_dir, timeout: int,
                    proc=None) -> str:
    """What the contract half of the seam (:func:`_spawn_seam`) found to
    differ, "" when nothing does."""
    backend = "gpu" if device == "cuda" else "cpu"
    res = _finish(proc or _spawn_seam(device, contracts_dir), timeout)
    if res is None:
        return f"the contract half timed out after {timeout}s"
    rc, out, err = res
    if rc != 0:
        tail = err.strip().splitlines()[-2:]
        return " | ".join(tail) or "the contract half failed"
    res = json.loads(out.strip().splitlines()[-1])
    if res["bad"]:
        return (f"{len(res['bad'])}/{res['programs']} parallel_fedavg "
                f"program(s) differ from the {backend} contracts: "
                f"{', '.join(res['bad'][:3])}")
    return ""


@_check("backend-seam")
def check_backend_seam(device: str, contracts_dir=None,
                       timeout: int = 300, proc=None) -> bool:
    """The ``runtime/backend.py`` seam: the JAX package's ``tpu`` and
    ``plugin:<name>`` specs are refused with a named error that says
    which flag to use; the CPU backend's probe spawns nothing; the
    probe's process-group answer equals ``choose_backend``'s for 1, 4 and
    8 participants on this host; and (JAX's contract half) one contracted
    family recorded through the probed backend equals that backend's
    contracts exactly (``proc``: its subprocess, already started)."""
    from unittest import mock

    from fed_tgan_torch.parallel.multihost import choose_backend
    from fed_tgan_torch.runtime import backend

    for spec in ("tpu", "plugin:doesnotexist"):
        try:
            backend.parse_backend(spec)
        except backend.BackendNotPortedError as exc:
            if "--backend gpu" not in str(exc) or \
                    "--backend cpu" not in str(exc):
                return _line(False, "backend-seam",
                             f"the refusal of {spec} names no flag: {exc}")
        else:
            return _line(False, "backend-seam", f"--backend {spec} accepted")
    spawned = []

    def no_spawn(*args, **kwargs):
        spawned.append(args)
        raise AssertionError("the cpu backend spawned a process")

    with mock.patch.object(backend.subprocess, "run", no_spawn):
        health = backend.get_backend("cpu").probe()
    if spawned or not health.ok:
        return _line(False, "backend-seam", "Backend('cpu').probe() "
                     f"spawned {len(spawned)} process(es), ok={health.ok}")
    info = {}
    if device == "cuda":
        info = backend.get_backend("gpu").probe().info
    answers = {n: backend.world_plan(info, n)["process_group"]
               for n in (1, 4, 8)}
    want = {n: choose_backend(n, device) for n in (1, 4, 8)}
    if answers != want:
        return _line(False, "backend-seam", f"the probe's process groups "
                     f"{answers} != choose_backend's {want}")
    differs = _seam_contracts(device, contracts_dir, timeout, proc)
    if differs:
        return _line(False, "backend-seam", differs)
    return _line(True, "backend-seam", "tpu and plugin:<name> refused "
                 "naming --backend gpu|cpu; Backend('cpu') spawned no probe; "
                 "the probe's process group for 1/4/8 participants "
                 f"{'/'.join(answers[n] for n in (1, 4, 8))} = "
                 "choose_backend's; parallel_fedavg through the "
                 f"{'gpu' if device == 'cuda' else 'cpu'} backend = its "
                 "contracts")


@_check("launch-pod")
def check_launch_pod(device: str, timeout: int = 60) -> bool:
    """``scripts/torch_launch_pod.py --dry-run`` prints the whole
    rank/port/env plan from a parent that imports no torch: planning a
    pod must never cost a CUDA init in the supervisor."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "scripts", "torch_launch_pod.py")
    try:
        proc = subprocess.run(
            [sys.executable, script, "--processes", "3", "--dry-run",
             "--backend", "gpu" if device == "cuda" else "cpu"],
            capture_output=True, text=True, timeout=timeout, cwd=repo)
    except subprocess.TimeoutExpired:
        return _line(False, "launch-pod",
                     f"--dry-run timed out after {timeout}s")
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-2:]
        return _line(False, "launch-pod",
                     " | ".join(tail) or "--dry-run failed")
    ranks = [ln for ln in proc.stdout.splitlines() if ln.startswith("rank ")]
    if len(ranks) != 3:
        return _line(False, "launch-pod",
                     f"expected 3 rank plan lines, got {len(ranks)}")
    if "parent_torch_imported=False" not in proc.stdout:
        return _line(False, "launch-pod", "the planning parent imported "
                     "torch (parent_torch_imported=False missing)")
    roles = [ln.split("role=")[1].split()[0] for ln in ranks]
    if roles != ["coordinator", "participant", "participant"]:
        return _line(False, "launch-pod", f"unexpected roles {roles}")
    return _line(True, "launch-pod", "3-process plan (1 coordinator + 2 "
                 "participants) printed from a torch-free parent")


def wait_healthy(timeout_min: float = 0.0, quiet_min: float = 45.0,
                 probe_timeout_s: int = 120,
                 _probe=None, _load=None, _sleep=None, _log=print) -> bool:
    """Block until the card answers a fresh probe (counterpart of
    ``fed_tgan_tpu/doctor.py::wait_healthy``).

    Returns True the moment a probe succeeds, False when ``timeout_min``
    (0 = wait forever) elapses first.  It never probes while the host is
    busy -- 1-minute load average >= max(1, 0.75 x CPU count) -- and
    defers 2 min instead; after a failed probe it holds a
    ``quiet_min``-minute quiet window rather than probing again at once.
    Every probe ignores the stamp: a stamp older than a fresh hang must
    not vouch for a card this waiter never asked.  ``_probe``/``_load``/
    ``_sleep``/``_log`` are test seams."""
    from fed_tgan_torch.runtime.backend import probe_backend_responsive

    probe = _probe or (
        lambda: probe_backend_responsive(timeout_s=probe_timeout_s,
                                         ignore_cache=True))
    load = _load or (lambda: os.getloadavg()[0])
    sleep = _sleep or time.sleep
    # one busy CPU on a many-core host is idle for probing purposes
    busy_at = max(1.0, 0.75 * (os.cpu_count() or 1))
    deadline = (time.monotonic() + timeout_min * 60.0) if timeout_min > 0 \
        else None

    def pause(seconds: float) -> bool:
        """Sleep, capped to the remaining deadline; False = deadline hit."""
        if deadline is not None:
            seconds = min(seconds, deadline - time.monotonic())
            if seconds <= 0:
                return False
        sleep(seconds)
        return deadline is None or time.monotonic() < deadline

    while True:
        cur = load()
        if cur >= busy_at:
            _log(f"doctor: host busy (load {cur:.2f} >= {busy_at:.2f}); "
                 "deferring probe 2 min")
            if not pause(120):
                break
            continue
        ok, reason = probe()
        if ok:
            _log("doctor: CUDA backend healthy")
            return True
        _log(f"doctor: probe failed ({reason}); "
             f"quiet window {quiet_min:.1f} min")
        if not pause(quiet_min * 60.0):
            break
    _log("doctor: wait-healthy timed out")
    return False


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m fed_tgan_torch.doctor",
        description="diagnose the layers a run of the port depends on, "
                    "bottom-up; exit 0 = every check passed")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the checks run (default: the card; cpu "
                         "only when asked)")
    ap.add_argument("--probe-timeout", type=int, default=120,
                    help="the backend probe's timeout in seconds")
    ap.add_argument("--wait-healthy", action="store_true",
                    help="instead of the diagnosis, block until the card "
                         "answers a fresh probe (defers under host load, "
                         "holds a quiet window after a failed probe); "
                         "exit 0 = healthy")
    ap.add_argument("--wait-timeout-min", type=float, default=0.0,
                    help="--wait-healthy: give up after this many minutes "
                         "(0 = wait forever)")
    ap.add_argument("--quiet-window-min", type=float, default=45.0,
                    help="--wait-healthy: quiet window after a failed probe")
    args = ap.parse_args(argv)
    device = args.device
    if args.wait_healthy:
        if device == "cpu":
            print("doctor: --device cpu: the CPU needs no probe; healthy")
            return 0
        return 0 if wait_healthy(
            timeout_min=args.wait_timeout_min,
            quiet_min=args.quiet_window_min,
            probe_timeout_s=args.probe_timeout) else 1
    t0 = time.perf_counter()
    checks = [check_runtime(device),
              check_backend(device, args.probe_timeout),
              check_device(device)]
    if not checks[-1]:
        print(f"{sum(checks)}/{len(checks)} checks passed (no device: the "
              "other checks were not run)")
        return 1
    arts = _Artifacts(device)
    # the three analysis subprocesses run beside the in-process checks
    procs = {"contracts": _spawn_analysis(["--contracts"], device),
             "all": _spawn_analysis(["--all"], device),
             "seam": _spawn_seam(device)}
    try:
        checks += [
            check_kernels(device),
            check_transport(device),
            check_robust_aggregation(device),
            check_precision(device),
            check_rounds_per_program(device),
            check_cohort_scale(device),
            check_onboarding(device),
            check_elastic_federation(device),
            check_observability(device),
            check_observatory(device),
            check_cost_ledger(device),
            check_serving(device, arts),
            check_serving_fleet(device, arts),
            check_front_door(device, arts),
            check_quality_canary(device, arts),
            check_locklint(device, arts),
            check_obslint(device),
            check_static_analysis(device),
            check_program_contracts(device, proc=procs["contracts"]),
            check_analysis_all(device, proc=procs["all"]),
            check_backend_seam(device, proc=procs["seam"]),
            check_launch_pod(device),
        ]
    finally:
        arts.close()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    bad = checks.count(False)
    print(f"{len(checks) - bad}/{len(checks)} checks passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
