"""The multi-process federation: the reference's own launch
(counterpart of ``fed_tgan_tpu/train/multihost.py``).

The reference's one launch does the init and the training across real
processes (reference Server/dtds/distributed.py:838-891): every round each
client trains locally, ships its state to rank 0, rank 0 averages and
samples a snapshot.  Here, after the init protocol
(:mod:`fed_tgan_torch.federation.distributed`):

- participant r (ranks 1..N, :func:`client_train`) holds client r - 1 in a
  1-slot stack (:class:`~fed_tgan_torch.train.steps.StackedModels`, its
  samplers and Adam) on its own device.  A round is ``max(steps_i)`` calls
  of :func:`~fed_tgan_torch.train.steps.stacked_train_step`, masked past
  its own step count, then one all-gather of its leaves
  (:func:`~fed_tgan_torch.parallel.multihost.gather_leaves`) and the
  in-process trainer's gate and aggregator
  (:func:`~fed_tgan_torch.train.federated.aggregate_updates`) over the
  stacked updates in rank order, so every participant holds the same
  bits.  The aggregate is written back and folded into the EMA;
- all-gather and not all-reduce: the gated and robust aggregators need
  every update, a sum in rank order on every participant gives every rank
  and every run the same bits, and it is the in-process round's function
  on the same stacked input;
- every rank derives the initial models as the in-process trainer does
  (``init_models(spec, cfg, seed)``) and participant r draws from a
  generator seeded as the in-process trainer seeds client r - 1, so its
  draws are that client's.  A 1-slot stack may round otherwise than the
  in-process N-slot stack: the two agree within the round tolerance;
- rank 1 samples each snapshot round's aggregated generator (or the
  debiased EMA) from the pooled condition counts and ships the packed
  parts to rank 0 through one ordered sender thread, the decode columns
  with the first snapshot only; rank 0 (:func:`server_train`) owns the
  CSVs and the timing files, and checks that every participant's final
  generator (and EMA) equals rank 1's;
- an update fault corrupts its client's position of the gathered stack on
  every rank; no rank evicts a client (the gate re-masks it every round).
  ``kill_client:rank=R,round=E`` hard-exits participant R at the start of
  round E: its peers' collective fails, rank 0's heartbeat check raises,
  and the run is resumed from the per-rank checkpoints (``save_every``).

Each rank journals into its own process journal (the CLI's
``<journal>_rank<r>``): participants a ``round`` (``role="client"``) and a
``client_contribution`` of their client per round, and ``checkpoint``
events; rank 0 a ``round`` (``role="server"``) per report.  ``python -m
fed_tgan_torch.obs report journal_rank*.jsonl`` merges them into one
federation view (rounds once, server first).  ``/healthz`` carries each
rank's role and round; the spans are ``multihost.local_steps`` and
``multihost.checkpoint``.  All of it reads the round's one host copy.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.obs.exporter import get_health
from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.obs.trace import span as _span
from fed_tgan_torch.ops.decode import SnapshotDecode, select_snapshot_decode
from fed_tgan_torch.ops.segments import SegmentSpec
from fed_tgan_torch.parallel import fedavg, multihost
from fed_tgan_torch.runtime.checkpoint import (
    SavedSynthesizer,
    _write_checkpoint,
    config_to_dict,
)
from fed_tgan_torch.serve.engine import SamplingEngine, step_seed
from fed_tgan_torch.serve.registry import LoadedModel
from fed_tgan_torch.testing.faults import active_plan, update_fault_window
from fed_tgan_torch.train.federated import (
    KEY_OFFSET,
    aggregate_updates,
    build_client_stacks,
    corrupt_updates,
    fold_ema,
    write_timing,
)
from fed_tgan_torch.train.sampler import CondSampler
from fed_tgan_torch.train.snapshots import SnapshotWriter, result_path_fn
from fed_tgan_torch.train.steps import (
    TrainConfig,
    client_draws,
    draw_into,
    init_models,
    stack_models,
    stacked_draws,
    stacked_train_step,
)

log = logging.getLogger("fed_tgan_torch.train")
CKPT_KIND = "multihost_participant_torch"


@dataclass(frozen=True)
class MultihostRun:
    """The knobs the server and the participants share.  ``epochs`` is
    the total round budget (a resumed run does the rest); ``save_every``
    and ``ckpt_dir`` make each participant keep its own checkpoint
    (``<ckpt_dir>/multihost_rank<r>``), which ``resume`` continues."""

    epochs: int
    sample_every: int = 1
    sample_rows: int = 40000
    seed: int = 0
    log_every: int = 0
    save_every: int = 0
    ckpt_dir: Optional[str] = None
    resume: bool = False
    decode: str = "packed8"
    snapshot_format: str = "csv"  # csv | feather | parquet (rank 0 writes)


def _maybe_fault_kill(rank: int, round_1based: int) -> None:
    """A participant scheduled to die at this round hard-exits, as a
    crashed process would."""
    plan = active_plan()
    if plan is not None and plan.should_kill(rank, round_1based):
        logging.getLogger("fed_tgan_torch.faults").warning(
            "FAULT: rank %d hard-exiting at round %d", rank, round_1based)
        os._exit(17)


def _snapshot_epochs(run: MultihostRun) -> set:
    """Rounds whose model gets a snapshot: every ``sample_every`` rounds,
    or only the last when 0."""
    if run.epochs <= 0:
        return set()
    if run.sample_every:
        return {e for e in range(run.epochs) if e % run.sample_every == 0}
    return {run.epochs - 1}


def ckpt_path(ckpt_dir: str, rank: int) -> str:
    return os.path.join(ckpt_dir, f"multihost_rank{rank}")


def _save_participant(run: MultihostRun, rank: int, stack, gen, ema,
                      ema_updates: int, epochs_done: int, n_clients: int,
                      cfg: TrainConfig) -> None:
    """This rank's state, crash-safe (``host.json`` + ``arrays.npz``,
    :func:`~fed_tgan_torch.runtime.checkpoint.save_federated`'s staging):
    its 1-slot weights, BatchNorm state and batch counts, both Adam
    states, the EMA and its count, its generator's state, the round, the
    seed, N and the config.  Each rank writes only its own directory."""
    G, D = stack.generator, stack.discriminator
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    arrays = {"g.params": host(G.params), "g.bn_state": host(G.bn_state),
              "g.num_batches": host(G.num_batches), "d.params": host(D.params),
              "rng": gen.get_state().numpy()}
    for name, opt in (("opt_g", stack.opt_g), ("opt_d", stack.opt_d)):
        for key in ("count", "exp_avg", "exp_avg_sq", "grad"):
            arrays[f"{name}.{key}"] = host(getattr(opt, key))
    if ema is not None:
        arrays["ema.params"], arrays["ema.state"] = (host(t) for t in ema)
    meta = {"version": 1, "kind": CKPT_KIND, "rank": rank, "seed": run.seed,
            "n_clients": n_clients, "config": config_to_dict(cfg),
            "epochs_done": epochs_done, "ema_updates": ema_updates,
            "rng_device": gen.device.type}
    path = ckpt_path(run.ckpt_dir, rank)
    with _span("multihost.checkpoint", rank=rank):
        _write_checkpoint(path, meta, arrays, keep=1)
    _emit_event("checkpoint", path=path, kind="multihost_participant",
                rank=rank, round=int(epochs_done))


def _load_participant(run: MultihostRun, rank: int, n_clients: int,
                      cfg: TrainConfig) -> tuple:
    """``(host fields, arrays)`` of this rank's checkpoint, validated:
    resuming under another world size, seed or config would give a
    trajectory neither bit-exact nor comparable, so a mismatch fails
    fast."""
    path = ckpt_path(run.ckpt_dir, rank)
    with open(os.path.join(path, "host.json")) as f:
        state = json.load(f)
    want = {"rank": rank, "seed": run.seed, "n_clients": n_clients,
            "config": config_to_dict(cfg)}
    got = {k: state.get(k) for k in want}
    if got != want:
        diffs = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise RuntimeError(
            f"checkpoint {path} does not match this run (saved vs "
            f"current): {diffs}; resume needs the same world size, seed "
            "and training config")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return state, arrays


def _publish_rank_obs(rank: int, client: int, e: int, seconds: float,
                      host: np.ndarray, weights: np.ndarray) -> None:
    """Participant ``rank``'s ``/healthz`` fields and the round's
    ``client_contribution`` of its client (``fed_tgan_tpu/train/
    multihost.py:219-272``), from the round's host copy ``host`` (loss_d,
    pen, loss_g, then the quarantine mask of every client)."""
    get_health().update(
        status="training", role="client", rank=int(rank),
        client=int(client), round=int(e), per_round_s=round(seconds, 6),
        rounds_per_s=round(1.0 / seconds, 3) if seconds > 0 else None)

    def num(x):
        return round(float(x), 6) if np.isfinite(x) else None

    _emit_event("client_contribution", round=int(e), first=int(e),
                rounds_per_program=1, rank=int(rank), clients=[int(client)],
                weights=[round(float(weights[client]), 6)],
                loss_d=[num(host[0])], loss_g=[num(host[2])],
                quarantined=[int(host[3 + client] > 0.5)], strikes=[0])


class _OrderedSender:
    """Rank 1's sender: every message (round reports, snapshots, the
    final ``done``) goes through one worker thread in enqueue order, so
    the transport never sees interleaved writes, while a snapshot's wait
    for its device-to-host copy and its TCP hop overlap the next round.
    At most ``max_pending`` messages are in flight; a worker's error is
    re-raised at the next send or when the ``with`` block exits."""

    def __init__(self, transport, max_pending: int = 2):
        self.transport = transport
        self.max_pending = max_pending
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: list = []

    def throttle(self) -> None:
        while len(self._pending) >= self.max_pending:
            self._pending.pop(0).result()

    def send(self, msg: dict, parts=None) -> None:
        """Queue ``msg``; ``parts`` = (pinned host buffers, CUDA event or
        None) of a snapshot, attached once the event has fired."""
        self.throttle()
        self._pending.append(self._pool.submit(self._send, msg, parts))

    def _send(self, msg: dict, parts) -> None:
        if parts is not None:
            buffers, event = parts
            if event is not None:
                event.synchronize()
            msg["snapshot_parts"] = {k: v.numpy() for k, v in buffers.items()}
        self.transport.send_obj(msg)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                while self._pending:
                    self._pending.pop(0).result()
        finally:
            self._pool.shutdown(wait=exc_type is None, cancel_futures=True)


def _to_pinned(parts: dict) -> tuple:
    """Non-blocking copies of a snapshot's device ``parts`` into pinned
    host buffers, and the CUDA event after them (None on the CPU)."""
    buffers, event = {}, None
    for k, v in parts.items():
        buffers[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
        buffers[k].copy_(v, non_blocking=True)
        if v.is_cuda and event is None:
            event = torch.cuda.Event()
    if event is not None:
        event.record()
    return buffers, event


def client_train(transport, init_out: dict, cfg: TrainConfig,
                 run: MultihostRun, device="cuda",
                 models: Optional[list] = None, draws=None) -> dict:
    """Train participant ``transport.rank`` (its client is rank - 1) for
    the rest of ``run.epochs`` rounds; the process group of
    :func:`~fed_tgan_torch.parallel.multihost.initialize_multihost` must
    exist.  ``models`` (one per client, as ``FederatedTrainer`` takes
    them) replaces the initial models and ``draws(round, client, step)``
    every step's draws (tests).

    Returns ``params_g`` and ``ema`` (host state dicts of the aggregated
    generator and of the debiased EMA, or None), ``stack`` and per round
    its ``seconds`` (local steps, all-gather, aggregation), ``local_s``,
    ``gather_s`` and ``snapshot_s`` (rank 1's snapshot dispatch, after
    the round)."""
    rank, c = transport.rank, transport.rank - 1
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    spec = SegmentSpec.from_output_info(init_out["transformer"].output_info)
    n_clients = multihost.n_participants()
    rows_per_client = [int(r) for r in init_out["rows_per_client"]]
    if len(rows_per_client) != n_clients:
        raise RuntimeError(
            f"init protocol saw {len(rows_per_client)} clients but the "
            f"world has {n_clients} participants")
    steps_all = np.asarray([r // cfg.batch_size for r in rows_per_client])
    if (steps_all == 0).any() and not cfg.allow_zero_step_clients:
        small = [i for i, s in enumerate(steps_all) if s == 0]
        raise ValueError(
            f"clients {small} hold fewer than batch_size={cfg.batch_size} "
            "rows (reference behavior: they would train 0 steps); rebalance "
            "shards, shrink the batch, or opt in with "
            "TrainConfig(allow_zero_step_clients=True)")
    matrix = np.asarray(init_out["matrix"], dtype=np.float32)
    cond, rows, data, _, _ = build_client_stacks(
        SimpleNamespace(client_matrices=[matrix]), cfg, spec, device)
    own_steps, max_steps = int(steps_all[c]), int(steps_all.max())
    active = torch.arange(max_steps, device=device)[:, None] < own_steps
    host_w = np.asarray(init_out["weights"], np.float32)
    weights = torch.as_tensor(host_w, device=device)
    steps_dev = torch.as_tensor(steps_all, device=device)

    one = (models[c] if models is not None
           else init_models(spec, cfg, run.seed, device))
    stack = stack_models([one])
    G = stack.generator
    keep = [s[1:] for s in stack.discriminator.keep_shapes(cfg.batch_size)]
    buf = stacked_draws(spec, cfg, 1, keep, device)
    dst = client_draws(buf, 0)
    gen = torch.Generator(device=device).manual_seed(step_seed(run.seed, c))
    bn0 = G.bn_index(torch.zeros(1, dtype=torch.long, device=device))
    ema = ([torch.zeros_like(G.params[0].detach()),
            torch.zeros_like(G.bn_state[bn0])]
           if cfg.ema_decay > 0.0 else None)
    ema_updates = 0

    e = 0
    if run.resume and run.ckpt_dir:
        saved = None
        if os.path.isdir(ckpt_path(run.ckpt_dir, rank)):
            saved = _load_participant(run, rank, n_clients, cfg)
            e = int(saved[0]["epochs_done"])
        # every participant must resume from the same round, or the
        # collectives desync: agree before any round
        lo, hi = multihost.agree(e)
        if lo != hi:
            raise RuntimeError(
                f"ranks disagree on the resume round (min {lo}, max {hi}) — "
                "the previous run died between two ranks' checkpoint "
                f"writes, so a consistent round-{lo} state no longer exists "
                "on every host; relaunch without --resume to restart from "
                "round 0 (each rank keeps only its latest checkpoint in "
                f"{run.ckpt_dir})")
        if saved is not None:
            host, arrays = saved
            with torch.no_grad():
                for t, key in ((G.params, "g.params"),
                               (G.bn_state, "g.bn_state"),
                               (G.num_batches, "g.num_batches"),
                               (stack.discriminator.params, "d.params")):
                    t.copy_(torch.as_tensor(arrays[key]))
            for name, opt in (("opt_g", stack.opt_g), ("opt_d", stack.opt_d)):
                opt.load(*(arrays[f"{name}.{k}"] for k in
                           ("count", "exp_avg", "exp_avg_sq")))
                opt.grad.copy_(torch.as_tensor(arrays[f"{name}.grad"]))
            if host["rng_device"] == device.type:
                gen.set_state(torch.as_tensor(arrays["rng"]))
            else:
                log.warning("rank %d: generator state saved on %s, loaded "
                            "on %s; reseeded", rank, host["rng_device"],
                            device.type)
                gen.manual_seed(step_seed(step_seed(run.seed, c), e))
            if ema is not None:
                if "ema.params" not in arrays:
                    raise RuntimeError(
                        f"resume with ema_decay={cfg.ema_decay} but the rank "
                        f"{rank} checkpoint carries no EMA chain (saved by "
                        "an EMA-off run?)")
                for t, key in zip(ema, ("ema.params", "ema.state")):
                    t.copy_(torch.as_tensor(arrays[key]))
                ema_updates = int(host["ema_updates"])

    def global_state(use_ema: bool) -> dict:
        """The aggregated generator, or the debiased EMA, as a
        ``Generator`` state dict on the device."""
        if not use_ema:
            return {k: v.detach().clone() for k, v in G.client_state(0).items()}
        scale = 1.0 / (1.0 - cfg.ema_decay ** ema_updates)
        params, bn = (x * scale for x in ema)
        return G.flat_state(params, bn, G.num_batches[0].clone())

    engine = decode = None
    firing = _snapshot_epochs(run)
    if rank == 1:
        # generation draws from the pooled condition counts (the reference
        # server's full-table Cond, distributed.py:565-580)
        pooled = CondSampler.from_counts(init_out["cond_counts"], spec, device)
        columns = init_out["transformer"].columns
        decode = select_snapshot_decode(columns, run.decode)
        engine = SamplingEngine(LoadedModel(
            model_id="in-memory",
            synth=SavedSynthesizer(G.unstack(0), pooled, columns, cfg,
                                   key_offset=KEY_OFFSET),
            meta=init_out["global_meta"],
            encoders=tuple(init_out["encoders"]), artifact=None))
    send_columns = True
    times = {"seconds": [], "local_s": [], "gather_s": [], "snapshot_s": []}
    sender = _OrderedSender(transport) if rank == 1 else None
    end = run.epochs
    with sender if sender is not None else contextlib.nullcontext():
        while e < end:
            _maybe_fault_kill(rank, e + 1)
            fault, _ = update_fault_window(active_plan(), e, 1)
            t0 = time.perf_counter()
            with torch.no_grad():
                prev = [x[0].clone() for x in fedavg.agg_leaves(stack)]
            metrics = torch.zeros((1, 3), device=device)
            with _span("multihost.local_steps", rank=rank, rounds=1):
                for s in range(max_steps):
                    if s < own_steps:
                        if draws is not None:
                            for a, b in zip(dst.tensors(),
                                            draws(e, c, s).tensors()):
                                a.copy_(b)
                        else:
                            draw_into(gen, spec, cfg, keep, device, dst)
                    metrics = stacked_train_step(stack, data, cond, rows,
                                                 buf, active[s], metrics)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            with torch.no_grad():
                new = multihost.gather_leaves(fedavg.agg_leaves(stack))
                t2 = time.perf_counter()
                if fault is not None:
                    new = corrupt_updates(prev, new, fault)
                agg, quar = aggregate_updates(prev, new, weights, steps_dev,
                                              cfg, robust=fault is not None)
                for x, a in zip(fedavg.agg_leaves(stack), agg):
                    x.copy_(a)
                if ema is not None:
                    fold_ema(ema, G, bn0, cfg.ema_decay)
                    ema_updates += 1
            # the round's one host copy
            # torchlint: disable=J01
            host = torch.cat([metrics.flatten(), quar.float()]).cpu().numpy()
            seconds = time.perf_counter() - t0
            for k, v in (("seconds", seconds), ("local_s", t1 - t0),
                         ("gather_s", t2 - t1)):
                times[k].append(v)
            if host[3:].any():
                log.warning("update gate quarantined clients %s in round %d",
                            np.flatnonzero(host[3:]).tolist(), e)
            _emit_event("round", role="client", rank=rank, first=e, last=e,
                        rounds=1, per_round_s=round(seconds, 6))
            _publish_rank_obs(rank, c, e, seconds, host, host_w)
            t3 = time.perf_counter()
            if sender is not None:
                msg = {"type": "chunk", "rounds": 1, "seconds": seconds,
                       "last": e}
                parts = None
                if e in firing:
                    if send_columns:  # the decode columns ride once
                        msg["decode"] = (decode.mode, decode.columns)
                        send_columns = False
                    sender.throttle()
                    engine.model.synth.generator.load_state_dict(
                        global_state(ema is not None))
                    parts = _to_pinned(engine.sample_parts(
                        run.sample_rows, decode, seed=run.seed + e,
                        to_host=False))
                sender.send(msg, parts)
            times["snapshot_s"].append(time.perf_counter() - t3)
            if run.save_every and run.ckpt_dir and (
                    (e + 1) % run.save_every == 0 or e == end - 1):
                _save_participant(run, rank, stack, gen, ema, ema_updates,
                                  e + 1, n_clients, cfg)
            if run.log_every and (e % run.log_every == 0 or e == end - 1):
                print(f"[rank {rank}] round {e}: loss_d={host[0]:.3f} "
                      f"loss_g={host[2]:.3f} ({seconds:.3f}s/round, "
                      f"all-gather {1e3 * (t2 - t1):.2f} ms)", flush=True)
            e += 1
        to_host = lambda st: {k: v.detach().cpu().numpy()  # noqa: E731
                              for k, v in st.items()}
        done = {"type": "done", "params_g": to_host(global_state(False)),
                "ema": (to_host(global_state(True))
                        if ema is not None and ema_updates else None)}
        if sender is not None:
            sender.send(dict(done))
    if sender is None:
        transport.send_obj(done)
    return {"params_g": done["params_g"], "ema": done["ema"],
            "stack": stack, **times}


def server_train(transport, init_out: dict, run: MultihostRun, name: str,
                 out_dir: str = ".", quiet: bool = False) -> dict:
    """Rank 0's role in training: receive rank 1's round reports and
    snapshots, write ``<out>/<name>_result/<name>_synthesis_epoch_<e>.csv``
    on a writer thread (the compiled formatter, the in-process writer's
    bytes) and the timing files, then check that every participant's
    final generator, and EMA, equals rank 1's.  A participant that goes
    silent aborts the run with the remedy.  Returns the per-round
    ``epoch_times`` and ``phase_times``."""
    from fed_tgan_torch.runtime.transport import TransportError

    def recv_or_abort(rank: int, timeout_ms=None):
        """A dead or late participant aborts cleanly: the group cannot
        lose a live member mid-collective, so the failure story is the
        heartbeat check, the per-rank checkpoints and ``--resume``."""
        try:
            return transport.recv_obj(rank, timeout_ms)
        except TransportError as exc:
            raise RuntimeError(
                f"multihost training aborted: rank {rank} unreachable "
                f"({exc}); relaunch with --resume to continue from the "
                "per-rank checkpoints") from exc

    epoch_times: list = []
    phase_times = {"train_aggregate": [], "distribution": []}
    decode = None
    writer = SnapshotWriter(init_out["global_meta"], init_out["encoders"],
                            result_path_fn(out_dir, name),
                            rows=run.sample_rows, seed=run.seed,
                            fmt=run.snapshot_format)
    with writer:
        while True:
            msg = recv_or_abort(1, transport.deadlines.train_ms)
            if msg["type"] == "done":
                finals = [(msg["params_g"], msg.get("ema"))]
                break
            if "decode" in msg:
                decode = SnapshotDecode(msg["decode"][1], msg["decode"][0])
            per_round = msg["seconds"] / msg["rounds"]
            _emit_event("round", role="server",
                        first=msg["last"] - msg["rounds"] + 1,
                        last=msg["last"], rounds=msg["rounds"],
                        per_round_s=round(per_round, 6))
            get_health().update(
                status="training", role="server", rank=0,
                round=int(msg["last"]), per_round_s=round(per_round, 6),
                rounds_per_s=(round(1.0 / per_round, 3) if per_round > 0
                              else None))
            t0 = time.perf_counter()
            if msg.get("snapshot_parts") is not None:
                writer.write_parts(msg["last"], msg["snapshot_parts"], decode)
            hook = time.perf_counter() - t0
            phase_times["train_aggregate"].append(per_round)
            phase_times["distribution"].append(hook)
            epoch_times.append(per_round + hook)
            if run.log_every and not quiet and \
                    msg["last"] % run.log_every == 0:
                print(f"[server] round {msg['last']}: {per_round:.3f}s/round",
                      flush=True)
    finals += [(m["params_g"], m.get("ema")) for m in
               (recv_or_abort(r) for r in range(2, transport.n_clients + 1))]
    for r, (params, ema) in enumerate(finals[1:], start=2):
        if not (_same(finals[0][0], params) and _same(finals[0][1], ema)):
            raise RuntimeError(
                f"post-psum params differ between rank 1 and rank {r}: the "
                "cross-host FedAvg collective is broken")
    write_timing(out_dir, epoch_times, phase_times)
    if not quiet:
        print(f"final aggregated params identical across {len(finals)} "
              f"participants ({len(epoch_times)} rounds)", flush=True)
        if writer.write_s:
            print(f"snapshot CSVs written in {writer.write_s} s on the "
                  "writer thread", flush=True)
    return {"epoch_times": epoch_times, "phase_times": phase_times}


def _same(a: Optional[dict], b: Optional[dict]) -> bool:
    """Two host state dicts (or None) equal key for key, bit for bit,
    BatchNorm's ``num_batches_tracked`` aside: it counts the participant's
    own local steps and is not part of the aggregate."""
    if a is None or b is None:
        return a is b
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a
        if not k.endswith("num_batches_tracked"))
