"""What decides ``correct``: the program's first three rounds, as the
timed call ran them in set-up, against the plain reference.

GAN training under Adam is chaotic: a rounding difference in a small
gradient moves an element by up to the learning rate, and a ReLU that
flips changes a gradient, so the two sides drift apart over the rounds
by amounts that float32 and TF32 reach alike.  The numbers compared are
therefore those that stay steady from seed to seed (each with its own
limit from the cell's file):

- ``loss_gap``: round 1's last-step ``loss_d``, ``pen`` and ``loss_g`` of
  every client; each gap over the larger of the reference's value and
  that loss's median size over clients; the median over the clients'
  losses;
- ``client_loss_gap``: the same round-1 ``loss_d`` and ``loss_g`` gaps
  (each over the larger of the reference's value and that loss's median
  size over the checked rounds and clients), the worst client's: a fault
  in one slot of the stacked step shows here, where the medians and the
  aggregate dilute it.  ``pen`` is left out: it is ``(|grad D| - 1)^2``
  near ``|grad D| = 1``, so its relative gap swings from nought to a few
  per cent on one client of a sound run;
- ``moment_gap``: after round 1, each client's Adam first moment (the
  gradients as the optimizer took them); per leaf the median over
  clients of the gap between the two sides' norms, over the larger of
  the reference's norm and its median leaf's; the worst leaf;
- ``change_gap``: after round 3, per aggregated leaf the gap between the
  norms of the two sides' change from the initial state, over the larger
  of the reference's and its median leaf's; the worst leaf;
- ``snapshot_cells_pct`` (snapshot traffic): the share of cells of round
  1's 40,000-row snapshot file that are not the reference's rows, a
  value off by more than one step of the packed8 layout.  (By round 3
  the drift can move a column's output by two steps on every row.)

Leaves whose reference gradient is under a thousandth of the median
leaf's (a critic's output bias, whose gradient cancels) move by
round-off alone: they are left out of ``moment_gap`` and ``change_gap``.
"""

from __future__ import annotations

import csv

import numpy as np
import torch

ROUNDS = 3
SNAPSHOT_ROUND = 0   # the checked snapshot: round 1's
NEGLIGIBLE = 1e-3
CLIENT_LOSSES = (0, 2)   # loss_d, loss_g of (loss_d, pen, loss_g)


def loss_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """``prog``, ``ref`` (clients, 3): round 1's losses.  Each gap over
    the larger of the reference's value and that loss's median size over
    clients; the median over every client's three losses."""
    scale = np.maximum(np.median(np.abs(ref), axis=0, keepdims=True), 1e-12)
    return float(np.median(np.abs(prog - ref) / np.maximum(np.abs(ref),
                                                            scale)))


def client_loss_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """``prog`` (clients, 3): round 1's losses; ``ref`` (rounds, clients,
    3): the reference's over the checked rounds.  The worst client's gap
    of ``loss_d`` and ``loss_g``, each over the larger of the reference's
    value and that loss's median size over rounds and clients."""
    scale = np.maximum(np.median(np.abs(ref), axis=(0, 1)), 1e-12)
    gap = np.abs(prog - ref[0]) / np.maximum(np.abs(ref[0]), scale)
    return float(gap[:, list(CLIENT_LOSSES)].max())


def kept_leaves(ref_moments: dict) -> list:
    """Leaves whose mean reference moment norm over clients is at least a
    thousandth of the median leaf's."""
    means = {k: float(np.mean(v)) for k, v in ref_moments.items()}
    med = float(np.median(list(means.values())))
    return [k for k, v in means.items() if v >= NEGLIGIBLE * med]


def moment_gap(prog: dict, ref: dict, kept: list) -> float:
    """Per kept leaf, the median over clients of the gap between the
    norms of Adam's first moment, over the larger of the reference's
    norm and its median leaf's; the worst leaf."""
    med = np.median(np.stack([ref[k] for k in kept]), axis=0)
    return max(float(np.median(np.abs(prog[k] - ref[k])
                               / np.maximum(np.maximum(ref[k], med), 1e-30)))
               for k in kept)


def change_gap(prog: dict, ref: dict, kept: list) -> float:
    """``prog``, ``ref``: ``{leaf: norm of the change}``; running
    statistics have no gradient and are always kept."""
    keys = [k for k in ref if k in kept or "running" in k]
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def snapshot_stream(args, seed: int):
    """``(rows, stream)`` of the checked snapshot (round 1's), or None
    for traffic without snapshots; ``args`` the cell's CLI flags as
    parsed."""
    if not args.sample_every:
        return None
    from benchmark.reference.sample import KEY_OFFSET

    return args.sample_rows, seed + SNAPSHOT_ROUND + KEY_OFFSET


def as_written(rows: dict) -> dict:
    """Decoded rows as a snapshot file's cells (strings), so that rows the
    reference decoded can stand in the program's place."""
    return {k: (v.tolist() if v.dtype == object
                else [repr(float(x)) for x in v]) for k, v in rows.items()}


def read_snapshot(path: str) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: [r[j] for r in body] for j, name in enumerate(header)}


def snapshot_cells_pct(cells: dict, ref: dict, quanta: dict) -> float:
    """Per cent of cells that differ: a category that is not the
    reference's, or a number further from the reference's than one step
    of the packed8 layout (``4 sigma_k / 127`` of the reference's mode
    k; for a non-negative column the same step before ``exp(x) - 1``)."""
    total = differ = 0
    for name, ref_vals in ref.items():
        got = cells[name]
        total += len(ref_vals)
        if ref_vals.dtype == object:
            differ += sum(a != b for a, b in zip(got, ref_vals.tolist()))
            continue
        x = np.asarray([float(v) for v in got])
        q, nonneg = quanta[name]
        step = (np.abs(1.0 + ref_vals) * np.expm1(q) if nonneg else q)
        tol = step * (1.0 + 1e-6) + 1e-9 * (1.0 + np.abs(ref_vals))
        differ += int(np.sum(np.abs(x - ref_vals) > tol))
    return 100.0 * differ / max(total, 1)


def reference_readings(table: dict, schema, config: dict, seed: int,
                       device, tf32: bool = False, snapshot=None) -> dict:
    """The reference's readings for the numbers above: ``metrics`` (3,
    P, 3), ``moments`` after round 1, ``change`` after round 3 and, with
    ``snapshot = (rows, stream)``, round 1's decoded rows."""
    from benchmark.reference import ctgan, init as ref_init
    from benchmark.reference.sample import sample

    ri = ref_init.initialize(table, schema.CATEGORICAL, schema.NON_NEGATIVE,
                             config["n_clients"], seed, device)
    out: dict = {"metrics": [], "weights": ri.weights}
    start: dict = {}

    def on_round(r, clients, metrics):
        out["metrics"].append(metrics)
        if r == 0:
            out["moments"] = {}
            for tag, attr, opt in (("G", "G", "opt_g"), ("D", "D", "opt_d")):
                for name, p in getattr(clients[0], attr).named_parameters():
                    out["moments"][f"{tag}.{name}"] = np.asarray([
                        float(torch.linalg.vector_norm(
                            getattr(c, opt).state[
                                dict(getattr(c, attr).named_parameters())[name]
                            ]["exp_avg"]))
                        for c in clients])
        if r == SNAPSHOT_ROUND and snapshot is not None:
            rows, stream = snapshot
            out["snapshot"], out["quanta"] = sample(
                clients[0].G, ri, config, rows, stream, device)
        if r == ROUNDS - 1:
            now = ctgan.shared_state(clients[0].G, clients[0].D)
            out["change"] = {k: float(torch.linalg.vector_norm(
                now[k].detach().float() - start[k])) for k in now}

    layout = ctgan.Layout(ri.segments)
    G0, D0 = ctgan.init_models(config["embedding_dim"] + layout.n_opt,
                               layout.dim, config, seed)
    start.update({k: v.detach().float().to(device) for k, v in
                  ctgan.shared_state(G0, D0).items()})
    clients = ctgan.run(ri, config, seed, ROUNDS, device, tf32=tf32,
                        on_round=on_round)
    out["metrics"] = np.stack(out["metrics"])
    return out


def compare(prog: dict, ref: dict) -> dict:
    """``{number: value}`` of the program's readings against the
    reference's."""
    kept = kept_leaves(ref["moments"])
    first = np.asarray(prog["metrics"][0])
    out = {"loss_gap": loss_gap(first, ref["metrics"][0]),
           "client_loss_gap": client_loss_gap(first, ref["metrics"]),
           "moment_gap": moment_gap(prog["moments"], ref["moments"], kept),
           "change_gap": change_gap(prog["change"], ref["change"], kept)}
    if "snapshot" in ref:
        out["snapshot_cells_pct"] = snapshot_cells_pct(
            prog["snapshot"], ref["snapshot"], ref["quanta"])
    return out
