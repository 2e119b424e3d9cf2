"""The system under test, built as ``python -m fed_tgan_torch --mode
fedavg`` builds it (``fed_tgan_torch/cli.py`` ``_run`` ->
``_run_federated`` -> ``_run_training``) for the cell's CLI flags: the
configuration's ``flags`` then the traffic's, parsed by the CLI's own
parser, so every default is the CLI's.  IID shards of the table, one
``TablePreprocessor`` a client with the dataset preset,
``federated_initialize``, ``FederatedTrainer`` and, where the traffic
snapshots, a ``SnapshotWriter`` as the rounds' sample hook.  Also what
the check reads from it: per-round losses, Adam's first moments, the
aggregated leaves and the snapshot files.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

# the configuration's numbers that its CLI flags have to state
STATED = ("n_clients", "batch_size", "embedding_dim", "precision",
          "gate_norm_factor", "similarity", "shard_strategy", "dataset")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cli_args(config: dict, traffic: dict, seed: int):
    """The CLI's ``args`` for the cell: ``--mode fedavg``, the
    configuration's flags, the traffic's flags and ``--seed``."""
    from fed_tgan_torch.cli import _check_round_flags, build_parser

    parser = build_parser()
    args = parser.parse_args(["--mode", "fedavg", *config["flags"],
                              *traffic["flags"], "--seed", str(seed)])
    _check_round_flags(args, parser)
    for key in STATED:
        if getattr(args, key) != config[key]:
            raise ValueError(f"configuration {key}={config[key]!r}: its "
                             f"flags give {getattr(args, key)!r}")
    return args


def train_config(args, tables: list):
    """``TrainConfig`` from the CLI's flags, as ``cli.py::_run`` makes
    it."""
    from fed_tgan_torch.train.steps import TrainConfig, lr_decay_horizon

    return TrainConfig(
        batch_size=args.batch_size, embedding_dim=args.embedding_dim,
        lr_schedule=args.lr_schedule,
        lr_decay_steps=lr_decay_horizon(
            args.lr_schedule, args.epochs,
            max(len(next(iter(t.values()))) for t in tables),
            args.batch_size),
        allow_zero_step_clients=args.allow_zero_step_clients,
        aggregator=args.aggregator, update_gate=not args.no_update_gate,
        gate_norm_factor=args.gate_norm_factor,
        update_clip=args.update_clip, trim_ratio=args.trim_ratio,
        precision=args.precision, cohort=args.cohort,
        aggregation=args.aggregation, ema_decay=args.ema_decay)


class Program:
    def __init__(self, config: dict, traffic: dict, table: dict, seed: int,
                 device, out_dir: str):
        from fed_tgan_torch.cli import _dataset_kwargs
        from fed_tgan_torch.data.ingest import TablePreprocessor
        from fed_tgan_torch.data.sharding import shard_table
        from fed_tgan_torch.federation.init import federated_initialize

        self.device = device
        self.args = args = cli_args(config, traffic, seed)
        name, kwargs = _dataset_kwargs(args)
        label = kwargs.get("target_column") or None
        tables = shard_table(
            table, args.n_clients or 1, args.shard_strategy,
            label_column=(label if args.shard_strategy in
                          ("label_sorted", "dirichlet") else None),
            alpha=args.alpha, seed=args.seed)
        selected = kwargs.pop("selected_columns", None)
        columns = list(selected) if selected else list(tables[0])
        cfg = train_config(args, tables)
        # the CLI has no flag for these: the configuration states the
        # program's defaults
        for key in ("gen_dims", "dis_dims", "pac", "lr", "beta1", "beta2",
                    "l2scale", "d_steps"):
            want = config[key]
            have = getattr(cfg, key)
            if (list(have) if isinstance(have, tuple) else have) != want:
                raise ValueError(f"configuration {key}={want!r}: the program "
                                 f"runs {have!r}")
        self.cfg = cfg
        clients = [TablePreprocessor(table=t, name=name,
                                     selected_columns=columns, **kwargs)
                   for t in tables]
        t0 = time.perf_counter()
        self.init = federated_initialize(clients, seed=args.seed,
                                         weighted=not args.uniform,
                                         device=device,
                                         similarity=args.similarity,
                                         cache=args.init_cache,
                                         backend=args.bgm_backend)
        sync(device)
        self.init_s = time.perf_counter() - t0
        self.name, self.out_dir = name, out_dir
        self.writer = None
        self.start_training()

    def start_training(self) -> None:
        """A trainer (and snapshot writer) from the init, at round 0."""
        from fed_tgan_torch.train.federated import FederatedTrainer
        from fed_tgan_torch.train.snapshots import (
            SnapshotWriter,
            result_path_fn,
        )

        self.close()
        args = self.args
        self.trainer = FederatedTrainer(
            self.init, self.cfg, seed=args.seed,
            min_clients=args.min_clients or 1,
            quarantine_strikes=args.quarantine_strikes, device=self.device,
            decode=args.decode, capacity=args.elastic_capacity)
        self.writer = None
        if args.sample_every:
            self.path_fn = result_path_fn(self.out_dir, self.name)
            self.writer = SnapshotWriter(
                self.init.global_meta, self.init.encoders, self.path_fn,
                rows=args.sample_rows, seed=args.seed,
                fmt=args.snapshot_format or "csv")
        self.metrics: list = []   # per round: (P, 3) loss_d, pen, loss_g
        self.nonfinite = 0

    # ------------------------------------------------------------ rounds
    def _record(self, first: int, host: dict) -> None:
        m = np.stack([host["loss_d"], host["pen"], host["loss_g"]], axis=2)
        for r in range(m.shape[0]):
            self.metrics.append(m[r])
            self.nonfinite += int(not np.isfinite(m[r]).all())

    def fit(self, rounds: int) -> None:
        """``rounds`` rounds through ``FederatedTrainer.fit``, in the
        traffic's chunks, with the snapshot hook on its rounds."""
        t = self.trainer
        start, every = t.completed_epochs, self.args.sample_every
        due = [e for e in range(start, start + rounds)
               if every and e % every == 0]
        t.fit(rounds, log_every=0,
              sample_hook=self.writer if due else None, hook_epochs=due,
              health_cb=self._record,
              max_rounds_per_call=self.args.rounds_per_program)

    def chunk(self) -> None:
        self.fit(self.args.rounds_per_program)

    @property
    def steps_per_round(self) -> int:
        return int(np.sum(self.trainer.steps))

    # ----------------------------------------------------- what is judged
    def shared(self) -> dict:
        """The aggregated leaves as one client holds them (slot 0)."""
        G = self.trainer.stack.generator
        D = self.trainer.stack.discriminator
        out = {f"G.{k}": v[0] for k, v in G.leaves().items()}
        out.update({f"D.{k}": v[0] for k, v in D.leaves().items()})
        for j, h in enumerate(G.widths):
            mean, var = G.running(j)
            out[f"G.blocks.{j}.bn.running_mean"] = mean.view(G.n, h)[0]
            out[f"G.blocks.{j}.bn.running_var"] = var.view(G.n, h)[0]
        return {k: v.detach().clone() for k, v in out.items()}

    def moment_norms(self) -> dict:
        """``{leaf: (P,) norms}`` of Adam's first moment, per client."""
        out = {}
        stack = self.trainer.stack
        for tag, module, opt in (("G", stack.generator, stack.opt_g),
                                 ("D", stack.discriminator, stack.opt_d)):
            parts = opt.exp_avg.split(module.sizes, dim=1)
            for (name, _), part in zip(module.shapes, parts):
                out[f"{tag}.{name}"] = torch.linalg.vector_norm(
                    part, dim=1).cpu().numpy()
        return out

    def first_rounds(self, rounds: int) -> dict:
        """The first ``rounds`` rounds, read for the check: Adam's first
        moments after round 1 and each leaf's change after the last."""
        start = self.shared()
        self.fit(1)
        moments = self.moment_norms()
        self.fit(rounds - 1)
        now = self.shared()
        return {"moments": moments, "change": {
            k: float(torch.linalg.vector_norm(now[k] - start[k]))
            for k in start}}

    def readings(self, rounds: int) -> dict:
        """What the check compares, once the first rounds' snapshot (if
        any) is written: their losses, and the snapshot file's cells."""
        from benchmark.check import SNAPSHOT_ROUND, read_snapshot

        out = {"metrics": self.metrics[:rounds]}
        if self.writer is not None:
            self.drain()
            out["snapshot"] = read_snapshot(self.path_fn(SNAPSHOT_ROUND))
        return out

    def drain(self) -> None:
        if self.writer is not None:
            self.writer.drain()

    def remove_snapshots(self, keep: set, upto: int) -> None:
        """Delete the snapshot files of rounds before ``upto`` (written:
        at most two are in flight), except ``keep``."""
        if self.writer is None:
            return
        for e in range(max(0, upto - 64), upto):
            path = self.path_fn(e)
            if e not in keep and os.path.exists(path):
                os.remove(path)

    def close(self) -> None:
        if getattr(self, "writer", None) is not None:
            self.writer.close()
