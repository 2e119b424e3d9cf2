"""The training CLI of the port
(counterpart of ``fed_tgan_tpu/cli.py:743-1013`` and ``_run_training``,
``:1125-1402``, restricted to what is ported).

    python -m fed_tgan_torch --mode fedavg --datapath T.csv --dataset intrusion
        --n-clients 4 -epochs 3 --sample-every 1 --sample-rows 40000
        --eval --save-model --out-dir OUT [--device cuda|cpu]

takes the JAX CLI's flags (``--device`` picks the card, the default, or
the CPU; ``--backend gpu|cpu`` is its JAX spelling, and
``--n-virtual-devices`` is ignored: every client is stacked on one
device).  On the card every process first probes CUDA in a subprocess
and initializes it under a watchdog (:mod:`fed_tgan_torch.runtime.
backend`); a failure exits 3 with the reason, and nothing falls back to
the CPU.  A run writes the JAX CLI's layout:

- ``<out>/<name>_result/<name>_synthesis_epoch_<e>.csv`` per snapshot
  round (``<name>_synthesis_standalone.csv`` in ``--mode standalone``);
- ``<out>/timestamp_experiment.csv`` and ``timing_phases.csv``;
- ``<out>/models/<name>.json`` (harmonized meta),
  ``label_encoders_<name>.json`` and, with ``--save-model``, the port
  artifact ``synthesizer_torch/`` that ``serve`` loads, with the
  training table's reference statistics ``reference_stats_<name>.json``
  that ``serve --promote canary`` scores new generations against;
- ``--date-format col=FORMAT ...`` splits each date column into
  categorical parts for training and rejoins it in every written CSV;
- ``--precision bf16`` trains (either mode) in bf16 with float32 islands,
  and the saved artifact serves in bf16;
- with ``--monitor-every K``, ``<out>/monitor_similarity.csv`` (appended
  to on ``--resume``);
- with ``--save-every K``, crash-safe training checkpoints in
  ``--ckpt-dir`` (default ``<out>/checkpoint``), ``--ckpt-keep``
  generations rotated to ``<dir>.1`` ...; ``--resume`` continues the
  newest valid one, ``--epochs`` counting total rounds;
- ``--watchdog`` rolls back to the last good checkpoint on a loss
  explosion or a similarity regression; ``--faults SPEC`` installs a
  fault plan (``fed_tgan_torch.testing.faults``);
- ``--similarity sketch`` scores the init's WD on the device from the
  mixtures' CDFs; ``--init-cache DIR`` restores or stores the init's
  content-hashed fits and state;
- ``--elastic-capacity N`` pads the trainer to N slots; a plan with
  ``join:``, ``leave:`` or ``drift:`` faults runs the rounds through the
  elastic federation (``fed_tgan_torch.federation.elastic``), newcomers
  drawn from the input table;
- ``--population N --cohort C`` trains and aggregates C sampled clients
  a round; ``--aggregation buffered`` lands a scripted straggler's delta
  (``--faults straggle:rank=R,delay=D``) later, discounted;
  ``--ema-decay d`` samples, monitors and saves the debiased EMA of the
  aggregated generator; ``--rounds-per-program K`` runs hook-free
  stretches in chunks of K rounds with one host copy each;
- ``--mode mdgan`` trains one shared generator against a discriminator
  per client (``fed_tgan_torch.train.mdgan``);
- the reference's ``-rank``/``-world_size``/``-ip``/``-port``: without
  ``-ip`` one process runs every client (``-world_size W`` means ``W - 1``
  clients, a rank other than 0 has nothing to do); ``-date_dic`` is
  ``--date-format``;
- with ``-ip`` the reference's multi-process launch: ``-rank 0
  -world_size N+1`` is the server (the init protocol over the port's
  transport on ``-port``, then the snapshot CSVs, timing files and the
  cross-rank equality check), ``-rank r -datapath shard_r.csv`` a
  participant that trains client r - 1 and aggregates through
  ``torch.distributed`` on ``-port`` + 1 (:mod:`fed_tgan_torch.train.
  multihost`); ``--init-only`` stops after the init protocol,
  ``--params-out DIR`` writes each participant's final generator as
  ``params_rank<r>.pt``, ``--save-every``/``--resume`` keep and continue
  per-rank checkpoints;
- ``--journal PATH`` writes the run journal (JSONL, the JAX package's
  schema; ``python -m fed_tgan_torch.obs report|slo|watch`` read it);
  ``--obs-port P`` serves ``/metrics``, ``/healthz`` and ``/journal`` from
  inside the run (0 picks a free port; a journal at
  ``<out>/journal.jsonl`` unless ``--journal`` names one); with ``-ip``
  rank r journals to ``<root>_rank<r><ext>`` and binds P + r;
  ``--profile-dir DIR`` traces the last ``--profile-rounds`` rounds with
  ``torch.profiler`` into ``DIR`` (host spans beside the kernels);
- ``--sanitize`` runs the rounds under the sanitizers
  (:mod:`fed_tgan_torch.analysis.sanitizers`): the steady round chunk
  under the sync guard, deterministic algorithms, the builds counted,
  and at the end their report and the training budget (exit 4 on a
  violation); ``--sanitize-nans`` adds the NaN guard.

- ``--bgm-backend sklearn`` fits the mixtures on the host with sklearn's
  ``BayesianGaussianMixture`` (the reference-exact fit); everything after
  the fit runs on ``--device``;
- ``--snapshot-format feather|parquet`` writes each snapshot as an Arrow
  table (``.feather``, ``.parquet``) instead of a CSV.

Every flag of the JAX CLI is ported.  A flag whose host library (sklearn,
pyarrow) does not import exits with code 2 naming the library, before the
backend probe and before any CUDA work; nothing falls back to another
path.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

# flag -> (argparse keywords, ROADMAP item); a value other than the
# default is refused with exit code 2.  Empty: every flag is ported
NOT_PORTED: dict = {}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m fed_tgan_torch",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("-datapath", "--datapath", type=str,
                   default="data/raw/Intrusion_train.csv")
    p.add_argument("--client-data", type=str, nargs="*", default=None,
                   help="per-client CSVs; overrides --datapath sharding")
    p.add_argument("--dataset", type=str, default="intrusion",
                   help="schema preset: intrusion|adult|covertype|custom")
    p.add_argument("-selected_variables", "--selected", type=str, nargs="*",
                   default=None)
    p.add_argument("-categorical_list", "--categorical", type=str, nargs="*",
                   default=None, dest="categorical")
    p.add_argument("-nonnegative_list", "--non-negative", type=str,
                   nargs="*", default=None, dest="non_negative")
    p.add_argument("-target_column", "--target-column", type=str,
                   default=None, dest="target_column")
    p.add_argument("-problem_type", "--problem-type", type=str, default=None,
                   dest="problem_type")
    p.add_argument("-name", "--name", type=str, default=None)
    p.add_argument("-epochs", "--epochs", type=int, default=10)
    p.add_argument("-E_interval", "--e-interval", type=int, default=None,
                   dest="e_interval",
                   help="accepted and ignored, as the reference does")
    p.add_argument("-report", "--report", action="store_true",
                   help="accepted and ignored, as the reference does")
    p.add_argument("--n-clients", type=int, default=None)
    p.add_argument("--population", type=int, default=None,
                   help="the resident client population N (an alias of "
                        "--n-clients, named for cohort runs)")
    p.add_argument("--cohort", type=int, default=0,
                   help="clients sampled per round (C): each round trains "
                        "and aggregates C of the N resident clients, drawn "
                        "from (seed, round), with the similarity weights "
                        "renormalized over the cohort.  0 (default) or "
                        "C = N = full participation")
    p.add_argument("--aggregation", type=str, default="sync",
                   choices=["sync", "buffered"],
                   help="sync = every participant's update lands in its own "
                        "round (default).  buffered = scripted stragglers "
                        "(--faults straggle:rank=R,delay=D) leave the "
                        "round's barrier and their deltas land D rounds "
                        "later, discounted by 0.5^staleness; with no "
                        "straggler, bit-identical to sync")
    p.add_argument("--shard-strategy", type=str, default="iid",
                   choices=["iid", "contiguous", "label_sorted", "dirichlet"])
    p.add_argument("--alpha", type=float, default=0.5, help="dirichlet skew")
    p.add_argument("--allow-zero-step-clients", action="store_true")
    p.add_argument("--uniform", action="store_true",
                   help="uniform FedAvg instead of similarity-weighted")
    p.add_argument("--mode", type=str, default="fedavg",
                   choices=["fedavg", "mdgan", "standalone"])
    p.add_argument("--bgm-backend", type=str, default="jax",
                   choices=["sklearn", "jax"],
                   help="the mixture fit of the init: jax (default) = the "
                        "batched variational fit, here in torch on the "
                        "device; sklearn = the reference-exact fit, one "
                        "sklearn BayesianGaussianMixture a column on the "
                        "host (needs sklearn; the rest of the run stays on "
                        "--device)")
    p.add_argument("--similarity", type=str, default="exact",
                   choices=["exact", "sketch"],
                   help="init similarity: exact = the reference's sampled "
                        "WD over every client; sketch = the mixtures' CDF "
                        "distance on the device and a budgeted pooled refit")
    p.add_argument("--init-cache", type=str, default=None, metavar="DIR",
                   help="content-hashed init cache: client fits and the "
                        "whole harmonized state keyed on shard "
                        "fingerprints; a warm run restores bit-identical "
                        "encoded output without refitting")
    p.add_argument("--elastic-capacity", type=int, default=0,
                   help="trainer slots for elastic membership (join:, "
                        "leave:, drift: faults); newcomers land in padded "
                        "slots, grown to a power of two on overflow; 0 = "
                        "the population exactly")
    p.add_argument("--drift-every", type=int, default=5,
                   help="rounds between the elastic federation's drift "
                        "windows under a churn plan (DriftConfig."
                        "detect_every; 0 = no windows); the JAX CLI has "
                        "no flag and uses the default 5")
    p.add_argument("--backend", type=str, default=None,
                   metavar="{cpu,gpu}",
                   help="the JAX CLI's platform flag: cpu or gpu map onto "
                        "--device cpu|cuda; tpu and plugin:<name> are "
                        "refused")
    p.add_argument("--n-virtual-devices", type=int, default=None,
                   help="accepted and ignored: every client is stacked on "
                        "one device")
    p.add_argument("--batch-size", type=int, default=500)
    p.add_argument("--embedding-dim", type=int, default=128)
    p.add_argument("--lr-schedule", choices=["constant", "cosine", "linear"],
                   default="constant")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="per-round EMA of the aggregated generator (fedavg "
                        "mode); snapshots, the monitor and saved models use "
                        "the debiased EMA.  0 = off (the reference)")
    p.add_argument("--rounds-per-program", type=int, default=1,
                   help="rounds per chunk: a hook-free stretch of K rounds "
                        "is queued on the device back to back with one "
                        "copy of its results to the host; bit-identical to "
                        "K chunks of one round.  Hook rounds (--sample-every"
                        "/--save-every/--monitor-every) end a chunk")
    p.add_argument("--sample-rows", type=int, default=40000)
    p.add_argument("--sample-every", type=int, default=1,
                   help="rounds between snapshots; 0 = only at the end")
    p.add_argument("--decode", choices=["exact", "packed16", "packed8"],
                   default=None, help="snapshot layout (default packed8)")
    p.add_argument("--out-dir", type=str, default=".")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-clients", type=int, default=None)
    p.add_argument("--aggregator", type=str, default="weighted",
                   choices=["weighted", "clipped", "trimmed", "median"])
    p.add_argument("--no-update-gate", action="store_true")
    p.add_argument("--gate-norm-factor", type=float, default=10.0)
    p.add_argument("--update-clip", type=float, default=3.0)
    p.add_argument("--trim-ratio", type=float, default=0.2)
    p.add_argument("--quarantine-strikes", type=int, default=3)
    p.add_argument("--save-model", action="store_true",
                   help="write the port artifact to <out>/models")
    p.add_argument("--eval", action="store_true",
                   help="Avg_JSD/Avg_WD of the last snapshot against the "
                        "training data")
    p.add_argument("--monitor-every", type=int, default=0,
                   help="rounds between on-device Avg_JSD/Avg_WD probes "
                        "(0 = off); written to <out>/monitor_similarity.csv")
    p.add_argument("--save-every", type=int, default=0,
                   help="rounds between full-resume checkpoints; 0 = none")
    p.add_argument("--ckpt-dir", type=str, default=None,
                   help="checkpoint directory (default <out>/checkpoint)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --ckpt-dir; --epochs counts total rounds")
    p.add_argument("--ckpt-keep", type=int, default=1,
                   help="checkpoint generations to retain (<dir>, <dir>.1, "
                        "...); --resume picks the newest valid one")
    p.add_argument("--watchdog", action="store_true",
                   help="on a loss explosion/NaN or a sustained similarity "
                        "regression, roll back to the last good checkpoint "
                        "(--save-every), re-anneal the lr, retry "
                        "--watchdog-max-rollbacks times, then abort")
    p.add_argument("--watchdog-loss-threshold", type=float, default=100.0,
                   help="|loss| above this counts as an explosion")
    p.add_argument("--watchdog-similarity-factor", type=float, default=2.0,
                   help="monitor reads worse than this factor x the best "
                        "Avg_JSD count as regression (needs --monitor-every)")
    p.add_argument("--watchdog-patience", type=int, default=3,
                   help="consecutive regressed monitor reads before alarm")
    p.add_argument("--watchdog-max-rollbacks", type=int, default=2,
                   help="rollbacks before the run aborts")
    p.add_argument("--watchdog-lr-reanneal", type=float, default=0.5,
                   help="learning-rate multiplier applied on each rollback")
    p.add_argument("-date_dic", "--date-format", type=str, nargs="*",
                   default=None,
                   dest="date_format", metavar="COL=FORMAT",
                   help="date columns and their formats, e.g. "
                        "when=YYYY-MM-DD stamp=yymmdd|YYYY-MM-DD")
    p.add_argument("--faults", type=str, default=None, metavar="SPEC",
                   help="fault-injection plan, e.g. 'kill_client:rank=3,"
                        "round=2;crash_checkpoint:save=2' (also read from "
                        "FED_TGAN_TORCH_FAULTS)")
    p.add_argument("--precision", type=str, default="f32",
                   choices=("f32", "bf16"),
                   help="f32 (default) or bf16: generator and discriminator "
                        "in bfloat16 with float32 islands (batch norm, the "
                        "gradient penalty's norm, the loss means, the Gumbel "
                        "logits, decode) and a bf16 aggregation step; master "
                        "weights and Adam state stay float32.  A resumed "
                        "run keeps its checkpoint's precision")
    p.add_argument("--init-only", action="store_true",
                   help="multi-process launch (-ip): stop after the init "
                        "protocol")
    p.add_argument("--params-out", type=str, default=None, metavar="DIR",
                   help="multi-process launch (-ip): each participant "
                        "writes its final generator to "
                        "DIR/params_rank<r>.pt")
    p.add_argument("--journal", type=str, default=None, metavar="PATH",
                   help="write a run journal (JSONL event stream) to PATH "
                        "(default with --obs-port: <out-dir>/journal.jsonl, "
                        "suffixed _rank<r> in a -ip launch); read it with "
                        "`python -m fed_tgan_torch.obs report|slo|watch`")
    p.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                   help="serve live telemetry from inside the run: /metrics "
                        "(Prometheus), /healthz (round progress, watchdog, "
                        "quarantine census), /journal (NDJSON, ?follow=1 "
                        "tails).  0 picks a free port.  Implies a journal; "
                        "in a -ip launch rank r binds PORT+r")
    p.add_argument("--profile-dir", type=str, default=None, metavar="DIR",
                   help="trace the LAST --profile-rounds training rounds with "
                        "torch.profiler (CPU and CUDA) into DIR: the kernels "
                        "and the host phases on one timeline")
    p.add_argument("--profile-rounds", type=int, default=3,
                   help="rounds inside the --profile-dir trace (the run's "
                        "steady-state tail; default 3)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    # the reference's world bookkeeping: without -ip, one process runs
    # every client (-world_size W means W - 1 clients)
    p.add_argument("-rank", "--rank", type=int, default=None)
    p.add_argument("-world_size", "--world_size", type=int, default=None)
    p.add_argument("-ip", "--ip", type=str, default=None)
    p.add_argument("-port", "--port", type=int, default=None)
    p.add_argument("--sanitize", action="store_true",
                   help="runtime sanitizers: a sync guard on the steady "
                        "round chunk (an unsanctioned synchronising CUDA "
                        "call raises), a build budget, deterministic "
                        "algorithms; a report at the end, exit 4 on a "
                        "budget violation")
    p.add_argument("--sanitize-nans", action="store_true",
                   help="--sanitize plus the NaN guard: every aten op's "
                        "floating outputs and the kernels' outputs checked, "
                        "FloatingPointError naming the op at the first NaN")
    p.add_argument("--snapshot-format", default=None,
                   choices=["csv", "feather", "parquet"],
                   help="snapshot file format: csv (default, what the "
                        "offline evaluation reads) or an Arrow table, "
                        "feather or parquet, with typed columns and nulls "
                        "for missing cells (needs pyarrow)")
    for flag, (kw, item) in NOT_PORTED.items():
        p.add_argument(flag, **kw, help=f"not ported yet (ROADMAP {item})")
    return p


# flag value -> the host library it needs
HOST_LIBRARIES = {("bgm_backend", "sklearn"): "sklearn",
                  ("snapshot_format", "feather"): "pyarrow",
                  ("snapshot_format", "parquet"): "pyarrow"}


def _refused(args, parser) -> str | None:
    """Why the run cannot start, as a message: a flag whose host library
    does not import here, a platform the port does not run on, or a flag
    of a feature not ported yet."""
    import importlib.util

    for (dest, value), lib in HOST_LIBRARIES.items():
        if getattr(args, dest) == value and importlib.util.find_spec(
                lib) is None:
            flag = "--" + dest.replace("_", "-")
            return f"{flag} {value} needs {lib}, which is not installed here"
    from fed_tgan_torch.runtime.backend import parse_backend

    try:
        parse_backend(args.backend)
    except ValueError as exc:  # tpu and plugin:<name> name the flags
        return str(exc)
    for flag, (kw, item) in NOT_PORTED.items():
        dest = flag.lstrip("-").replace("-", "_")
        if getattr(args, dest) != parser.get_default(dest):
            return f"{flag} is not ported yet (ROADMAP {item})"
    return None


def _parse_date_formats(items) -> dict:
    """``['when=YYYY-MM-DD', ...]`` -> ``{'when': 'YYYY-MM-DD'}``
    (``fed_tgan_tpu/cli.py:553-562``); a malformed entry exits."""
    out = {}
    for item in items or []:
        col, sep, fmt = item.partition("=")
        if not sep or not col or not fmt:
            raise SystemExit(f"--date-format entries must be col=FORMAT, "
                             f"got {item!r}")
        out[col] = fmt
    return out


def _eval_categorical_columns(kwargs) -> list:
    """The columns ``--eval`` scores with JSD: the categorical ones and
    the date columns, which decode to dates, not numbers."""
    return list(kwargs["categorical_columns"]) + [
        c for c in kwargs.get("date_formats", {})
        if c not in kwargs["categorical_columns"]]


def _dataset_kwargs(args):
    """``(run name, TablePreprocessor kwargs)``; ``(None, None)`` for an
    unknown preset."""
    from fed_tgan_torch.datasets import PRESETS, preprocessor_kwargs

    if args.dataset == "custom":
        kwargs = dict(
            categorical_columns=args.categorical or [],
            non_negative_columns=args.non_negative or [],
            date_formats=_parse_date_formats(args.date_format),
            target_column=args.target_column or "",
            problem_type=args.problem_type or "",
            selected_columns=args.selected or None)
        name = args.name or os.path.basename(args.datapath).rsplit(".", 1)[0]
        return name, kwargs
    if args.dataset not in PRESETS:
        print(f"unknown dataset preset {args.dataset!r}; use "
              f"{sorted(PRESETS)} or 'custom'")
        return None, None
    preset = PRESETS[args.dataset]
    kwargs = preprocessor_kwargs(preset)
    for flag, kw in (("categorical", "categorical_columns"),
                     ("non_negative", "non_negative_columns"),
                     ("target_column", "target_column"),
                     ("problem_type", "problem_type")):
        if getattr(args, flag) is not None:
            kwargs[kw] = getattr(args, flag)
    if args.selected is not None:
        kwargs["selected_columns"] = args.selected or None
    if args.date_format is not None:
        kwargs["date_formats"] = _parse_date_formats(args.date_format)
    return args.name or preset.name, kwargs


def _write_meta(models_dir: str, name: str, meta, encoders) -> None:
    """The harmonized meta and the encoders (the port's JSON format)."""
    import json

    os.makedirs(models_dir, exist_ok=True)
    meta.dump_json(os.path.join(models_dir, f"{name}.json"))
    with open(os.path.join(models_dir, f"label_encoders_{name}.json"),
              "w") as f:
        json.dump([{"column_name": c, **e.to_dict()} for c, e in
                   zip(meta.categorical_columns, encoders)], f)


def _save_model(out_dir: str, name: str, synth, meta, encoders,
                tables=None) -> None:
    """The artifact: meta and encoders, the synthesizer last, then the
    reference statistics of the training ``tables`` (their columns of the
    meta, every client's rows; ``fed_tgan_tpu/cli.py:1103-1112,
    1345-1360``), which ``serve --promote canary`` scores against."""
    from fed_tgan_torch.runtime.checkpoint import SYNTH_DIR, save_synthesizer
    from fed_tgan_torch.serve.canary import (
        compute_reference_stats,
        reference_stats_path,
        write_reference_stats,
    )

    models_dir = os.path.join(out_dir, "models")
    _write_meta(models_dir, name, meta, encoders)  # synthesizer last
    save_synthesizer(synth, os.path.join(models_dir, SYNTH_DIR))
    if tables is None:
        return  # a resumed run without its data: the gate derives them
    real = {c: np.concatenate([t[c] for t in tables])
            for c in meta.column_names if c in tables[0]}
    stats = compute_reference_stats(
        real, meta.categorical_columns, name=name,
        probe_rows=min(64, len(next(iter(real.values()))) if real else 0))
    write_reference_stats(stats, reference_stats_path(models_dir, name))


def _evaluate(real_tables: list, fake: dict, categorical) -> None:
    from fed_tgan_torch.eval.similarity import statistical_similarity

    real = {c: np.concatenate([t[c] for t in real_tables]) for c in fake}
    avg_jsd, avg_wd, _ = statistical_similarity(real, fake, categorical)
    print(f"final Avg_JSD={avg_jsd:.4f} Avg_WD={avg_wd:.4f}")


@contextlib.contextmanager
def _observability(args):
    """The opt-in observability plane around a run
    (``fed_tgan_tpu/cli.py:694-740``): ``--journal PATH`` installs the
    process journal; ``--obs-port`` also starts the exporter (and implies
    a journal at ``<out-dir>/journal.jsonl``).  In a ``-ip`` launch each
    rank is its own process: rank r writes ``<root>_rank<r><ext>`` and
    binds PORT + r, and ``obs report <root>_rank*.jsonl`` merges them.
    Everything drains in ``finally``, so a ``/journal?follow=1`` tail
    sees the whole stream even when the run fails."""
    jpath = args.journal
    if jpath is None and args.obs_port is not None:
        jpath = os.path.join(args.out_dir, "journal.jsonl")
    rank = args.rank
    if jpath is not None and rank is not None and args.ip:
        root, ext = os.path.splitext(jpath)
        jpath = f"{root}_rank{rank}{ext or '.jsonl'}"
    journal = exporter = prev = None
    try:
        if jpath is not None:
            from fed_tgan_torch.obs.journal import RunJournal, set_journal

            journal = RunJournal(jpath)
            prev = set_journal(journal)
        if args.obs_port is not None:
            from fed_tgan_torch.obs.exporter import TelemetryExporter, get_health

            port = args.obs_port
            if port and rank is not None and args.ip:
                port += rank
            get_health().update(status="starting")
            exporter = TelemetryExporter(port=port).start()
            if not args.quiet:
                print(f"obs: live telemetry on {exporter.url} "
                      f"(/metrics /healthz /journal); journal -> {jpath}",
                      flush=True)
        yield
    finally:
        if exporter is not None:
            from fed_tgan_torch.obs.exporter import get_health

            get_health().update(status="finished")
            exporter.shutdown()
        if journal is not None:
            from fed_tgan_torch.obs.journal import set_journal

            set_journal(prev)  # a caller's journal, if it had one
            journal.close()


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.batch_size <= 0 or args.batch_size % 10:
        parser.error(f"--batch-size {args.batch_size}: must be a positive "
                     "multiple of pac=10 (the discriminator packs rows in "
                     "groups of 10)")
    _check_round_flags(args, parser)
    refused = _refused(args, parser) or _install_faults(args.faults)
    if refused:
        print(f"error: {refused}", file=sys.stderr)
        return 2
    if not (args.sanitize or args.sanitize_nans):
        return _launch(args)
    from fed_tgan_torch.analysis import sanitizers

    # before any CUDA work: cuBLAS reads its workspace setting once
    sanitizers.prepare_process()
    sanitizers.enable_sanitizers(nan_debug=args.sanitize_nans)
    try:
        return _launch(args)
    finally:
        sanitizers.disable_sanitizers()


def _pick_platform(args, who: str = "") -> int:
    """The platform policy of every launch path (counterpart of
    ``fed_tgan_tpu/cli.py::_pick_platform``): the CPU only when asked for
    (no probe); otherwise the card is probed in a subprocess (cached) and
    then initialized here under a watchdog.  A failed probe or touch
    exits 3 with the reason: the port never falls back to the CPU on its
    own (JAX's auto mode does, with a warning).  ``who`` prefixes the
    message (``"rank 2: "``)."""
    from fed_tgan_torch.runtime import backend

    if args.device == "cpu" or backend.backend_initialized():
        return 0
    card = backend.get_backend("gpu")
    health = card.probe()
    if health.ok:
        # a positive probe can be a cached stamp older than a fresh hang:
        # touch CUDA now, so a hang aborts with the probe's diagnosis
        health = card.touch(timeout_s=180.0, who=who)
        if health.ok:
            return 0
    hint = ("fix the card or relaunch every rank with --backend cpu" if who
            else "retry later or use --backend cpu")
    print(f"{who}CUDA backend unusable ({health.reason}); aborting -- "
          f"{hint}", flush=True)
    return 3


def _launch(args) -> int:
    """The multi-process launch, or this process's run."""
    if args.backend is not None:
        from fed_tgan_torch.runtime.backend import get_backend

        args.device = get_backend(args.backend).device
    if args.rank is not None and args.ip and (args.rank > 0
                                              or args.world_size):
        # the reference's multi-process launch: rank 0 is the server,
        # ranks 1..N the participants; each journals before its init
        rc = _pick_platform(args, who=f"rank {args.rank}: ")
        if rc:
            return rc
        with _observability(args):
            return _run_multihost(args)
    if args.rank == 0 and args.ip and not args.world_size:
        print("multihost rank 0 needs -world_size (how many clients to wait "
              "for)")
        return 2
    if args.rank is not None and args.rank != 0:
        print("fed_tgan_torch runs every client in one process; rank "
              f"{args.rank} has no separate process to start. Launch only "
              "rank 0 (or omit -rank).")
        return 0
    rc = _pick_platform(args)
    if rc:
        return rc
    if args.n_clients is None and args.world_size:
        args.n_clients = args.world_size - 1
    with _observability(args):
        return _run(args)


def _run(args) -> int:
    """One process's run: resume, standalone or the federated run."""
    from fed_tgan_torch.data.csvio import read_csv
    from fed_tgan_torch.data.sharding import shard_table
    from fed_tgan_torch.device import resolve_device
    from fed_tgan_torch.train.steps import TrainConfig, lr_decay_horizon

    device = resolve_device(args.device)
    name, kwargs = _dataset_kwargs(args)
    if name is None:
        return 2
    ckpt_dir = args.ckpt_dir or os.path.join(args.out_dir, "checkpoint")
    if args.resume:
        if args.mode == "standalone":
            print("error: --resume continues a --mode fedavg or mdgan "
                  "checkpoint", file=sys.stderr)
            return 2
        return _resume(args, name, kwargs, ckpt_dir, device)
    t_init = time.time()
    if args.client_data:
        tables = [read_csv(p) for p in args.client_data]
    else:
        table = read_csv(args.datapath)
        if args.mode == "standalone":
            tables = [table]
        else:
            label = kwargs.get("target_column") or None
            tables = shard_table(
                table, args.n_clients or 1, args.shard_strategy,
                label_column=(label if args.shard_strategy in
                              ("label_sorted", "dirichlet") else None),
                alpha=args.alpha, seed=args.seed)
    selected = kwargs.pop("selected_columns", None)
    columns = list(selected) if selected else list(tables[0])
    for i, t in enumerate(tables):
        missing = [c for c in columns if c not in t]
        if missing:
            print(f"client {i}: input is missing columns {missing}")
            return 2
    cfg = TrainConfig(
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
    if args.mode == "standalone":
        return _run_standalone(args, name, kwargs, tables, columns, cfg,
                               device)
    return _run_federated(args, name, kwargs, tables, columns, cfg, device,
                          t_init, ckpt_dir)


def _check_round_flags(args, parser) -> None:
    """The round-scale flags' parser errors, in JAX's words
    (``fed_tgan_tpu/cli.py:764-790``); ``--population`` becomes
    ``--n-clients``."""
    if not 0.0 <= args.ema_decay < 1.0:
        parser.error(f"--ema-decay {args.ema_decay}: must be in [0, 1)")
    if args.rounds_per_program < 1:
        parser.error(f"--rounds-per-program {args.rounds_per_program}: "
                     "must be >= 1")
    if args.ema_decay > 0 and args.mode != "fedavg":
        parser.error("--ema-decay is only supported in fedavg mode "
                     "(single-program or multi-process), not "
                     "mdgan/standalone")
    if args.population is not None:
        if args.n_clients is not None and args.n_clients != args.population:
            parser.error(f"--population {args.population} conflicts with "
                         f"--n-clients {args.n_clients} (they are aliases; "
                         "pass one)")
        args.n_clients = args.population
    if args.cohort < 0:
        parser.error(f"--cohort {args.cohort}: must be >= 0")
    multihost_launch = args.rank is not None and bool(args.ip)
    if args.cohort and (args.mode != "fedavg" or multihost_launch):
        parser.error("--cohort needs the in-process fedavg trainer (the "
                     "cohort is sampled across the packed client axis; the "
                     "multihost harness holds one client per process)")
    if args.aggregation == "buffered" and (args.mode != "fedavg"
                                           or multihost_launch):
        parser.error("--aggregation buffered needs the in-process fedavg "
                     "trainer (buffered deltas are re-applied by the host "
                     "training loop)")


def _install_faults(spec) -> str | None:
    """Install the ``--faults`` plan (and export it); the refusal message
    of a spec that does not parse or names a kind not ported yet."""
    if not spec:
        return None
    from fed_tgan_torch.testing.faults import ENV_VAR, FaultPlan, install_plan

    try:
        install_plan(FaultPlan.parse(spec))
    except (ValueError, NotImplementedError) as exc:
        return f"--faults: {exc}"
    os.environ[ENV_VAR] = spec
    return None


def _resume(args, name, kwargs, ckpt_dir, device) -> int:
    """``--resume``: the newest valid checkpoint generation under
    ``ckpt_dir``; its run name wins over the flags
    (``fed_tgan_tpu/cli.py:862-901``)."""
    from fed_tgan_torch.data.csvio import read_csv
    from fed_tgan_torch.runtime.checkpoint import find_resumable, load_federated

    src = find_resumable(ckpt_dir) or ckpt_dir
    trainer = load_federated(src, device=device)
    init = trainer.init
    name = trainer.run_name or name
    kwargs["categorical_columns"] = init.global_meta.categorical_columns
    kwargs["date_formats"] = dict(init.global_meta.date_info)
    tables = None
    if args.eval:
        try:
            tables = [read_csv(p) for p in
                      (args.client_data or [args.datapath])]
        except OSError as exc:
            print(f"--eval skipped: cannot reload training data ({exc}); "
                  "pass --datapath/--client-data to evaluate a resumed run")
    if not args.quiet:
        print(f"resumed from {src} at round {trainer.completed_epochs}")
    from fed_tgan_torch.testing.faults import active_plan

    plan = active_plan()
    if plan is not None and plan.has_churn():
        # raw client shards are not checkpointed, so the elastic layer
        # cannot rebuild its population view on a resumed run
        print("error: join:/leave:/drift: faults cannot drive a resumed "
              "run (raw client shards are not checkpointed); start a "
              "fresh run with --faults instead", file=sys.stderr)
        return 2
    return _run_training(args, name, kwargs, trainer, init, tables, ckpt_dir)


def _run_standalone(args, name, kwargs, tables, columns, cfg, device) -> int:
    """One participant, local mixtures, no federation
    (``fed_tgan_tpu/cli.py:1047-1122``)."""
    from fed_tgan_torch.data.csvio import write_csv
    from fed_tgan_torch.data.decode import decode_columns
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import harmonize_categories
    from fed_tgan_torch.train.standalone import StandaloneSynthesizer

    table = {c: np.concatenate([t[c] for t in tables]) for c in columns}
    pre = TablePreprocessor(table=table, name=name, selected_columns=columns,
                            **kwargs)
    meta_dict, encoders, _ = harmonize_categories([pre.local_meta()])
    matrix, cat_idx, ord_idx = pre.encode(encoders)
    synth = StandaloneSynthesizer(cfg, seed=args.seed, device=device,
                                  bgm_backend=args.bgm_backend)
    t0 = time.time()
    synth.fit(matrix, cat_idx, ord_idx, epochs=args.epochs)
    if not args.quiet:
        print(f"standalone fit: {args.epochs} epochs in "
              f"{time.time() - t0:.1f}s")
    meta = pre.global_table_meta(meta_dict)
    result_dir = os.path.join(args.out_dir, f"{name}_result")
    os.makedirs(result_dir, exist_ok=True)
    raw = decode_columns(synth.sample(args.sample_rows, seed=args.seed),
                         meta, encoders)
    out_csv = os.path.join(result_dir, f"{name}_synthesis_standalone.csv")
    write_csv(raw, out_csv)
    if not args.quiet:
        print(f"wrote {args.sample_rows} rows to {out_csv}")
    if args.save_model:
        _save_model(args.out_dir, name, synth.to_saved(), meta, encoders,
                    [table])
    if args.eval:
        _evaluate([table], raw, _eval_categorical_columns(kwargs))
    return _sanitize_report(args)


def _run_multihost(args) -> int:
    """The reference's multi-process launch (reference run(),
    Server/dtds/distributed.py:838-891; ``fed_tgan_tpu/cli.py:383-530``):
    rank 0 drives the init protocol over the port's transport and
    participants 1..N take part with their ``-datapath`` shard; then,
    unless ``--init-only``, every rank joins the process group and the
    participants train ``-epochs`` rounds, rank 0 owning the snapshot CSVs
    and the timing files."""
    from fed_tgan_torch.data.csvio import read_csv
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.device import resolve_device
    from fed_tgan_torch.federation.distributed import (
        client_initialize,
        server_initialize,
    )
    from fed_tgan_torch.parallel import multihost
    from fed_tgan_torch.runtime.transport import (
        ClientTransport,
        Deadlines,
        ServerTransport,
    )
    from fed_tgan_torch.train.multihost import (
        MultihostRun,
        client_train,
        server_train,
    )
    from fed_tgan_torch.train.steps import TrainConfig, lr_decay_horizon

    name, kwargs = _dataset_kwargs(args)
    if name is None:
        return 2
    port = args.port or 7788  # the reference's default port
    train_after = not args.init_only and args.epochs > 0
    deadlines = Deadlines.from_env()
    run = MultihostRun(
        epochs=args.epochs, sample_every=args.sample_every,
        sample_rows=args.sample_rows, seed=args.seed,
        log_every=0 if args.quiet else max(1, args.epochs // 10),
        save_every=args.save_every,
        ckpt_dir=args.ckpt_dir or os.path.join(args.out_dir, "checkpoint"),
        resume=args.resume, decode=args.decode or "packed8",
        snapshot_format=args.snapshot_format or "csv")

    def join(world_size: int, device) -> None:
        backend = multihost.initialize_multihost(
            args.ip, port, world_size, args.rank, device, deadlines.train_ms)
        if not args.quiet:
            print(f"rank {args.rank}: world of {world_size} processes, "
                  f"collective backend {backend}", flush=True)

    try:
        if args.rank == 0:
            device = resolve_device(args.device)
            with ServerTransport(port, args.world_size - 1,
                                 deadlines=deadlines) as t:
                t_init = time.time()
                out = server_initialize(
                    t, seed=args.seed, weighted=not args.uniform,
                    run_name=name, min_clients=args.min_clients,
                    device=device, similarity=args.similarity,
                    backend=args.bgm_backend)
                _write_meta(os.path.join(args.out_dir, "models"), name,
                            out["global_meta"], out["encoders"])
                print(f"multihost init complete: {args.world_size - 1} "
                      f"clients in {time.time() - t_init:.2f}s, weights="
                      f"{[float(w) for w in out['weights']]}", flush=True)
                if not train_after:
                    return 0
                join(args.world_size, device)
                t_train = time.time()
                books = server_train(t, out, run, name, out_dir=args.out_dir,
                                     quiet=args.quiet)
                wall = time.time() - t_train
                if not args.quiet:
                    times = books["epoch_times"]
                    n = max(len(times), 1)
                    print(f"{len(times)} rounds in {sum(times):.1f}s "
                          f"({sum(times) / n:.3f}s/round)")
                    print(f"multihost training wall {wall:.2f}s "
                          f"({wall / n:.3f}s/round incl. snapshots)")
            return 0
        device = multihost.participant_device(args.rank, args.device)
        table = read_csv(args.datapath)
        selected = kwargs.pop("selected_columns", None)
        columns = list(selected) if selected else list(table)
        missing = [c for c in columns if c not in table]
        if missing:
            print(f"rank {args.rank}: input is missing columns {missing}")
            return 2
        pre = TablePreprocessor(table=table, name=name,
                                selected_columns=columns, **kwargs)
        with ClientTransport(args.ip, port, args.rank,
                             deadlines=deadlines) as t:
            out = client_initialize(t, pre, seed=args.seed, device=device,
                                    backend=args.bgm_backend)
            # the server's run name wins, whatever the shard files are called
            name = out.get("run_name") or name
            print(f"rank {args.rank} ({name}) init complete: "
                  f"{out['matrix'].shape[0]} rows x {out['matrix'].shape[1]} "
                  "encoded dims", flush=True)
            if not train_after:
                return 0
            rows = [int(r) for r in out["rows_per_client"]]
            join(args.world_size or len(rows) + 1, device)
            cfg = TrainConfig(
                batch_size=args.batch_size, embedding_dim=args.embedding_dim,
                lr_schedule=args.lr_schedule,
                lr_decay_steps=lr_decay_horizon(args.lr_schedule, args.epochs,
                                                max(rows), args.batch_size),
                allow_zero_step_clients=args.allow_zero_step_clients,
                aggregator=args.aggregator,
                update_gate=not args.no_update_gate,
                gate_norm_factor=args.gate_norm_factor,
                update_clip=args.update_clip, trim_ratio=args.trim_ratio,
                precision=args.precision, ema_decay=args.ema_decay)
            res = client_train(t, out, cfg, run, device=device)
        if args.params_out:
            import torch

            os.makedirs(args.params_out, exist_ok=True)
            as_t = lambda st: None if st is None else {  # noqa: E731
                k: torch.from_numpy(v) for k, v in st.items()}
            torch.save({"generator": as_t(res["params_g"]),
                        "ema": as_t(res["ema"])},
                       os.path.join(args.params_out,
                                    f"params_rank{args.rank}.pt"))
        if not args.quiet:
            from fed_tgan_torch.ops.activate_cuda import (
                fused_activate_bwd,
                fused_apply_activate,
            )

            n = max(len(res["seconds"]), 1)
            mean = {k: sum(res[k]) / n for k in ("seconds", "local_s",
                                                 "gather_s", "snapshot_s")}
            # the kernels' launches in this process (0 on the CPU, where
            # the wrappers take the plain versions)
            print(f"rank {args.rank} training complete: "
                  f"{mean['seconds']!r}s/round (local steps "
                  f"{mean['local_s']!r}s, all-gather "
                  f"{1e3 * mean['gather_s']!r} ms, snapshot dispatch "
                  f"{mean['snapshot_s']!r}s); K1 launches "
                  f"{fused_apply_activate.launches}, K2 launches "
                  f"{fused_activate_bwd.launches}", flush=True)
        return 0
    finally:
        multihost.shutdown()


def draw_newcomer_rows(tables: list, count: int, shard_rows: int,
                       random_state: int) -> list:
    """``count`` newcomer tables drawn from the clients' raw ``tables``
    (``fed_tgan_tpu/cli.py:990-1001``): ``pd.concat(frames).sample(n,
    random_state=...)`` as pandas draws it, a ``RandomState`` choice
    without replacement, then the drawn rows dealt out ``i::count``."""
    pool = {c: np.concatenate([t[c] for t in tables]) for c in tables[0]}
    n_pool = len(next(iter(pool.values())))
    locs = np.random.RandomState(random_state).choice(
        n_pool, size=min(count * shard_rows, n_pool), replace=False)
    drawn = {c: v[locs] for c, v in pool.items()}
    return [{c: v[i::count] for c, v in drawn.items()} for i in range(count)]


def _run_federated(args, name, kwargs, tables, columns, cfg, device,
                   t_init, ckpt_dir) -> int:
    from fed_tgan_torch.data.ingest import TablePreprocessor
    from fed_tgan_torch.federation.init import federated_initialize
    from fed_tgan_torch.testing.faults import active_plan
    from fed_tgan_torch.train.federated import FederatedTrainer
    from fed_tgan_torch.train.mdgan import MDGANTrainer

    plan = active_plan()
    if plan is not None and plan.has_churn() and args.mode != "fedavg":
        print("error: join:/leave:/drift: faults drive the elastic "
              "membership layer, which needs --mode fedavg")
        return 2
    clients = [TablePreprocessor(table=t, name=name, selected_columns=columns,
                                 **kwargs) for t in tables]
    if not args.quiet:
        print(f"{len(clients)} clients, rows per shard: "
              f"{[c.n_rows for c in clients]}")
    init = federated_initialize(clients, seed=args.seed,
                                weighted=not args.uniform, device=device,
                                similarity=args.similarity,
                                cache=args.init_cache,
                                backend=args.bgm_backend)
    if args.mode == "mdgan":
        trainer = MDGANTrainer(init, cfg, seed=args.seed, device=device,
                               decode=args.decode)
    else:
        trainer = FederatedTrainer(
            init, cfg, seed=args.seed, min_clients=args.min_clients or 1,
            quarantine_strikes=args.quarantine_strikes, device=device,
            decode=args.decode, capacity=args.elastic_capacity)
    if not args.quiet:
        phases = ", ".join(f"{k} {v:.3f}s" for k, v in
                           {**init.timings, **trainer.timings}.items())
        print(f"init done in {time.time() - t_init:.1f}s ({phases}); "
              f"aggregation weights: {np.round(init.weights, 4).tolist()}")
    elastic = newcomer_factory = None
    if plan is not None and plan.has_churn():
        from fed_tgan_torch.federation.elastic import (
            DriftConfig,
            ElasticFederation,
        )
        from fed_tgan_torch.federation.streaming import OnboardingSession

        elastic = ElasticFederation(
            trainer, OnboardingSession(init, device=device), clients,
            config=DriftConfig(detect_every=args.drift_every))
        # newcomers are round-seeded draws from the input table, so a
        # rerun draws the same ones
        shard_rows = max(1, sum(c.n_rows for c in clients)
                         // max(len(clients), 1))

        def newcomer_factory(count, rnd):
            return [TablePreprocessor(table=t, name=name,
                                      selected_columns=columns, **kwargs)
                    for t in draw_newcomer_rows(
                        tables, count, shard_rows,
                        args.seed * 100003 + rnd)]

    return _run_training(args, name, kwargs, trainer, init, tables, ckpt_dir,
                         elastic=elastic, newcomer_factory=newcomer_factory)


def _run_training(args, name, kwargs, trainer, init, tables, ckpt_dir,
                  elastic=None, newcomer_factory=None) -> int:
    """The rounds and what follows them (``fed_tgan_tpu/cli.py:1125-1402``):
    per round the hook runs snapshot -> monitor -> watchdog read ->
    checkpoint, so a round the watchdog rejects is never saved.
    ``tables`` (the training data) is None on a resumed run without
    ``--eval``, which then runs no monitor and no evaluation.  With
    ``elastic`` (a churn plan) the elastic federation runs the rounds and
    the watchdog inside them."""
    from fed_tgan_torch.data.csvio import read_csv
    from fed_tgan_torch.runtime.checkpoint import save_federated
    from fed_tgan_torch.train.monitor import MonitorLog, SimilarityMonitor
    from fed_tgan_torch.train.snapshots import SnapshotWriter, result_path_fn
    from fed_tgan_torch.train.watchdog import (
        TrainingWatchdog,
        WatchdogConfig,
        fit_with_watchdog,
    )

    _write_meta(os.path.join(args.out_dir, "models"), name, init.global_meta,
                init.encoders)
    path_fn = result_path_fn(args.out_dir, name)
    fmt = args.snapshot_format or "csv"
    snapshot = SnapshotWriter(init.global_meta, init.encoders, path_fn,
                              rows=args.sample_rows, seed=args.seed, fmt=fmt)
    mon_log = MonitorLog(os.path.join(args.out_dir, "monitor_similarity.csv"))
    monitor = None
    if args.monitor_every:
        if tables is None:
            print("note: --monitor-every needs the training data (resumed run "
                  "without a readable --datapath); ignoring")
        else:
            real = {c: np.concatenate([t[c] for t in tables])
                    for c in tables[0]}
            monitor = SimilarityMonitor(init.global_meta, init.encoders, real,
                                        seed=args.seed, device=trainer.device)
    from fed_tgan_torch.train.mdgan import MDGANTrainer

    fused = not isinstance(trainer, MDGANTrainer)  # rounds in chunks
    watchdog = None
    if args.watchdog and not fused:
        print("note: --watchdog is not supported for this trainer; "
              "ignoring")
    elif args.watchdog:
        watchdog = TrainingWatchdog(WatchdogConfig(
            loss_threshold=args.watchdog_loss_threshold,
            similarity_factor=args.watchdog_similarity_factor,
            similarity_patience=args.watchdog_patience,
            max_rollbacks=args.watchdog_max_rollbacks,
            lr_reanneal=args.watchdog_lr_reanneal))
        if not args.save_every:
            print("note: --watchdog without --save-every has no "
                  "checkpoint to roll back to; an alarm aborts cleanly")

    def snapshot_due(e: int) -> bool:
        return bool(args.sample_every) and e % args.sample_every == 0

    def save_due(e: int) -> bool:
        return bool(args.save_every) and (e + 1) % args.save_every == 0

    def mon_due(e: int) -> bool:
        return monitor is not None and e % args.monitor_every == 0

    def hook(e, tr):
        if snapshot_due(e):
            snapshot(e, tr)
        if mon_due(e):
            m = monitor.evaluate(tr, seed=args.seed + e)
            mon_log.append(e, m["avg_jsd"], m["avg_wd"])
            if not args.quiet:
                print(f"round {e}: Avg_JSD={m['avg_jsd']:.4f} "
                      f"Avg_WD={m['avg_wd']:.4f} (on-device monitor)")
            if watchdog is not None:  # before the save: never persist it
                watchdog.observe_similarity(e, m["avg_jsd"])
        if save_due(e):
            save_federated(tr, ckpt_dir, run_name=name, keep=args.ckpt_keep)

    # --epochs is the total round budget; a resumed run does the rest
    start = trainer.completed_epochs
    remaining = max(0, args.epochs - start)
    due = [e for e in range(start, start + remaining)
           if snapshot_due(e) or save_due(e) or mon_due(e)]
    fit_kwargs = dict(log_every=0 if args.quiet else max(1, remaining // 10),
                      sample_hook=hook if due else None, hook_epochs=due)
    rpp = args.rounds_per_program
    if rpp > 1 and not fused:
        print("note: --rounds-per-program is not supported for this "
              "trainer; ignoring")
    elif fused:
        # a hook-free stretch of K rounds is one chunk; the hook rounds in
        # hook_epochs end chunks (fed_tgan_tpu/cli.py:1248-1270)
        fit_kwargs["max_rounds_per_call"] = rpp
        cadences = [c for c in (args.sample_every, args.save_every,
                                args.monitor_every) if c]
        if rpp > 1 and cadences and min(cadences) < rpp:
            print(f"note: hook cadence (every {min(cadences)} rounds) "
                  f"is below --rounds-per-program {rpp}; hooks force "
                  "program boundaries, capping the effective fusion")
    # --profile-dir traces the LAST profile_rounds rounds (the steady
    # state; fed_tgan_tpu/cli.py:1272-1330): the run is split in two fits,
    # which computes what one fit computes, bit for bit
    prof_n = (min(max(args.profile_rounds, 1), remaining)
              if args.profile_dir and remaining else 0)
    if elastic is not None:
        elastic.watchdog = watchdog
    with mon_log, snapshot:
        if remaining - prof_n:
            if elastic is not None:
                trainer = elastic.run(remaining - prof_n,
                                      fit_kwargs=fit_kwargs,
                                      ckpt_dir=ckpt_dir,
                                      newcomer_factory=newcomer_factory)
            elif watchdog is not None:
                trainer = fit_with_watchdog(trainer, remaining - prof_n,
                                            watchdog, ckpt_dir,
                                            fit_kwargs=fit_kwargs)
            else:
                trainer.fit(remaining - prof_n, **fit_kwargs)
        if prof_n:
            from fed_tgan_torch.runtime.profiling import device_trace

            # as in JAX: the elastic layer keeps its watchdog inside the
            # trace; otherwise the traced rounds are a plain fit
            with device_trace(args.profile_dir):
                if elastic is not None:
                    trainer = elastic.run(prof_n, fit_kwargs=fit_kwargs,
                                          ckpt_dir=ckpt_dir,
                                          newcomer_factory=newcomer_factory)
                else:
                    trainer.fit(prof_n, **fit_kwargs)
        last_epoch = trainer.completed_epochs - 1
        if not args.sample_every and last_epoch >= 0:
            snapshot(last_epoch, trainer)
        # a columnar run scores the last snapshot's decoded columns (the
        # CSV's cells); a CSV run reads its file back below
        last_columns = snapshot.drain() if fmt != "csv" else None
    if args.save_every and trainer.completed_epochs % args.save_every:
        save_federated(trainer, ckpt_dir, run_name=name, keep=args.ckpt_keep)
    if args.save_model:
        _save_model(args.out_dir, name, trainer.to_saved(), init.global_meta,
                    init.encoders, tables)
    trainer.write_timing(args.out_dir)
    if args.eval and tables is not None and last_epoch >= 0:
        last = ((last_epoch // args.sample_every) * args.sample_every
                if args.sample_every else last_epoch)
        fake = read_csv(path_fn(last)) if fmt == "csv" else last_columns
        if fake is None:
            print("--eval skipped: this run wrote no snapshot")
        else:
            _evaluate(tables, fake, _eval_categorical_columns(kwargs))
    if not args.quiet:
        total = sum(trainer.epoch_times)
        n = max(len(trainer.epoch_times), 1)
        print(f"{len(trainer.epoch_times)} rounds in {total:.1f}s "
              f"({total / n:.3f}s/round)")
    return _sanitize_report(args, trainer)


def _sanitize_report(args, trainer=None) -> int:
    """Under ``--sanitize``: the builds and syncs of the run, then the
    training budget (``fed_tgan_tpu/cli.py:1392-1397``); 4 on a
    violation."""
    from fed_tgan_torch.analysis import sanitizers

    if not sanitizers.sanitizing():
        return 0
    problems = (sanitizers.check_training_budget(trainer)
                if trainer is not None else [])
    return sanitizers.report_and_check(problems, quiet=args.quiet)
