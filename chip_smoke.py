#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fed_tgan_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed S] [--rows N]
    python3 chip_smoke.py --ab TREE

Phases, each fatal on failure:

1. build the fused activation kernels (``fed_tgan_torch/csrc/activate.cu``:
   K1 forward, K2 backward) with nvcc for sm_90a, and the host CSV
   formatter (``fed_tgan_torch/csrc/csvfmt.c``) with cc; then the backend
   probe (``backend_phase``, while the host is quiet): a fresh probe
   (``fed_tgan_torch/runtime/backend.py``, its stamp ignored) reports
   this card's count, name, compute capability and power limit (equal to
   ``nvidia-smi``'s line) and for 4 participants ``choose_backend``'s
   process group (gloo on one card); a second probe is the cached stamp;
   its ``backend_probe`` event passes the journal's validation;
   ``--backend tpu`` exits non-zero naming the flags; ``python -m
   fed_tgan_torch.doctor --wait-healthy --wait-timeout-min 2`` exits 0;
   the cold and cached probes in ms;
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
   (draws, generator, activation, decode and copy to the host, CSV), its
   CSV byte-equal to the stdlib writer's; then the fleet, slice 7's main
   path (``fleet_phase``): three Intrusion-layout tenants (two of equal
   weights) and one Adult-layout tenant at full width behind the asyncio
   front door (2 workers, a 5 ms coalesce window, a row pool); 16
   concurrent clients x 4 requests of N rows, every body equal to the
   tenant's single engine, fleet and single-model services in turns; K1
   launches in that run = lane dispatches + single dispatches + pool
   fills, and at least one dispatch of 4+ lanes; chunked == one-shot; a
   pool hit; a new generation published under fire (every response the
   old or the new bytes); a quota tenant's 429; a one-worker backlog (K1
   once per lane dispatch) and a drained shutdown; the stages of an
   8-lane dispatch; K1 against its plain version at the 8-lane shape;
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
   K1's and K2's share of it;
8a. canary promotion, slice 8's serving path (``canary_phase``): the
   trained model as an artifact with reference statistics of its
   training table, served by ``SamplingService(promote="canary",
   workers=2)``; a generation degraded by ``degrade_checkpoint(..., 100)``
   rejected (non-empty ``tripped`` and ``per_column``) while a client
   keeps asking, every response the incumbent's bytes, a ``utime`` not
   scored again, ``/metrics`` and ``/healthz`` showing the rejection; a
   clean republish (stream offset + 1000) promoted, its bytes those of an
   immediate-mode service of the same generation; two fleet tenants, one
   degraded and one clean, deciding apart with no lane group holding the
   rejected model; an artifact without statistics rejecting the degraded
   generation on statistics derived from the serving model; K1 launched
   exactly once per shadow sample (plus once per request served during a
   decision); the scorer on the card against the CPU (atol 1e-5) and its
   time, the shadow sample's time, seconds per decision;
8b. date columns (``dated_phase``): an Intrusion-shaped CSV with a
   ``YYYY-MM-DD`` and a ``yymmdd`` column (leap days, 2000-2009, blanks)
   trained by the CLI, run in this process (``--mode fedavg``, 2 clients,
   1 round, ``--date-format``, ``--save-model``; K1 and K2 launched
   ``max(steps) * (d_steps + 1) + chunks`` and ``max(steps)`` times,
   exactly); ``serve`` answers 5,000-row requests from the artifact (K1
   once per chunk); every date cell of the snapshot and of the response
   blank or valid as the JAX package writes it, the response equal to
   the card's encoded rows of the same request decoded on the CPU
   (stdlib writer); then K1 and K2 against their plain versions at the
   dated layout (a served chunk, a stacked training step);
9. the federated round, slice 3's main path, at its target configuration
   (a 20,000-row raw Intrusion-shaped CSV, 4 IID clients, ``TrainConfig()``
   defaults, the gated weighted aggregator, a 40,000-row packed8 snapshot
   after every round): ``python -m fed_tgan_torch --mode fedavg`` as a
   process of its own for 3 rounds with ``--eval --save-model`` (exit 0,
   3 snapshots of 40,000 rows with the right header), then ``serve``
   answers one request from the saved artifact;
10. the same configuration in this process, every client stacked (one
   step of all clients per local step index): init phases, 3 rounds with
   a snapshot each (K1 launched ``max(steps) * (d_steps + 1) + chunks``
   and K2 ``max(steps)`` times a round, exactly), seconds per round split
   into local steps, aggregation and snapshot dispatch, the writer
   thread's CSV time and what it costs the next round, the last
   snapshot's file (pinned copies, packed8 lookup tables) byte-equal to
   the stdlib writer's bytes of the same rows, then one round and its
   snapshot under ``torch.profiler`` (busy ms, device ops, K1/K2 share
   and launches, the launches held to the count above), then one round's
   local steps as the per-client loop the stacked round replaced and as
   the stacked round, in turns;
11. one round on the card against the same round on the CPU (injected
   draws), then a round with client 1's update scaled x1e3, quarantined
   on both devices; then K1 and K2 against their plain versions at the
   federated shapes;
12. durable rounds at the same configuration (``fed_durability_phase``),
   the similarity monitor reading 10,000 rows after every round: two runs
   from one seed bit-equal; save, load and resume bit-equal to the
   uninterrupted run; a save torn by ``crash_checkpoint`` leaves the
   earlier generation, which resumes; the watchdog rolls back twice
   (the newest generation poisoned) and re-anneals; the durable CLI
   (``--monitor-every 1 --save-every 1 --ckpt-keep 2 --watchdog``, then
   ``--resume``) in processes of its own from the start of phase 11, its
   resumed rounds equal to the same rounds replayed here; K1 and K2 launches per monitored round
   exact; then the monitor's probe, save, load and seconds per round
   timed, and K1 held against its plain version at the probe's shape;
13. a ragged round: the first 70% of ``adult_like_table(7000, 11)`` over 8
   Dirichlet clients (alpha 0.5), some with no step, 2 rounds twice from
   one seed (bit-equal, K1/K2 launches exact), then K1 and K2 against
   their plain versions at its shape (8 x 500 rows of the Adult layout).

14. mixed precision (``precision_phase``), slice 9's paths in bf16:
   the matmul flags printed (bf16 GEMMs reduce in float32, TF32 off);
   the standalone trainer with ``TrainConfig(precision="bf16")`` at phase
   5's configuration twice from one seed (each K1/K2 variant launched
   exactly: the sampling K1 once per critic step, the training K1 and K2
   once per generator step; bit-equal weights), its ms/step beside phase
   5's, and the f32 and bf16 loss trajectories from one init and draw
   stream; the federated round of phase 10 in bf16 (the bf16 delta
   payload, a snapshot and a save every round, exact launches, the save
   after round 2 resumed: bit-equal); the bf16 and the f32 trained models
   served in turns (phase 4's requests: p50, rows/s, chunked == one-shot,
   the bf16 sampling K1 once per chunk), the bf16 one card vs CPU on
   injected draws (encoded rows within one bf16 ulp, categorical cells
   equal outside bf16 ties); then each bf16 variant held against its plain
   version (one bf16 ulp; the float32 residual within 1e-5) at the
   served chunk, (8000, 282), (64000, 282), (500, D), (2000, D) and
   operands 2 and 4 bytes off a 16-byte boundary, with times, plan and
   the bound at 8 (12) bytes an element.

15. onboarding at population scale (``onboard_phase``): N = 64 and 256
   IID Intrusion-shaped clients of 200 rows; per N a cold init with exact
   similarity, a cold ``--similarity sketch`` init into a fresh init
   cache and a warm restore (seconds by phase, clients/s, rows/s, peak
   device memory): sketch weights within 5e-3 of exact, with the same
   argmax where the exact top two are further apart than twice the
   delta, the warm restore bit-identical; a ``corrupt_cache:nth=1``
   store detected and refitted to the same weights; at N = 256 one
   client's columns fitted alone equal to their fit in the batch of all
   256 bit for bit, and 64 newcomers registered (seconds);
16. elastic membership (``churn_phase``): the CLI in this process on the
   federated round's CSV, 4 clients, ``--elastic-capacity 8``, 8 rounds,
   a join of 2 at round 3, client 1 leaving at round 5, client 0 drifting
   at round 6, a drift window every 2 rounds, a 10,000-row snapshot and
   a save every round under the watchdog: population 4 -> 6, client 1
   dropped, the drift caught and the weights recomputed within one
   window, the last snapshot finite, two runs bit-equal, K1/K2 launches
   exact at (8 x 500, D); then s/round of the same 4 clients at capacity
   8 and at capacity 0 in turns (what the padded slots cost), and K1/K2
   against their plain versions at the elastic shape.

17. round-scale federation and MD-GAN (``round_scale_phases``), each
   through the CLI in this process (launches counted) at full width:
   ``cohort_phase`` (32 IID clients of 1,000 rows, ``--population 32
   --cohort 8``, 4 rounds with a 10,000-row snapshot each: K1 5 and K2 2
   launches a round at (4000, D), the save after round 2 resumed bit-equal
   to 4 straight rounds with every slot's Adam count what its cohorts
   give it, two runs bit-equal; then s/round at cohort 8 of 32, full participation of 32 and 8 resident
   clients in turns, and peak device memory); ``buffered_phase`` (the
   federated round's 4 clients, ``--aggregation buffered --faults
   straggle:rank=2,delay=2,round=2,until=3``: the deltas land at rounds 4
   and 5 with discount weight x 0.25; without the fault bit-equal to
   sync); ``ema_phase`` (``--ema-decay 0.99``, 4 rounds, a save each: the
   snapshot's bytes and the artifact are the debiased EMA's, the save
   after round 2 resumes bit-equal); ``rounds_per_program_phase`` (8
   hook-free rounds at K = 4 and K = 1 in turns: bit-equal, 2 host copies
   against 8, s/round); ``mdgan_phase`` (``--mode mdgan``, 3 rounds: K1 2
   a step plus 1 a snapshot chunk and K2 1 a step at (2000, D), 2 rounds +
   ``--resume`` bit-equal to 3, one step card vs CPU on injected draws,
   s/round beside fedavg's in turns); then K1 and K2 against their plain
   versions at (4000, D) and (2000, D).

18. the multi-process federation (``multiprocess_phase``), slice 12's
   main path: the federated round's CSV as 4 shard CSVs of 5,000 rows, a
   world of rank 0 and 4 participants through the CLI (``-ip 127.0.0.1
   -port P -rank r``; ranks 0 and 2-4 processes of their own, rank 1 in
   this process so its launches count), 3 rounds at full width with a
   40,000-row packed8 snapshot a round, aggregated by an all-gather over
   the collective backend the topology picks (gloo: every participant
   shares the one card): every rank exits 0, rank 0's cross-rank check
   and the snapshots; the ranks' final generators equal, and equal to a
   second world's; a 1-round world within the round tolerance of the
   in-process CLI's first round on the same CSVs (``--client-data``;
   whether bit-equal printed, and the difference after 3 rounds); the
   init's weights equal to the in-process init's; that 1-round world's
   save and ``--resume`` to 3 equal to the straight world (rank 1 under
   ``torch.profiler`` for its K1/K2 launches in the round); s/round per
   participant and rank 0's wall beside the in-process stacked round's
   (turns world, in-process, in-process, world), the all-gather's bytes
   and ms a round; then K1
   and K2 against their plain versions at a participant's shape (500,
   D).  The second world journals (``--journal``: one journal per rank),
   and ``python -m fed_tgan_torch.obs report`` over the per-rank
   journals must count 3 rounds and 4 clients.

19. the observatory (``observatory_phase``), slice 13's path: the
   federated round's CSV through the CLI as a process of its own, 4 IID
   clients, 3 rounds, a 40,000-row snapshot, the monitor and a save
   every round, ``--precision f32 --journal J --obs-port 0 --profile-dir
   D --profile-rounds 1`` with every event validated against the schema:
   while it runs ``/healthz`` reaches ``training``, ``/metrics`` holds 4
   ``fed_tgan_client_weight`` series and ``/journal?offset=0`` answers
   with ``X-Journal-Offset``; after exit 0 ``J`` holds no
   ``schema_violation``, 3 ``client_contribution`` events whose weights
   sum to 1 within 1e-6 and equal the printed weights, 3 ``round``, 3
   ``similarity`` and 3 ``checkpoint`` events, one ``device_trace`` with
   ``ok`` and ``program_cost`` with flops and bytes above 0; ``obs report
   J`` prints "clients: 4 tracked over 3 round(s)", ``obs slo J`` and
   ``obs watch J`` exit 0; the trace in ``D`` holds K1 21 times (10 steps
   x 2 + the snapshot's chunk) plus the monitor's probe and K2 10 times,
   with the spans ``train.local_steps``, ``train.aggregate.sync`` and
   ``train.snapshot`` as host ranges.  Then the same round in this
   process, 5 rounds a turn with the observatory off, with a journal (a
   span tracer and the first chunk's cost too) and on (the journal and
   the exporter scraped every 50 ms) in turns off, on, journal, journal,
   on, off after a warm-up turn: the final states equal, the
   synchronising calls (``torch.cuda.set_sync_debug_mode("warn")``) as
   many; s/round of each, the overhead fractions, the scrape's p99.  The
   fleet and canary phases run under a journal too, which must hold
   ``fleet_load``, ``serve_stages``, ``promotion_promoted`` and
   ``promotion_rejected`` and no schema violation.

20. the sanitizers and the tooling (``tooling_phase``), slice 14's path,
   every sanitized or doctor command a process of its own (cuBLAS reads
   its deterministic workspace setting once, before the first CUDA call):
   the federated round's CLI (4 IID clients, 3 rounds, a 40,000-row
   packed8 snapshot a round, ``--save-model``) plain, ``--sanitize`` and
   ``--sanitize-nans`` one after another, each with K1 21 and K2 10
   launches a round, exact: the sanitized run's report holds the training
   budget and 0 unsanctioned syncs in its steady rounds (their sanctioned
   syncs printed), and both runs' snapshots and final generator equal the
   plain run's; a ``nan_update`` fault under ``--sanitize-nans`` raises
   FloatingPointError naming the op and its line; in this process a
   deliberate ``.item()`` in a steady hot region raises SyncGuardError
   naming it while another thread's syncs do not, and a NaN logit fed to
   K1 raises naming K1; ``ops/diagnostics.py::gradient_flow`` at full
   width on the card against the CPU from the same weights and draws
   (atol 1e-6 + rtol 1e-3 a layer; K1 2 and K2 1 launches); ``serve
   --sanitize`` answers 5,000-row requests (two chunk sizes each) with
   an unsanitized engine's bytes, its report after the drain clean;
   ``fleet --sanitize --lockwatch`` serves phase 4's 4 tenants to 16
   clients (every body its tenant's single engine's), then no cycle, no
   re-entry, the fleet budget, each lock's hold p99; beside them
   ``python -m fed_tgan_torch.doctor`` (all 22 checks OK) and ``obs ledger
   --json`` (every family with flops and peak bytes above 0); the steady
   s/round of the three CLI runs, the phase's seconds, and the process
   left with sync debug mode 0 and deterministic algorithms off; then K1
   and K2 against their plain versions at the sanitized round's stacked
   step and the gradient-flow batch.

21. the pod launcher (``pod_phase``), slice 15's full-width path after
   phase 18's worlds (one world at a time): ``scripts/torch_launch_pod.py
   --processes 5`` on phase 18's 4 shards, ``TrainConfig()`` widths
   (batch 500, embedding 128), 3 rounds, one 40,000-row snapshot at the
   end: every rank exits 0, every participant's generator ``torch.equal``
   to the others' and to a world of the same flags started by phase 18's
   harness, ``federation.json`` with 5 rank journals and 3 rounds, K1/K2
   launched in every participant (its own counters, printed at its exit);
   a departure pod (``kill_client:rank=2,round=2`` in the launcher's
   environment) returns 1 with every rank reaped within the grace period;
   the pod's wall and rank 0's s/round beside the worlds'; then K1 and K2
   against their plain versions at a participant's shape.

22. the soaks (``soak_phase``, in this process, launches counted):
   ``scripts/torch_soak.py``'s ``run_soak`` for seeds 0-4 (3 clients
   stacked on the card, 3 rounds, a random fault plan each; every seed
   completed with finite parameters or aborted cleanly) and
   ``run_churn_soak`` at 50 rounds meeting JAX's acceptance (completed,
   finite, nothing built across the joins, a rollback, a drift alarm,
   clients 1 and 5 dropped, ``obs slo`` exit 0); then K1 and K2 against
   their plain versions at both soaks' stacked steps.

23. offline evaluation (``offline_eval_phase``), slice 16's path: the
   fedavg CLI in this process (launches counted) on phase 9's
   Intrusion-like CSV at full width, 2 rounds with ``--sample-every 1
   --monitor-every 1`` and 40,000-row snapshots; ``python -m
   fed_tgan_torch.eval.similarity`` over its snapshots and
   ``timestamp_experiment.csv`` exits 0, its rows the snapshot rounds, its
   values finite and equal to ``statistical_similarity`` in this process
   on the same files, its ``time_stamp`` the cumulative round time;
   ``scripts/torch_crosscheck_monitor.py`` compares 2 rounds (the gaps
   printed, not gated); the zoo's binning, min-max (sigmoid and tanh) and
   grid encoders on 40,000 Intrusion-like rows, the card's tensors
   ``torch.equal`` to the CPU's; ``--snapshot-format parquet``,
   ``--snapshot-format feather``, ``--bgm-backend sklearn`` and ``python
   -m fed_tgan_torch.eval.utility``, each a process of its own, run and
   are checked where their library (pyarrow, sklearn) imports (columnar
   snapshots equal to the CSV's values; a host-fit init and a round on
   the card; the utility gap finite), and elsewhere exit 2 naming it in a
   process that sees no card (a probe would exit 3); the branch each took
   and the phase's seconds are printed.

24. the program contracts (``contracts_phase``), slice 17's path:
   ``python -m fed_tgan_torch.analysis --contracts --backend gpu`` in a
   process of its own dispatches every contracted entry point on the card
   and holds it against ``fed_tgan_torch/analysis/contracts/gpu/`` (exit 1
   or 2 fails the script); each program's K1/K2 calls (the recorder holds
   them equal to the wrappers' launch counts), syncs and cross-device
   copies with their bytes are printed, and its kernel calls must equal
   the CPU contract's; the doctor's static-analysis, program-contracts,
   analysis-all (``--all``: the three prongs) and backend-seam checks on
   the card all OK (read from phase 20's doctor in a full run; with
   ``--contracts`` alone, run in another process beside the contracts);
   then K1 and K2 against their plain versions at the contracts'
   training shape.

Phase 19 also runs ``scripts/torch_trace_attribution.py`` on its trace:
its K1 and K2 counts equal the phase's own count of the trace, its busy
ms summed over the streams within 1% of the phase's.

``--onboard N [N ...]`` runs phase 15 alone at the populations given (the
JAX sweep's N = 1024 is measured so); ``--multiprocess`` runs phase 18
alone (a participant killed mid-run, with every process ending, is
checked by phase 21's departure pod: ``--pod``); ``--observatory`` runs
phase 19 alone, trace attribution included;
``--tooling`` runs phase 20 alone; ``--backend-probe``, ``--pod``,
``--soak``, ``--offline-eval`` and ``--contracts`` run the backend probe,
phase 21, phase 22, phase 23 and phase 24 alone.

``--ab TREE`` runs none of the phases: it builds the kernels of the
``fed_tgan_torch`` package under TREE (for example a ``git archive`` of an
earlier commit, ``chip_smoke.py`` included) and times them against this
tree's in turns (other, this, this, other) at the training batch, the
serving chunk, a 128-step chunk and the 70-wide segment; then, in the same
turns, phase 4 and the stage breakdown of TREE's ``chip_smoke.py`` and of
this one, each turn a process of its own; and prints one
``{"ab": ..., "ab_serving": ...}`` line.

Prints the card's name and power limit beside every number, a JSON line
with the training numbers, one with the federated round's, one with the
durable round's, one with the canary's and the dated phase's, one with
the precision phase's, one with the onboarding and churn phases', one
with the round-scale phases', one with the multi-process world's, one
with the observatory's, one with the tooling phase's, one with the
run-level tools' (the probe, the pod, the soaks), one with the offline
evaluation's, one with the program contracts', the card's
line, a JSON line with the kernels' numbers (one entry per kernel and
path: K1 serving, K1 in the fleet, K1 and K2 training, K1 and K2
federated, K1 in the similarity monitor, K1 and K2 in the ragged round, K1
in the canary's shadow samples, K1 serving a dated model, K1 and K2 in
the dated training, K1 and K2 in the elastic rounds, K1 and K2 in the
cohort rounds and in MD-GAN, K1 and K2 in a multi-process participant,
K1 and K2 in the sanitized round and in the gradient-flow summary, K1
and K2 in a pod participant, the fault soak and the churn soak, K1 and K2
in the offline evaluation's run, K1 and K2 in the program contracts, and
the three bf16 variants),
and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, with no result line, when CUDA is not available.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import csv
import dataclasses
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import torch

from fed_tgan_torch.data import fastcsv
from fed_tgan_torch.data.csvio import plain_csv_bytes, read_csv, write_csv
from fed_tgan_torch.data.decode import decode_cells, decode_columns
from fed_tgan_torch.data.ingest import TablePreprocessor
from fed_tgan_torch.data.sharding import shard_table
from fed_tgan_torch.datasets import (
    INTRUSION_SELECTED,
    PRESETS,
    preprocessor_kwargs,
)
from fed_tgan_torch.eval.similarity import statistical_similarity
from fed_tgan_torch.features import zoo
from fed_tgan_torch.features.transformer import (
    DiscreteColumn,
    ModeNormalizer,
    output_info,
)
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.interop import params_to_jax_layout
from fed_tgan_torch.obs.journal import (
    RunJournal,
    read_journal,
    set_journal,
    validation_violations,
)
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
    apply_activate_residual,
    cond_tables,
)
from fed_tgan_torch.serve.demo import (
    adult_like_table,
    build_random_artifact,
    intrusion_layout,
    intrusion_like_raw,
    intrusion_like_table,
    write_artifact,
    write_intrusion_csv,
)
from fed_tgan_torch.serve.engine import SamplingEngine
from fed_tgan_torch.serve.registry import ModelRegistry, open_model
from fed_tgan_torch.runtime.checkpoint import (
    find_resumable,
    list_resumable,
    load_federated,
    save_federated,
)
from fed_tgan_torch.runtime.precision import resolve_precision
from fed_tgan_torch.serve.service import SamplingService
from fed_tgan_torch.testing.faults import FaultInjected, FaultPlan, install_plan
from fed_tgan_torch.train import steps
from fed_tgan_torch.train.federated import FederatedTrainer
from fed_tgan_torch.train.monitor import SimilarityMonitor
from fed_tgan_torch.train.sampler import CondSampler, RowSampler
from fed_tgan_torch.train.snapshots import SnapshotWriter, result_path_fn
from fed_tgan_torch.train.standalone import StandaloneSynthesizer
from fed_tgan_torch.train.watchdog import (
    TrainingWatchdog,
    WatchdogAlarm,
    WatchdogConfig,
    fit_with_watchdog,
)

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
# the federated round's target configuration: 4 IID clients of an
# Intrusion-shaped table, TrainConfig() defaults, a 40,000-row snapshot
# (the reference's) after every round
FED_ROWS, FED_CLIENTS, FED_EPOCHS, SNAPSHOT_ROWS = 20_000, 4, 3, 40_000
# the durable round: the similarity monitor at the JAX default of 10,000
# rows every round, 3 rounds per run (cut from 4 to keep the script's time)
MONITOR_ROWS, DUR_ROUNDS = 10_000, 3
# the ragged round: the non-IID federation of the run-level record (the
# JAX package's ADULT_ROWS_r04.jsonl runs): 7,000 Adult-shaped rows, 70%
# trained on, 8 Dirichlet clients
ADULT_ROWS, ADULT_CLIENTS = 7_000, 8


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


def bound_ms(rows: int, dim: int, kernel: str = "K1",
             bytes_per_elem: int = BYTES_PER_ELEM) -> tuple[float, str]:
    t_bytes = bytes_per_elem * rows * dim / PEAK_BYTES_PER_S * 1e3
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


def measure(kernel: str, fn, plain, rows: int, dim: int,
            bytes_per_elem: int = BYTES_PER_ELEM) -> dict:
    """:func:`kernel_times` beside the plain version's time and the
    bound."""
    bound, bound_by = bound_ms(rows, dim, kernel, bytes_per_elem)
    return {**kernel_times(kernel, fn, rows),
            "plain_ms": cuda_ms(plain, 20 if rows >= 64000 else 200),
            "bound_ms": bound, "bound_by": bound_by}


def misaligned(t: torch.Tensor, elems: int = 1) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base is ``elems`` elements past a
    16-byte boundary (a view at storage offset ``elems``): 4 bytes for a
    float32 tensor and one element, 2 bytes for a bf16 one."""
    st = torch.empty(t.numel() + elems, device=t.device, dtype=t.dtype)
    st[elems:].copy_(t.flatten())
    return st[elems:].view_as(t)


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
    # a dataclass looks its module up in sys.modules while it is built
    sys.modules[mod_spec.name] = mod
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


# one side's turn of the serving A/B, run in a process of its own from the
# root of that side's tree: its chip_smoke's phase 4 and stage breakdown
_SERVE_TURN = """
import json, shutil, sys, tempfile
import chip_smoke as cs
rows, seed, repeats, card = json.loads(sys.argv[1])
cs.activate_cuda.build()
cs.fastcsv.build()
art = tempfile.mkdtemp(prefix="ab_serve_", dir=cs.REPO)
try:
    cs.build_random_artifact(art, seed=seed)
    runs = [cs.serve_phase(art, rows, seed, card) for _ in range(repeats)]
    stages = cs.stage_breakdown(art, rows, seed, card)
finally:
    shutil.rmtree(art, ignore_errors=True)
print(json.dumps({"runs": runs, "stages_ms": stages}))
"""


def serve_ab_phase(other_root: str, rows: int, seed: int, card: str,
                   repeats: int = 4) -> dict:
    """Phase 4 (the single-model service, one client, ``rows``-row
    requests) and its stage breakdown, of the other tree and of this one,
    in turns (other, this, this, other), each turn a process of its own
    from its tree's root; per side the median of the turns' p50s and
    of their rows/s, and the median of each stage."""
    turns = []
    for side, root in (("parent", other_root), ("change", REPO),
                       ("change", REPO), ("parent", other_root)):
        proc = subprocess.run(
            [sys.executable, "-c", _SERVE_TURN,
             json.dumps([rows, seed, repeats, card])],
            cwd=root, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"serving A/B, {side} turn: exit "
                                 f"{proc.returncode}\n{proc.stderr[-4000:]}")
        turns.append({"side": side,
                      **json.loads(proc.stdout.strip().splitlines()[-1])})
    out = {}
    for side in ("parent", "change"):
        runs = [r for t in turns if t["side"] == side for r in t["runs"]]
        stages = [t["stages_ms"] for t in turns if t["side"] == side]
        out[side] = {
            "p50_ms": statistics.median(r["p50_ms"] for r in runs),
            "rows_per_s": statistics.median(r["rows_per_s"] for r in runs),
            "stages_ms": {k: statistics.median(st[k] for st in stages)
                          for k in stages[0]}}
        print(f"A/B serving, {rows}-row requests, {len(runs)} runs of 5 "
              f"({'other' if side == 'parent' else 'this'} tree): p50 "
              f"{out[side]['p50_ms']!r} ms, {out[side]['rows_per_s']!r} "
              f"rows/s, stages {out[side]['stages_ms']}  [{card}]",
              flush=True)
    out["turns"] = turns
    return out


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
        j = np.argmax(diff - rtol * np.abs(b[keep]))
        raise AssertionError(f"{name}: card vs CPU max abs diff "
                             f"{diff.max()} (atol {atol}, rtol {rtol}); worst "
                             f"entry {a[keep][j]!r} vs {b[keep][j]!r}")
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


def _fed_init(csv_path: str, n_clients: int, seed: int, device: str):
    """The federated init of the target configuration: the raw CSV
    sharded IID over ``n_clients``, the Intrusion preset."""
    kw = preprocessor_kwargs(PRESETS["intrusion"])
    shards = shard_table(read_csv(csv_path), n_clients, "iid", seed=seed)
    clients = [TablePreprocessor(table=t, name="Intrusion", **kw)
               for t in shards]
    return federated_initialize(clients, seed=seed, device=device)


def fed_cli_phase(root: str, seed: int, card: str) -> dict:
    """The training CLI as a user runs it, in a process of its own, on
    the card: 3 rounds, a 40,000-row snapshot after each, the evaluation
    and the artifact; then ``serve`` answers one request from that
    artifact."""
    out = os.path.join(root, "cli_out")
    cmd = [sys.executable, "-m", "fed_tgan_torch", "--mode", "fedavg",
           "--datapath", os.path.join(root, "intrusion.csv"),
           "--dataset", "intrusion", "--n-clients", str(FED_CLIENTS),
           "-epochs", str(FED_EPOCHS), "--sample-every", "1",
           "--sample-rows", str(SNAPSHOT_ROWS), "--eval", "--save-model",
           "--out-dir", out, "--seed", str(seed)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"federated CLI exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    result = os.path.join(out, "Intrusion_result")
    names = sorted(os.listdir(result))
    want = [f"Intrusion_synthesis_epoch_{e}.csv" for e in range(FED_EPOCHS)]
    if names != want:
        raise AssertionError(f"snapshots {names} != {want}")
    for name in names:
        with open(os.path.join(result, name)) as f:
            header = f.readline().strip().split(",")
            n = sum(1 for _ in f)
        if header != list(INTRUSION_SELECTED) or n != SNAPSHOT_ROWS:
            raise AssertionError(f"{name}: {len(header)} columns, {n} rows")
    final = [line for line in proc.stdout.splitlines()
             if line.startswith("final Avg_JSD=")]
    if not final:
        raise AssertionError("the CLI printed no final Avg_JSD/Avg_WD")
    jsd, wd = (float(v.split("=")[1]) for v in final[0].split()[1:3])
    if not (math.isfinite(jsd) and math.isfinite(wd)):
        raise AssertionError(f"non-finite evaluation {final[0]}")
    registry = ModelRegistry(out, device="cuda", log=_silent)
    model = registry.get()
    service = SamplingService(registry).start()
    try:
        status, body, _ = fetch(f"{service.url}/sample?rows=1000&seed={seed}")
    finally:
        service.shutdown()
    if status != 200:
        raise AssertionError(f"serve answered {status}")
    check_csv(body, 1000, True,
              [i for i, c in enumerate(model.meta.column_names)
               if c in model.meta.continuous_columns])
    print(f"federated CLI: {FED_CLIENTS} clients x {FED_ROWS // FED_CLIENTS} "
          f"rows, {FED_EPOCHS} rounds, {SNAPSHOT_ROWS}-row snapshots "
          f"{names}: exit 0 in {wall!r} s; {final[0]}; serve answered 1000 "
          f"rows from the saved artifact  [{card}]", flush=True)
    return {"wall_s": wall, "avg_jsd": jsd, "avg_wd": wd,
            "stdout_tail": proc.stdout.splitlines()[-6:]}


def fed_round_phase(root: str, seed: int, card: str) -> dict:
    """The target configuration in this process: init phases, then
    ``FED_EPOCHS`` rounds with a snapshot after each (the main path,
    K1/K2 launches counted and checked exactly), then rounds without a
    snapshot (what the writer thread costs the next round's dispatch),
    then one round under ``torch.profiler``."""
    t0 = time.perf_counter()
    init = _fed_init(os.path.join(root, "intrusion.csv"), FED_CLIENTS, seed,
                     "cuda")
    init_s = time.perf_counter() - t0
    cfg = steps.TrainConfig()
    trainer = FederatedTrainer(init, cfg, seed=seed, device="cuda")
    path_fn = result_path_fn(os.path.join(root, "round_out"), "Intrusion")
    writer = SnapshotWriter(init.global_meta, init.encoders, path_fn,
                            rows=SNAPSHOT_ROWS, seed=seed)
    max_steps = int(trainer.steps.max())
    # K1 launches once per chunk of a snapshot (sampled on the device: no
    # power-of-two tail)
    chunks = len(trainer._sampler()._chunk_plan(
        0, -(-SNAPSHOT_ROWS // cfg.batch_size), pow2_tail=False))
    fused_apply_activate.launches = 0
    fused_activate_bwd.launches = 0
    with writer:
        trainer.fit(FED_EPOCHS, sample_hook=writer)
    launches = {"K1": fused_apply_activate.launches,
                "K2": fused_activate_bwd.launches}
    # one stacked step of every client per local step index
    per_round = {"K1": max_steps * (cfg.d_steps + 1) + chunks,
                 "K2": max_steps}
    want = {k: FED_EPOCHS * v for k, v in per_round.items()}
    if launches != want:
        raise AssertionError(f"federated launches {launches} != {want}")
    for e in range(FED_EPOCHS):
        with open(path_fn(e)) as f:
            if sum(1 for _ in f) != SNAPSHOT_ROWS + 1:
                raise AssertionError(f"snapshot {e}: wrong row count")
    formatter = snapshot_formatter_check(trainer, path_fn(FED_EPOCHS - 1),
                                         seed + FED_EPOCHS - 1, card)
    if not np.isfinite(trainer.last_metrics).all():
        raise AssertionError(f"non-finite round metrics "
                             f"{trainer.last_metrics}")
    with_snap = list(trainer.round_split["local_steps"])
    trainer.fit(FED_EPOCHS)  # no snapshot: no writer thread beside it
    quiet = trainer.round_split["local_steps"][FED_EPOCHS:]
    split = {k: v[:FED_EPOCHS] for k, v in trainer.round_split.items()}
    rounds_s = trainer.epoch_times[:FED_EPOCHS]
    snapshot_s = trainer.phase_times["distribution"][:FED_EPOCHS]
    e = trainer.completed_epochs
    device = device_profile(
        lambda: (trainer.run_round(e),
                 trainer.sample_parts(SNAPSHOT_ROWS, seed=seed)), 1)
    traced = {k: v["per_step"] for k, v in device.get("activation",
                                                       {}).items()}
    print(f"K1/K2 launches per round (torch.profiler, one round and its "
          f"snapshot): {traced} against the prediction {per_round}; device "
          f"ops {device.get('device_ops_per_step')!r} and busy "
          f"{device.get('busy_ms_per_step')!r} ms per round  [{card}]",
          flush=True)
    if traced and traced != {k: float(v) for k, v in per_round.items()}:
        raise AssertionError(f"traced launches {traced} != {per_round}")
    loop = loop_vs_stacked(trainer, seed, card)
    report = {
        "config": {"rows": FED_ROWS, "clients": FED_CLIENTS,
                   "rows_per_client": init.rows_per_client,
                   "steps_per_round": trainer.steps.tolist(),
                   "dim": trainer.spec.dim, "n_opt": trainer.spec.n_opt,
                   "snapshot_rows": SNAPSHOT_ROWS, "batch": cfg.batch_size},
        "init_s": init_s, "init_phases_s": {**init.timings,
                                            **trainer.timings},
        "weights": init.weights.tolist(),
        "round_s": rounds_s, "local_steps_s": split["local_steps"],
        "aggregate_s": split["aggregate"],
        "snapshot_device_and_copy_s": snapshot_s,
        "snapshot_host_csv_s": writer.write_s,
        "local_steps_s_next_to_writer": with_snap[1:],
        "local_steps_s_no_writer": quiet,
        "formatter": formatter,
        "launches": launches, "launches_per_round": per_round,
        "device_one_round": device, "loop_vs_stacked": loop,
    }
    print(f"federated round: {FED_CLIENTS} clients, steps {trainer.steps}"
          f" per round, layout {trainer.spec.dim}; init {init_s!r} s "
          f"({init.timings}); s/round {rounds_s!r} = local steps "
          f"{split['local_steps']!r} + aggregation {split['aggregate']!r} + "
          f"snapshot {snapshot_s!r} (device + copy; host CSV on the writer "
          f"thread {writer.write_s!r}); local steps next to the writer "
          f"{with_snap[1:]!r} vs without {quiet!r}; launches {launches} "
          f"(expected {want})  [{card}]", flush=True)
    print(f"snapshot host side: writer thread (packed8 lookup tables, "
          f"compiled formatter) {writer.write_s!r} s per {SNAPSHOT_ROWS}-row "
          f"snapshot; the snapshot's dispatch on the training thread "
          f"{snapshot_s!r} s; local steps next to the writer {with_snap[1:]!r}"
          f" s vs without it {quiet!r} s; s/round {rounds_s!r}  [{card}]",
          flush=True)
    print(f"federated round on the device (torch.profiler, one round and "
          f"its snapshot's device work): "
          f"{json.dumps(device)}  [{card}]", flush=True)
    return trainer, report


def loop_vs_stacked(trainer, seed: int, card: str) -> dict:
    """One round's local steps two ways on the same clients, in turns
    (loop, stacked, stacked, loop), the card synchronised around each:
    the per-client loop the stacked round replaced (each client's
    ``train_step``s on its own ``Models``, unstacked from the trainer,
    with its own generator: the parent tree's algorithm) and the stacked
    round (``FederatedTrainer._local_steps``).  Seconds per round."""
    spec, cfg = trainer.spec, trainer.cfg
    clients = []
    for i, m in enumerate(trainer.init.client_matrices):
        m = np.asarray(m, dtype=np.float32)
        clients.append((trainer.stack.to_models(i),
                        torch.as_tensor(m, device="cuda"),
                        CondSampler.from_data(m, spec, "cuda"),
                        RowSampler.from_data(m, spec, "cuda"),
                        torch.Generator(device="cuda").manual_seed(seed + i),
                        int(trainer.steps[i])))

    def loop():
        for models, data, cond, rows, gen, n in clients:
            for _ in range(n):
                steps.train_step(models, data, cond, rows,
                                 steps.draw_step(gen, models))

    e = trainer.completed_epochs
    times = {"loop": [], "stacked": []}
    for name in ("loop", "stacked", "stacked", "loop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop() if name == "loop" else trainer._local_steps(e)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    print(f"local steps of one round ({trainer.n_clients} clients, steps "
          f"{trainer.steps.tolist()}): per-client loop (the parent's "
          f"algorithm) {times['loop']!r} s, stacked {times['stacked']!r} s, "
          f"in turns loop, stacked, stacked, loop  [{card}]", flush=True)
    return times


def ragged_round_phase(root: str, seed: int, card: str) -> dict:
    """The non-IID federation of the run-level record: the first 70% of
    ``adult_like_table(7000, 11)`` split over 8 clients by a Dirichlet
    draw over ``income`` (alpha 0.5, seed ``seed``), so clients with
    fewer rows than a batch train no step (``allow_zero_step_clients``);
    ``TrainConfig()`` otherwise.  Two rounds, twice from one seed: finite
    metrics, zeros for the zero-step clients, every tensor ``torch.equal``
    between the runs, K1 and K2 launched ``max(steps) * (d_steps + 1)``
    and ``max(steps)`` times a round."""
    table = adult_like_table(ADULT_ROWS, 11)
    train = {k: v[:int(ADULT_ROWS * 0.7)] for k, v in table.items()}
    kw = preprocessor_kwargs(PRESETS["adult"])
    shards = shard_table(train, ADULT_CLIENTS, "dirichlet",
                         label_column="income", alpha=0.5, seed=seed)
    t0 = time.perf_counter()
    init = federated_initialize(
        [TablePreprocessor(table=t, name="Adult", **kw) for t in shards],
        seed=seed, device="cuda")
    init_s = time.perf_counter() - t0
    cfg = steps.TrainConfig(allow_zero_step_clients=True)
    runs, launches = [], []
    for _ in range(2):
        tr = FederatedTrainer(init, cfg, seed=seed, device="cuda")
        fused_apply_activate.launches = 0
        fused_activate_bwd.launches = 0
        tr.fit(2)
        launches.append({"K1": fused_apply_activate.launches,
                         "K2": fused_activate_bwd.launches})
        runs.append(tr)
    a, b = runs
    n = int(a.steps.max())
    want = {"K1": 2 * n * (cfg.d_steps + 1), "K2": 2 * n}
    zero = [i for i, k in enumerate(a.steps) if k == 0]
    state = lambda t: [t.stack.generator.params, t.stack.generator.bn_state,
                       t.stack.discriminator.params, t.stack.opt_g.exp_avg,
                       t.stack.opt_g.exp_avg_sq, t.stack.opt_d.exp_avg,
                       t.stack.opt_d.exp_avg_sq, t.stack.opt_g.count,
                       *(g.get_state() for g in t.gens)]
    print(f"ragged round: {ADULT_CLIENTS} Dirichlet clients of the Adult-"
          f"shaped table, rows {init.rows_per_client}, steps "
          f"{a.steps.tolist()} (zero-step clients {zero}), layout "
          f"{a.spec.dim}; init {init_s!r} s; s/round {a.epoch_times!r} "
          f"(local steps {a.round_split['local_steps']!r}); launches "
          f"{launches} (expected {want} in 2 rounds); two runs equal  "
          f"[{card}]", flush=True)
    _require_equal("two ragged runs from one seed", state(a), state(b))
    if not zero or launches != [want, want]:
        raise AssertionError(f"ragged round: zero-step clients {zero}, "
                             f"launches {launches} != {want}")
    if not np.isfinite(a.last_metrics).all() or \
            (a.last_metrics[zero] != 0).any():
        raise AssertionError(f"ragged metrics {a.last_metrics}")
    return {"trainer": a, "rows_per_client": init.rows_per_client,
            "steps": a.steps.tolist(), "dim": a.spec.dim, "init_s": init_s,
            "round_s": a.epoch_times,
            "local_steps_s": a.round_split["local_steps"],
            "launches": launches[0]}


def snapshot_formatter_check(trainer, path: str, seed: int,
                             card: str) -> dict:
    """The compiled formatter on this machine: the last snapshot's file
    (pinned non-blocking copies, the packed8 lookup tables) and the lookup
    tables alone, against the stdlib writer's bytes of the same rows
    copied to the host with a blocking copy."""
    meta, encoders = trainer.init.global_meta, trainer.init.encoders
    parts = trainer.sample_parts(SNAPSHOT_ROWS, seed=seed)
    t0 = time.perf_counter()
    plain = plain_csv_bytes(decode_columns(trainer.decode.assemble(parts),
                                           meta, encoders))
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fmt = fastcsv.PackedSnapshotFormatter.build(trainer.decode, meta,
                                                encoders)
    build_s = time.perf_counter() - t0
    if fmt is None:
        raise AssertionError("the packed8 snapshot did not take the lookup "
                             "tables")
    t0 = time.perf_counter()
    packed = fmt.csv_bytes(parts)
    packed_s = time.perf_counter() - t0
    with open(path, "rb") as f:
        written = f.read()
    if packed != plain or written != plain:
        raise AssertionError(
            f"snapshot bytes differ from the stdlib writer's: tables "
            f"{packed == plain}, written file {written == plain}")
    print(f"snapshot formatter: the written file and the lookup tables are "
          f"byte-equal to the stdlib writer ({len(plain)} bytes, "
          f"{SNAPSHOT_ROWS} rows); tables {packed_s!r} s (built once in "
          f"{build_s!r} s) vs stdlib {plain_s!r} s  [{card}]", flush=True)
    return {"bytes": len(plain), "byte_equal": True, "tables_s": packed_s,
            "tables_build_s": build_s, "plain_s": plain_s}


def fed_reference_phase(root: str, seed: int, card: str) -> dict:
    """One round on the card against the same round on the CPU (the same
    initial weights and injected draws, 4 clients x 1,000 rows at full
    width, 2 steps each), then a round where client 1's update is scaled
    x1e3 after its local steps.

    - Round 1: every client's aggregated parameters and BatchNorm state.
      All but at most 1% of the entries within slice 2's atol 1e-5 + rtol
      1e-3, and every parameter within ``2 * 1.2 * lr`` per local step: an
      Adam step at these betas is at most ~1.2 lr, and an entry whose
      gradient is near zero (a BatchNorm shift summed over 500 rows, a
      dropped-out unit) may step the other way on the other device.  The
      count outside, per part, is printed.
    - Round 2: client 1 quarantined on both devices, and on both the
      aggregate moved by at most ``4 * lr`` per local step from round 1's
      (the scaled update would move it by ~1e3 x an Adam step).  The
      card-vs-CPU distance of round 2 is printed."""
    path = write_intrusion_csv(os.path.join(root, "ref.csv"), 4000, seed + 1)
    init = _fed_init(path, FED_CLIENTS, seed, "cpu")
    cfg = steps.TrainConfig()
    spec = SegmentSpec.from_output_info(init.output_info)
    ref = steps.init_models(spec, cfg, seed + 1, "cpu")
    draws = {}

    def draw(e, i, s):
        if (e, i, s) not in draws:
            gen = torch.Generator().manual_seed(1000 * e + 10 * i + s)
            draws[(e, i, s)] = steps.draw_step(gen, ref)
        return draws[(e, i, s)]

    runs = {}
    for dev in ("cuda", "cpu"):
        models = [steps.init_models(spec, cfg, seed + 1, dev)
                  for _ in range(FED_CLIENTS)]
        tr = FederatedTrainer(init, cfg, seed=seed, device=dev,
                              models=models, draws=draw)
        tr.fit(1)
        first = [params_to_jax_layout(m) for m in tr.models]
        q0 = tr.last_quarantined.tolist()
        tr.fit(1, update_fault=("scale", 1, 1000.0))
        runs[dev] = (first, q0, [params_to_jax_layout(m) for m in tr.models],
                     tr.last_quarantined.tolist())
    n_steps = int(tr.steps[0])
    if list(tr.steps) != [2] * FED_CLIENTS:
        raise AssertionError(f"steps {tr.steps}")
    (c1, cq0, c2, cq1), (h1, hq0, h2, hq1) = runs["cuda"], runs["cpu"]
    flip = 2 * 1.2 * cfg.lr * n_steps
    stats = {}
    for part in ("params_g", "params_d", "state_g"):
        n = out = 0
        worst = (0.0, None)
        for a, b in zip(c1, h1):
            for k, (x, y) in enumerate(zip(_leaves(a[part]),
                                           _leaves(b[part]))):
                x, y = np.asarray(x), np.asarray(y)
                d = np.abs(x - y)
                n, out = n + d.size, out + int(
                    (d > 1e-5 + 1e-3 * np.abs(y)).sum())
                if d.max() > worst[0]:
                    j = int(d.argmax())
                    worst = (float(d.max()), f"leaf {k} {x.shape}: "
                             f"{x.flat[j]!r} vs {y.flat[j]!r}")
        stats[part] = {"entries": n, "outside": out, "max_abs_diff": worst[0],
                       "worst": worst[1]}
    moved, round2 = {}, 0.0
    for dev, (r1, _, r2, _) in runs.items():
        moved[dev] = max(
            float(np.abs(np.asarray(x) - np.asarray(y)).max())
            for a, b in zip(r1, r2) for part in ("params_g", "params_d")
            for x, y in zip(_leaves(a[part]), _leaves(b[part])))
    for a, b in zip(c2, h2):
        for part in ("params_g", "params_d", "state_g"):
            for x, y in zip(_leaves(a[part]), _leaves(b[part])):
                round2 = max(round2, float(np.abs(np.asarray(x)
                                                  - np.asarray(y)).max()))
    print(f"federated reference: one round card vs CPU (4 clients x 1,000 "
          f"rows, 2 steps each, full width, injected draws): {stats} "
          f"(atol 1e-5 + rtol 1e-3 for all but 1%, parameters within "
          f"{flip!r}); then client 1 scaled x1e3: quarantined {cq1} on the "
          f"card, {hq1} on the CPU; the aggregate moved at most {moved} "
          f"(bound {4 * cfg.lr * n_steps!r}); round 2 card vs CPU max abs "
          f"diff {round2!r}  [{card}]", flush=True)
    for part, st in stats.items():
        if st["outside"] > 0.01 * st["entries"] or (
                part != "state_g" and st["max_abs_diff"] > flip):
            raise AssertionError(f"round 1 {part}: card vs CPU {st}")
    if cq0 != hq0 or any(cq0):
        raise AssertionError(f"clean round quarantined {cq0} / {hq0}")
    if cq1 != hq1 or cq1 != [False, True, False, False]:
        raise AssertionError(f"scaled client: card {cq1}, CPU {hq1}")
    if max(moved.values()) > 4 * cfg.lr * n_steps:
        raise AssertionError(f"the round with the scaled client moved the "
                             f"aggregate by {moved}")
    return {"round1": stats, "quarantined_card": cq1,
            "quarantined_cpu": hq1, "round2_moved": moved,
            "round2_max_abs_diff": round2}


def _trainer_state(tr) -> list:
    """Every tensor a resumed run depends on, copied: each client's
    parameters and buffers, Adam steps and moments, and generator state."""
    out = []
    for i, m in enumerate(tr.models):
        out += list(m.generator.state_dict().values())
        out += list(m.discriminator.state_dict().values())
        for opt in (m.opt_g, m.opt_d):
            for p in opt.param_groups[0]["params"]:
                out += [opt.state[p][k] for k in ("step", "exp_avg",
                                                  "exp_avg_sq")]
        out.append(tr.gens[i].get_state())
    return [t.detach().clone() for t in out]


def _require_equal(what: str, a: list, b: list) -> None:
    bad = [k for k, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    if len(a) != len(b) or bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(a)} tensors differ "
                             f"(first at {bad[:5]})")


class DurableCLI:
    """The durable CLI as a user runs it, in processes of its own started
    from a thread: 3 monitored, checkpointed rounds under the watchdog,
    then, once :meth:`resume` is called, ``--resume`` to 5 rounds.
    ``first_done`` is set when the first process has ended.  The round-3
    checkpoint is copied aside before the resume, so the rounds resumed
    can be replayed in this process.  ``stop()`` kills a process still
    running."""

    def __init__(self, root: str, seed: int):
        self.root, self.out = root, {}
        self.work = os.path.join(root, "cli_durable")
        self._cmd = [
            sys.executable, "-m", "fed_tgan_torch", "--mode", "fedavg",
            "--datapath", os.path.join(root, "intrusion.csv"), "--dataset",
            "intrusion", "--n-clients", str(FED_CLIENTS), "--monitor-every",
            "1", "--save-every", "1", "--ckpt-keep", "2", "--watchdog",
            "--eval", "--out-dir", self.work, "--seed", str(seed)]
        self._proc = None
        self._stopped = False
        self.first_done = threading.Event()
        self._resume = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            ok = self._process("first", ["--epochs", "3"])
            if ok:
                shutil.copytree(os.path.join(self.work, "checkpoint"),
                                os.path.join(self.root, "cli_round3"))
        finally:
            self.first_done.set()
        self._resume.wait()
        if ok and not self._stopped:
            self._process("resume", ["--resume", "--epochs", "5"])

    def _process(self, key: str, extra: list) -> bool:
        t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            self._cmd + extra, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            stdout, stderr = self._proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            stdout, stderr = self._proc.communicate()
        self.out[key] = {"rc": self._proc.returncode, "stdout": stdout,
                         "stderr": stderr[-3000:],
                         "wall_s": time.perf_counter() - t0,
                         "end": time.perf_counter()}
        return self._proc.returncode == 0

    def resume(self) -> None:
        self._resume.set()

    def join(self) -> dict:
        self._thread.join()
        return self.out

    def stop(self) -> None:
        self._stopped = True
        self._resume.set()
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
        self._thread.join()


def _check_cli(root: str, cli: dict, card: str) -> dict:
    """Part 5's checks: both exit 0, 5 monitor rows, two generations, and
    the resumed process's round 5 equal to the same two rounds replayed
    here from the first process's round-3 checkpoint."""
    for key in ("first", "resume"):
        if key not in cli or cli[key]["rc"]:
            got = cli.get(key, {})
            raise AssertionError(f"durable CLI ({key}) exited "
                                 f"{got.get('rc')}: {got.get('stderr')}")
    work = os.path.join(root, "cli_durable")
    with open(os.path.join(work, "monitor_similarity.csv"), newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["Epoch_No.", "Avg_JSD", "Avg_WD"] or \
            [r[0] for r in rows[1:]] != [str(e) for e in range(5)]:
        raise AssertionError(f"monitor CSV rows {rows}")
    ckpt = os.path.join(work, "checkpoint")
    if list_resumable(ckpt) != [ckpt, ckpt + ".1"] or \
            os.path.exists(ckpt + ".2"):
        raise AssertionError(f"checkpoint generations {list_resumable(ckpt)}")
    if "at round 3" not in cli["resume"]["stdout"]:
        raise AssertionError("the resumed CLI did not start at round 3")
    final = [line for line in cli["resume"]["stdout"].splitlines()
             if line.startswith("final Avg_JSD=")]
    if not final:
        raise AssertionError("the resumed CLI printed no evaluation")
    done = load_federated(ckpt, device="cuda")
    replay = load_federated(os.path.join(root, "cli_round3"), device="cuda")
    replay.fit(2)
    if done.completed_epochs != 5 or replay.completed_epochs != 5:
        raise AssertionError("the resumed CLI did not reach round 5")
    _require_equal("CLI resumed process vs replay here", _trainer_state(done),
                   _trainer_state(replay))
    report = {"first_wall_s": cli["first"]["wall_s"],
              "resume_wall_s": cli["resume"]["wall_s"],
              "monitor_rows": [[float(v) for v in r[1:]] for r in rows[1:]],
              "final": final[0],
              # where each process's time went, in its own words
              "timing_lines": {key: [
                  line for line in cli[key]["stdout"].splitlines()
                  if line.startswith(("init done", "resumed from"))
                  or "rounds in" in line] for key in ("first", "resume")}}
    print(f"durable CLI: --epochs 3 --monitor-every 1 --save-every 1 "
          f"--ckpt-keep 2 --watchdog --eval exit 0 in "
          f"{report['first_wall_s']!r} s, then --resume --epochs 5 exit 0 in "
          f"{report['resume_wall_s']!r} s; monitor CSV rounds 0-4 "
          f"{report['monitor_rows']!r}; generations {list_resumable(ckpt)}; "
          f"the resumed process's round 5 == 2 rounds replayed here from its "
          f"round-3 checkpoint (torch.equal); {final[0]}; "
          f"{json.dumps(report['timing_lines'])}  [{card}]",
          flush=True)
    return report


def cond_sum_probe(spec: SegmentSpec, rows: int, card: str,
                   reps: int = 20) -> dict:
    """``cond_loss``'s per-column sums on the card with nothing else
    varying: ``index_add`` (float atomics) and the 0/1 membership product
    ``cond_loss`` uses, each ``reps`` times on the same (rows, n_opt)
    inputs, forward and backward through ``log`` as the loss takes them.
    Counts the distinct bit patterns of the sums and of the inputs'
    gradient, and times one forward and backward of each."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    tables = cond_tables(spec, torch.device("cuda"))
    x = torch.randn((rows, spec.n_opt), generator=gen, device="cuda")
    w = torch.randn((rows, spec.n_discrete), generator=gen, device="cuda")
    col_ids = tables["cond_column_ids"]
    variants = {
        "index_add": lambda v: v.new_zeros((rows, spec.n_discrete)).index_add(
            1, col_ids, v),
        "product": lambda v: v @ tables["member"],
    }
    report = {}
    for name, fn in variants.items():
        def once():
            v = x.clone().requires_grad_(True)
            sums = fn(torch.exp(v))
            (torch.log(sums) * w).sum().backward()
            return sums.detach(), v.grad

        sums, grads = set(), set()
        for _ in range(reps):
            a, g = once()
            sums.add(a.cpu().numpy().tobytes())
            grads.add(g.cpu().numpy().tobytes())
        report[name] = {"distinct_sums": len(sums),
                        "distinct_grads": len(grads),
                        "fwd_bwd_ms": cuda_ms(once, 50)}
    print(f"cond_loss column sums at ({rows}, {spec.n_opt}) -> "
          f"{spec.n_discrete} columns, {reps} runs on the same inputs: "
          f"{json.dumps(report)}  [{card}]", flush=True)
    if report["product"]["distinct_sums"] != 1 or \
            report["product"]["distinct_grads"] != 1:
        raise AssertionError("the 0/1 product's column sums vary between "
                             "runs")
    return report


def fed_durability_phase(init, root: str, seed: int, card: str,
                         cli_run: DurableCLI) -> dict:
    """Durable federated rounds at the target configuration (the init of
    ``fed_round_phase``, ``TrainConfig()``, the similarity monitor at
    10,000 rows after every round), while ``cli_run`` runs the durable
    CLI in processes of its own.

    0. ``cond_loss``'s column sums, ``index_add`` against the 0/1
       product (:func:`cond_sum_probe`).
    1. Determinism: two runs of ``DUR_ROUNDS`` monitored rounds from one
       seed are bit-equal (every parameter, buffer, Adam moment and
       generator state, and every monitor read); K1/K2 launches per
       monitored round exact.
    2. Resume: the second run saved after rounds 1 and 2; its newest
       generation loaded into a fresh trainer and run to ``DUR_ROUNDS``
       equals the uninterrupted run, monitor reads from round 2 included.
    3. Crash-safe save: ``crash_checkpoint:save=2`` (keep 2) tears the
       second save; the first generation loads and resumes to the end.
    4. Watchdog: the gate off, client 1's update scaled x1e6 after the
       training of the round before the last (``scale_update:factor=1e6,
       rank=1,round=2,until=2`` for 3 rounds): an alarm in the last round,
       a rollback to the poisoned newest generation, an alarm again, a
       rollback to the older one, the learning rate halved each time,
       ``DUR_ROUNDS`` rounds done (the CPU test's prediction).
    5. The CLI (see ``DurableCLI``).
    6. Timings: the monitor probe per read and its device time; save and
       load; seconds per round with and without the monitor and a save."""
    cfg = steps.TrainConfig()
    csv_path = os.path.join(root, "intrusion.csv")
    monitor = SimilarityMonitor(init.global_meta, init.encoders,
                                read_csv(csv_path), n_rows=MONITOR_ROWS,
                                seed=seed, device="cuda")
    monitor_k1 = []

    def monitored(reads, ckpt=None, keep=1):
        def hook(e, tr):
            k1 = fused_apply_activate.launches
            reads.append(monitor.evaluate(tr, seed=seed + e))
            monitor_k1.append(fused_apply_activate.launches - k1)
            if ckpt is not None:
                save_federated(tr, ckpt, run_name="Intrusion", keep=keep)
        return hook

    # 1. determinism, with launch counts over the first run
    reads_a, reads_b = [], []
    run_a = FederatedTrainer(init, cfg, seed=seed, device="cuda")
    column_sums = cond_sum_probe(run_a.spec, cfg.batch_size, card)
    max_steps = int(run_a.steps.max())
    fused_apply_activate.launches = 0
    fused_activate_bwd.launches = 0
    run_a.fit(DUR_ROUNDS, sample_hook=monitored(reads_a))
    launches = {"K1": fused_apply_activate.launches,
                "K2": fused_activate_bwd.launches}
    per_round = {"K1": max_steps * (cfg.d_steps + 1) + 1, "K2": max_steps}
    want = {k: DUR_ROUNDS * v for k, v in per_round.items()}
    if launches != want or monitor_k1 != [1] * DUR_ROUNDS:
        raise AssertionError(f"durable launches {launches} (monitor "
                             f"{monitor_k1}) != {want}")
    monitor_launches = sum(monitor_k1)
    ckpt = os.path.join(root, "dur_ckpt")
    run_b = FederatedTrainer(init, cfg, seed=seed, device="cuda")
    run_b.fit(2, sample_hook=monitored(reads_b, ckpt, keep=2))
    run_b.fit(DUR_ROUNDS - 2, sample_hook=monitored(reads_b))
    state_a = _trainer_state(run_a)
    _require_equal("two runs from one seed", state_a, _trainer_state(run_b))
    if reads_a != reads_b:
        raise AssertionError(f"monitor reads differ: {reads_a} vs {reads_b}")
    # 2. resume from the round-2 generation
    src = find_resumable(ckpt)
    run_c = load_federated(src, device="cuda")
    reads_c = []
    run_c.fit(DUR_ROUNDS - 2, sample_hook=monitored(reads_c))
    if run_c.completed_epochs != DUR_ROUNDS:
        raise AssertionError(f"resumed to round {run_c.completed_epochs}")
    _require_equal("resumed vs uninterrupted", _trainer_state(run_c), state_a)
    if reads_c != reads_a[2:]:
        raise AssertionError(f"resumed monitor reads {reads_c} vs "
                             f"{reads_a[2:]}")
    print(f"durability: {DUR_ROUNDS} monitored rounds twice from seed {seed} "
          f"bit-equal ({len(state_a)} tensors, {DUR_ROUNDS} monitor reads); "
          f"2 rounds + save + load + {DUR_ROUNDS - 2} == {DUR_ROUNDS} "
          f"uninterrupted, reads from round 2 equal; Avg_JSD by round "
          f"{[r['avg_jsd'] for r in reads_a]!r}, Avg_WD "
          f"{[r['avg_wd'] for r in reads_a]!r}; launches {launches} "
          f"(expected {want}: per round {max_steps} stacked steps x "
          f"{cfg.d_steps + 1} K1 + 1 monitor K1 at ({MONITOR_ROWS}, "
          f"{run_a.spec.dim}))  [{card}]", flush=True)

    # 3. a crash in the second save
    crash = os.path.join(root, "crash_ckpt")
    install_plan(FaultPlan.parse("crash_checkpoint:save=2"))
    try:
        save_federated(run_c, crash, run_name="Intrusion", keep=2)
        run_c.fit(1)
        try:
            save_federated(run_c, crash, run_name="Intrusion", keep=2)
        except FaultInjected:
            pass
        else:
            raise AssertionError("the second save did not crash")
    finally:
        install_plan(None)
    torn = [e for e in os.listdir(root) if e.startswith("crash_ckpt.tmp-")]
    if find_resumable(crash) != crash or not torn:
        raise AssertionError(f"after the crash: {find_resumable(crash)}, "
                             f"stages {torn}")
    run_d = load_federated(crash, device="cuda")
    if run_d.completed_epochs != DUR_ROUNDS:
        raise AssertionError(f"crash left round {run_d.completed_epochs}")
    run_d.fit(1)
    _require_equal("resumed after the crash", _trainer_state(run_d),
                   _trainer_state(run_c))
    print(f"crash-safe save: crash_checkpoint:save=2 tore save 2 (stage "
          f"{torn} left), find_resumable -> round {DUR_ROUNDS}, resumed to "
          f"round {run_d.completed_epochs} == the uncrashed run  [{card}]",
          flush=True)

    # 4. the watchdog
    wd_cfg = dataclasses.replace(cfg, update_gate=False)
    wd_ckpt = os.path.join(root, "wd_ckpt")
    wd = TrainingWatchdog(WatchdogConfig(loss_threshold=50.0,
                                         max_rollbacks=2))
    alarms, restored, done = [], [], []
    health = wd.health_cb

    def timed_health(e, metrics):
        try:
            health(e, metrics)
        except WatchdogAlarm:
            alarms.append((e, time.perf_counter()))
            raise

    wd.health_cb = timed_health

    def saver(e, tr):
        done.append((e, time.perf_counter()))
        save_federated(tr, wd_ckpt, run_name="Intrusion", keep=2)

    def on_rollback(tr):
        restored.append(tr.completed_epochs)
        install_plan(None)

    run_w = FederatedTrainer(init, wd_cfg, seed=seed, device="cuda")
    last = DUR_ROUNDS - 1
    install_plan(FaultPlan.parse(f"scale_update:factor=1e6,rank=1,"
                                 f"round={last},until={last}"))
    try:
        run_w = fit_with_watchdog(run_w, DUR_ROUNDS, wd, wd_ckpt,
                                  fit_kwargs=dict(sample_hook=saver),
                                  on_rollback=on_rollback)
    finally:
        install_plan(None)
    rollback_s = [next(t for e, t in done if t > ta) - ta for _, ta in alarms]
    print(f"watchdog: alarms at rounds {[e for e, _ in alarms]}, restored "
          f"generations at rounds {restored}, {wd.rollbacks} rollbacks, "
          f"final lr {run_w.cfg.lr!r} (from {cfg.lr!r}), "
          f"{run_w.completed_epochs} rounds done; alarm to the next finished "
          f"round {rollback_s!r} s  [{card}]", flush=True)
    if (wd.rollbacks, restored, run_w.completed_epochs, [e for e, _ in alarms]
            ) != (2, [last, last - 1], DUR_ROUNDS, [last, last]) or \
            not math.isclose(run_w.cfg.lr, cfg.lr / 4):
        raise AssertionError("the watchdog did not roll back as the CPU "
                             "test predicts")
    if not all(torch.isfinite(p).all() for m in run_w.models
               for p in m.generator.parameters()):
        raise AssertionError("non-finite generator after the rollbacks")

    # 5. the CLI, in its own processes since before this phase
    cli = cli_run.join()
    cli_report = _check_cli(root, cli, card)
    overlap = cli.get("resume", {}).get("end", 0.0) > alarms[-1][1]

    # 6. timings, the CLI finished
    probe_ms = []
    for k in range(5):
        t0 = time.perf_counter()
        monitor.evaluate(run_a, seed=seed + 100 + k)
        probe_ms.append((time.perf_counter() - t0) * 1e3)
    probe_device = device_profile(lambda: monitor.evaluate(run_a, seed=seed),
                                  3)
    tpath = os.path.join(root, "timed_ckpt")
    save_s, load_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_federated(run_a, tpath)
        save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        load_federated(tpath, device="cuda")
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
    mb = sum(os.path.getsize(os.path.join(tpath, f))
             for f in os.listdir(tpath)) / 1e6
    n0 = len(run_a.epoch_times)
    run_a.fit(2)
    plain = run_a.epoch_times[n0:]
    run_a.fit(2, sample_hook=monitored([], tpath))
    hooked = run_a.epoch_times[n0 + 2:]
    timings = {"monitor_probe_ms": probe_ms, "monitor_device": probe_device,
               "save_s": save_s, "load_s": load_s, "checkpoint_mb": mb,
               "s_per_round_plain": plain,
               "s_per_round_monitor_and_save": hooked,
               "rollback_s": rollback_s,
               "cli_running_during_watchdog": overlap}
    print(f"durability timings: monitor probe {probe_ms!r} ms per read "
          f"({MONITOR_ROWS} rows), device {json.dumps(probe_device)}; "
          f"save_federated {save_s!r} s for {mb!r} MB; load_federated "
          f"{load_s!r} s; s/round {plain!r} plain vs {hooked!r} with the "
          f"monitor and a save; rollback {rollback_s!r} s (the CLI "
          f"{'still' if overlap else 'no longer'} running)  [{card}]",
          flush=True)
    return {"launches": launches, "launches_per_round": per_round,
            "monitor_launches": monitor_launches,
            "reads": [{k: r[k] for k in ("avg_jsd", "avg_wd")}
                      for r in reads_a],
            "watchdog": {"alarm_rounds": [e for e, _ in alarms],
                         "restored": restored, "rollbacks": wd.rollbacks,
                         "final_lr": run_w.cfg.lr},
            "cli": cli_report, "timings": timings,
            "cond_column_sums": column_sums}


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
    service = SamplingService(ModelRegistry(art, device="cuda",
                                            log=_silent)).start()
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
        z, c, u = engine.draw(engine.snapshot(), seed + synth.key_offset, 0,
                              steps, None)
        t = tick("draws", t)
        with torch.no_grad():
            x = torch.cat([z, c], dim=1)
            raw = torch.cat([synth.generator(b) for b in x.split(B)])
        t = tick("generator", t)
        enc = fused_apply_activate(raw, spec, u)
        t = tick("activation", t)
        mat = layout_decode(enc, engine._tables).cpu().numpy()[:rows]
        t = tick("decode_d2h", t)
        blob = engine.csv_plan.csv_bytes(decode_cells(
            mat, engine.model.meta, engine.model.encoders))
        tick("csv", t)
    ms = {k: statistics.median(v[1:]) * 1e3 for k, v in times.items()}
    total = sum(ms.values())
    print(f"stages of one {rows}-row request ({steps} steps x {B} rows), "
          "median ms: " + ", ".join(
              f"{k} {v!r} ({100 * v / total:.1f}%)" for k, v in ms.items())
          + f"  [{card}]", flush=True)
    # the compiled formatter against the stdlib writer on this request
    t0 = time.perf_counter()
    plain = plain_csv_bytes(decode_columns(mat, engine.model.meta,
                                           engine.model.encoders))
    ms["csv_plain"] = (time.perf_counter() - t0) * 1e3
    if blob != plain:
        raise AssertionError("served CSV bytes differ from the stdlib "
                             "writer's")
    print(f"serving formatter: a {rows}-row request's CSV is byte-equal to "
          f"the stdlib writer's ({len(plain)} bytes); compiled "
          f"{ms['csv']!r} ms ({fastcsv.default_threads(rows)} threads) vs "
          f"stdlib {ms['csv_plain']!r} ms  [{card}]", flush=True)
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
    # keep the card path's own K1 operands and result, to say where a
    # difference arises if one does
    seen, launch = {}, steps.fused_apply_activate

    def keep(x, sp, u):
        out = launch(x, sp, u)
        seen.update(x=x, u=u, out=out)
        return out

    steps.fused_apply_activate = keep
    try:
        enc_g = gpu.sample_encoded(n, seed=seed, draws=draws)
    finally:
        steps.fused_apply_activate = launch
    enc_c = cpu.sample_encoded(n, seed=seed, draws=draws)
    err = float(np.abs(enc_g - enc_c).max())

    # where a difference comes from: the generator's logits on the two
    # devices, and K1 against its plain version on the same logits
    def logits(engine):
        z, c, u = engine.draw(engine.snapshot(),
                              seed + engine.model.synth.key_offset, 0, 2,
                              None, draws)
        with torch.no_grad():
            return torch.cat([engine.model.synth.generator(b) for b in
                              torch.cat([z, c], 1).split(cfg.batch_size)]), u

    raw_g, _ = logits(gpu)
    raw_c, u_c = logits(cpu)
    raw_err = float((raw_g.cpu() - raw_c).abs().max())
    k1_err = float((fused_apply_activate(raw_c.cuda(), spec, u_c.cuda()).cpu()
                    - apply_activate(raw_c, spec, u_c)).abs().max())
    path_x = float((seen["x"] - raw_g).abs().max())
    path_u = float((seen["u"].cpu() - u_c).abs().max())
    path_k1 = float((fused_apply_activate(seen["x"].clone(), spec,
                                          seen["u"].clone())
                     - seen["out"]).abs().max())
    ptrs = [seen[k].data_ptr() % 512 for k in ("x", "u", "out")]
    print(f"reference: the card path's K1 operands vs this phase's: logits "
          f"{path_x!r}, uniforms {path_u!r}; K1 again on copies of them vs "
          f"its result {path_k1!r}; operand addresses mod 512 {ptrs}"
          f"  [{card}]", flush=True)
    print(f"reference: generator logits card vs CPU max_abs_err {raw_err!r}; "
          f"K1 vs plain on the CPU's logits {k1_err!r}; matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}, TF32 override "
          f"{os.environ.get('TORCH_ALLOW_TF32_CUBLAS_OVERRIDE')!r}  [{card}]",
          flush=True)
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
        # say where, and whether the card gives the same rows again
        r, c = np.unravel_index(np.abs(enc_g - enc_c).argmax(), enc_g.shape)
        again = gpu.sample_encoded(n, seed=seed, draws=draws)
        plain_path = apply_activate(seen["x"].cpu(), spec, seen["u"].cpu())
        for d in np.flatnonzero(spec.segment_ids == spec.segment_ids[c]):
            print(f"reference: row {r} dim {d}: card path logit "
                  f"{float(seen['x'][r, d])!r}, uniform "
                  f"{float(seen['u'][r, d])!r}, K1 "
                  f"{float(seen['out'][r, d])!r}, plain on them "
                  f"{float(plain_path[r, d])!r}; CPU logit "
                  f"{float(raw_c[r, d])!r}, uniform {float(u_c[r, d])!r}, "
                  f"plain {float(enc_c[r, d])!r}  [{card}]", flush=True)
        raise AssertionError(
            f"card vs CPU encoded error {err} > 1e-4 at row {r}, dim {c} "
            f"({'tanh' if spec.is_tanh_dim[c] else 'softmax'}, segment "
            f"{spec.segment_ids[c]}, near-tie row {bool(near[r])}): card "
            f"{enc_g[r, c]!r} vs CPU {enc_c[r, c]!r}, logits "
            f"{float(raw_g[r, c])!r} vs {float(raw_c[r, c])!r}, u "
            f"{float(u_c[r, c])!r}; the card again: error "
            f"{float(np.abs(again - enc_c).max())!r} vs the CPU, "
            f"{float(np.abs(again - enc_g).max())!r} vs its first rows")


# ------------------------------------------------------------ serving fleet

# the fleet phase: three Intrusion-layout tenants (alpha and beta with
# equal weights, gamma with others) and one Adult-layout tenant, served by
# 2 workers behind the asyncio front door with a 5 ms coalesce window and
# a row pool; 16 closed-loop clients, each sending FLEET_REQUESTS
# 5,000-row requests to the tenants in turn
FLEET_TENANTS = (("alpha", "intrusion", 0), ("beta", "intrusion", 0),
                 ("gamma", "intrusion", 7), ("adult", "adult", 0))
FLEET_CLIENTS, FLEET_REQUESTS = 16, 4


def _silent(*args, **kwargs) -> None:
    pass


class LaneLog:
    """The member count of every lane dispatch of ``svc`` (recorded beside
    the fleet's own lane metrics) and the host seconds of each one's
    device work (``lane_pass``)."""

    def __init__(self, svc):
        self.sizes, self.seconds = [], []
        record, run = svc.metrics.record_lane_dispatch, svc.lane_pass

        def note(n):
            self.sizes.append(n)
            record(n)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = run(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            return out

        svc.metrics.record_lane_dispatch = note
        svc.lane_pass = timed


def _load(clients: int, requests: list, url_of) -> dict:
    """``clients`` closed-loop keep-alive clients; client ``c`` sends
    ``requests[c]`` (a list of (tenant, rows, seed)) one after another.
    Returns the bodies by (client, index), each request's latency and the
    wall time."""
    import http.client

    bodies, lat, errors = {}, [], []

    def client(c):
        conns = {}
        try:
            for k, (tenant, n, seed) in enumerate(requests[c]):
                host, port, path = url_of(tenant)
                conn = conns.get((host, port))
                if conn is None:
                    conn = conns[(host, port)] = http.client.HTTPConnection(
                        host, port, timeout=120)
                t0 = time.perf_counter()
                conn.request("GET", f"{path}?rows={n}&seed={seed}")
                resp = conn.getresponse()
                body = resp.read()
                lat.append(time.perf_counter() - t0)
                bodies[(c, k)] = (resp.status, body)
        except Exception as exc:  # noqa: BLE001 — fatal below
            errors.append(repr(exc))
        finally:
            for conn in conns.values():
                conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"fleet load: client errors {errors[:3]}")
    return {"bodies": bodies, "latencies": lat, "wall": wall}


def _load_stats(run: dict, rows: int) -> dict:
    lat = sorted(run["latencies"])
    return {"rows_per_s": rows * len(lat) / run["wall"],
            "p50_ms": statistics.median(lat) * 1e3,
            "p99_ms": lat[min(len(lat) - 1, round(0.99 * (len(lat) - 1)))]
            * 1e3, "max_ms": lat[-1] * 1e3, "requests": len(lat),
            "wall_s": run["wall"]}


def _check_bodies(run: dict, mix: list, want: dict) -> None:
    for (c, k), (status, body) in run["bodies"].items():
        if status != 200 or body != want[mix[c][k]]:
            raise AssertionError(f"request {mix[c][k]}: status {status}, "
                                 "bytes differ from the tenant's single "
                                 f"engine ({body[:300]!r})")


def fleet_phase(seed: int, rows: int, card: str, build_root: str) -> dict:
    """The serving process and the fleet at full width on the card (see
    the module docstring, phase 4)."""
    import urllib.error

    from fed_tgan_torch.serve.fleet import (
        FleetRegistry,
        FleetService,
        TokenBucket,
        _FleetRequest,
        _Member,
    )
    from fed_tgan_torch.serve.pool import RowPool
    from fed_tgan_torch.serve.registry import ModelRegistry
    from fed_tgan_torch.serve.service import SamplingService

    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_", dir=build_root)
    try:
        arts = {name: build_random_artifact(os.path.join(root, name),
                                            seed=seed + s, table=table)
                for name, table, s in FLEET_TENANTS}
        names = [name for name, _, _ in FLEET_TENANTS]
        # request k of client c: tenant in turn, a seed of its own
        mix = [[(names[(c + k) % len(names)], rows,
                 1000 + c * FLEET_REQUESTS + k)
                for k in range(FLEET_REQUESTS)] for c in range(FLEET_CLIENTS)]
        singles = {name: SamplingEngine(open_model(art, device="cuda"))
                   for name, art in arts.items()}
        want = {(t, n, s): singles[t].sample_csv_bytes(n, seed=s)
                for reqs in mix for t, n, s in reqs}
        if singles["alpha"].sample_csv_bytes(rows, seed=1) != \
                singles["beta"].sample_csv_bytes(rows, seed=1):
            raise AssertionError("equal-weight tenants serve other bytes")
        if singles["alpha"].sample_csv_bytes(rows, seed=1) == \
                singles["gamma"].sample_csv_bytes(rows, seed=1):
            raise AssertionError("tenants of other weights serve equal bytes")

        fleet = FleetRegistry(device="cuda", log=_silent)
        for name, art in arts.items():
            fleet.load(name, art)
        pool = RowPool(fleet)
        B = fleet.get("alpha").engine.cfg.batch_size
        chunk_rows = fleet.get("alpha").engine.max_chunk_steps * B
        if rows > chunk_rows or pool.chunk_rows + B > chunk_rows:
            raise AssertionError("a request or a pool fill spans chunks: "
                                 "the K1 count below assumes one apiece")
        svc = FleetService(fleet, workers=2, coalesce_window_s=0.005,
                           row_pool=pool, http_mode="asyncio",
                           reload_interval_s=0.2, log=_silent).start()
        lanes = LaneLog(svc)
        base = urllib.parse.urlsplit(svc.url)
        fleet_url = lambda t: (base.hostname, base.port, f"/t/{t}/sample")
        servers = {name: SamplingService(
            ModelRegistry(art, device="cuda", log=_silent),
            reload_interval_s=0, log=_silent).start()
            for name, art in arts.items()}

        def single_url(t):
            u = urllib.parse.urlsplit(servers[t].url)
            return u.hostname, u.port, "/sample"

        try:
            # one untimed request per tenant through each side first: a
            # worker's first GEMM, batch norm or lane shape pays one-time
            # costs (library handles, allocator growth)
            warm_mix = [[reqs[0]] for reqs in mix[:len(names)]]
            slowest = []
            for url_of in (fleet_url, single_url):
                warm = _load(len(names), warm_mix, url_of)
                _check_bodies(warm, warm_mix, want)
                slowest.append(max(warm["latencies"]) * 1e3)
            print(f"fleet warm-up: one request per tenant through each side; "
                  f"slowest {slowest[0]!r} ms (fleet), {slowest[1]!r} ms "
                  f"(single services)  [{card}]", flush=True)
            lanes.seconds.clear()
            lanes.sizes.clear()
            warm_counts = svc.metrics.snapshot()
            warm_fills = pool.stats()["fills"]
            # the main path: every count set to 0 just before it
            fused_apply_activate.launches = 0
            fleet_runs, single_runs = [], []
            for turn in range(2):  # in turns: fleet, single, fleet, single
                fleet_runs.append(_load(FLEET_CLIENTS, mix, fleet_url))
                if turn == 0:
                    launches = fused_apply_activate.launches
                    # the first timed turn alone (the warm-up taken out)
                    snap = {k: v - warm_counts[k] for k, v in
                            svc.metrics.snapshot().items() if k in (
                                "lane_dispatches_total",
                                "lane_requests_total", "pool_hits_total",
                                "batches_total", "requests_total")}
                    snap["batch_occupancy"] = (
                        (snap["requests_total"] - snap["pool_hits_total"])
                        / snap["batches_total"])
                    # each request of the mix and each pool fill is one
                    # chunk, so one K1 launch apiece outside the lanes
                    singles_n = (snap["requests_total"]
                                 - snap["lane_requests_total"]
                                 - snap["pool_hits_total"])
                    fills = pool.stats()["fills"] - warm_fills
                    want_k1 = (snap["lane_dispatches_total"] + singles_n
                               + fills)
                    if launches != want_k1:
                        raise AssertionError(
                            f"K1 launched {launches} times, expected "
                            f"{snap['lane_dispatches_total']} lane "
                            f"dispatches + {singles_n} single dispatches "
                            f"+ {fills} pool fills")
                    sizes = sorted(lanes.sizes)
                    lane_s = sorted(lanes.seconds)
                single_runs.append(_load(FLEET_CLIENTS, mix, single_url))
            for run in fleet_runs + single_runs:
                _check_bodies(run, mix, want)
            if max(lanes.sizes, default=0) < 4:  # over both fleet turns
                raise AssertionError(f"no lane dispatch of 4+ lanes: "
                                     f"{sorted(lanes.sizes)}")
            fleet_stats = [_load_stats(r, rows) for r in fleet_runs]
            single_stats = [_load_stats(r, rows) for r in single_runs]
            for name, f_st, s_st in zip(("first", "second"), fleet_stats,
                                        single_stats):
                print(f"fleet vs single-model services ({name} turn): "
                      f"{FLEET_CLIENTS} clients x {FLEET_REQUESTS} "
                      f"{rows}-row requests: fleet {f_st['rows_per_s']!r} "
                      f"rows/s, p50 {f_st['p50_ms']!r} ms, p99 "
                      f"{f_st['p99_ms']!r} ms, max {f_st['max_ms']!r} ms; "
                      f"single {s_st['rows_per_s']!r} rows/s, p50 "
                      f"{s_st['p50_ms']!r} ms, p99 {s_st['p99_ms']!r} ms, max "
                      f"{s_st['max_ms']!r} ms  [{card}]", flush=True)
            print(f"fleet lanes (first turn): {snap['lane_dispatches_total']} "
                  f"lane dispatches for {snap['lane_requests_total']} "
                  f"requests (sizes {sizes}; device work of one: median "
                  f"{statistics.median(lane_s) * 1e3!r} ms, max "
                  f"{lane_s[-1] * 1e3!r} ms), batch occupancy "
                  f"{snap['batch_occupancy']}, pool hits "
                  f"{snap['pool_hits_total']}; K1 launches {launches} "
                  f"= {snap['lane_dispatches_total']} lane dispatches + "
                  f"{singles_n} single dispatches + {fills} pool fills; "
                  f"every body equal to the single engine's  [{card}]",
                  flush=True)

            # chunked fetches through the front door equal one-shot ones
            q = lambda **kw: (f"{svc.url}/t/gamma/sample?"
                              f"{urllib.parse.urlencode(kw)}")
            one = fetch(q(rows=rows, seed=seed))[1]
            cuts = [0, rows // 3, 2 * rows // 3, rows]
            parts = [fetch(q(rows=b - a, seed=seed, offset=a,
                             header=int(a == 0)))[1]
                     for a, b in zip(cuts, cuts[1:])]
            if b"".join(parts) != one or one != \
                    singles["gamma"].sample_csv_bytes(rows, seed=seed):
                raise AssertionError("fleet chunked bytes differ")
            # a pool hit: the same rows again and again make the key hot
            for _ in range(pool.hot_after + 1):
                fetch(q(rows=1000, seed=seed + 1))
            pool.fill_once()
            hits = pool.stats()["hits"]
            body = fetch(q(rows=1000, seed=seed + 1))[1]
            if pool.stats()["hits"] != hits + 1 or body != \
                    singles["gamma"].sample_csv_bytes(1000, seed=seed + 1):
                raise AssertionError("pool hit missing or bytes differ")

            # a new generation of gamma published under fire
            old = fetch(q(rows=rows, seed=seed + 2))[1]
            reg = fleet.get("gamma").registry
            reloads, real = [], reg.maybe_reload

            def timed_reload():
                t0 = time.perf_counter()
                done = real()
                if done:
                    reloads.append(time.perf_counter() - t0)
                return done

            reg.maybe_reload = timed_reload
            seen, stop = [], threading.Event()

            def hammer():
                while not stop.is_set():
                    try:
                        seen.append(fetch(q(rows=rows, seed=seed + 2)))
                    except urllib.error.HTTPError as exc:
                        seen.append((exc.code, b"", 0.0))

            threads = [threading.Thread(target=hammer) for _ in range(4)]
            for t in threads:
                t.start()
            build_random_artifact(arts["gamma"], seed=seed + 99)
            new = SamplingEngine(open_model(arts["gamma"], device="cuda")) \
                .sample_csv_bytes(rows, seed=seed + 2)
            deadline = time.monotonic() + 30
            while fetch(q(rows=rows, seed=seed + 2))[1] != new:
                if time.monotonic() > deadline:
                    raise AssertionError("the new generation never served")
                time.sleep(0.02)
            time.sleep(0.2)
            stop.set()
            for t in threads:
                t.join(timeout=60)
            if not seen or any(st != 200 or b not in (old, new)
                               for st, b, _ in seen):
                raise AssertionError("a response under reload was neither "
                                     "the old nor the new model's")
            print(f"reload under fire: {len(seen)} responses, each the old "
                  f"or the new model's bytes; the new one served after; one "
                  f"reload (probe, fingerprint, load to the card) "
                  f"{reloads[0] * 1e3!r} ms  [{card}]", flush=True)

            # a quota tenant is shed with 429 while the others get 200
            fleet.load("quota", arts["alpha"])
            fleet.get("quota").bucket = TokenBucket(rate=0.01, burst=2.0)
            statuses = []
            for _ in range(4):
                try:
                    statuses.append(fetch(f"{svc.url}/t/quota/sample"
                                          "?rows=10")[0])
                except urllib.error.HTTPError as exc:
                    statuses.append(exc.code)
            others = [fetch(f"{svc.url}/t/{t}/sample?rows=10")[0]
                      for t in names]
            if statuses != [200, 200, 429, 429] or set(others) != {200}:
                raise AssertionError(f"quota: {statuses}, others {others}")
            fleet.evict("quota")
        finally:
            for s in servers.values():
                s.shutdown()
            svc.shutdown(drain=True)

        # a backlog on one worker: K1 exactly once per lane dispatch, then
        # a drained shutdown answers everything queued
        seam = FleetService(fleet, max_batch=16, reload_interval_s=0,
                            log=_silent)
        backlog = [_FleetRequest(t, rows, 7 + i, 0, None, True)
                   for i, t in enumerate(names * 4)]
        for r in backlog:
            seam.submit(fleet.get(r.tenant), r)
        before = fused_apply_activate.launches
        seam.start_workers()
        seam.shutdown(drain=True)
        sn = seam.metrics.snapshot()
        seam_k1 = fused_apply_activate.launches - before
        fleet_engines = {t: fleet.get(t).engine for t in names}
        for r in backlog:
            if not r.done.is_set() or r.status != 200 or r.result != \
                    fleet_engines[r.tenant].sample_csv_bytes(rows,
                                                             seed=r.seed):
                raise AssertionError("drained backlog: a request unanswered "
                                     "or its bytes differ")
        if sn["lane_dispatches_total"] != seam_k1 or \
                sn["lane_requests_total"] != len(backlog):
            raise AssertionError(f"K1 launches {seam_k1} != lane dispatches "
                                 f"{sn['lane_dispatches_total']}")
        print(f"fleet backlog of {len(backlog)} requests on one worker: "
              f"{sn['lane_dispatches_total']} lane dispatches, K1 launched "
              f"{seam_k1} times (once per lane dispatch); drained shutdown "
              f"answered all  [{card}]", flush=True)

        # the stages of one 8-lane dispatch, synchronised at each boundary
        seam = FleetService(fleet, log=_silent)
        intrusion = [t for t in names if t != "adult"]
        B = fleet.get("alpha").engine.cfg.batch_size
        steps = fleet.get("alpha").engine._chunk_plan(0, -(-rows // B))[0][1]
        members = []
        for i in range(8):
            rt = fleet.get(intrusion[i % 3])
            members.append(_Member(_FleetRequest(rt.name, rows, 50 + i, 0,
                                                 None, True), rt,
                                   rt.engine.snapshot(), 0, 0))
        times = {}

        def tick(stage):
            torch.cuda.synchronize()
            now = time.perf_counter()
            times.setdefault(stage, []).append(now - tick.t)
            tick.t = now

        for _ in range(6):
            torch.cuda.synchronize()
            tick.t = time.perf_counter()
            host = seam.lane_pass(members, steps, tick=tick)
            for i, m in enumerate(members):
                m.snap.csv_plan.csv_bytes(decode_cells(
                    host[i, :rows], m.snap.model.meta, m.snap.model.encoders))
            tick("csv")
        stages = {k: statistics.median(v[1:]) * 1e3 for k, v in times.items()}
        print(f"stages of one 8-lane dispatch ({steps} steps x {B} rows a "
              "lane), median ms: " + ", ".join(
                  f"{k} {v!r}" for k, v in stages.items()) + f"  [{card}]",
              flush=True)
        # the lanes' generator pass against the single path's loop
        x = torch.randn((8, steps * B, members[0].snap.spec.n_opt
                         + fleet.get("alpha").engine.cfg.embedding_dim),
                        device="cuda")
        group = seam.lane_group([m.snap for m in members])
        gens = [m.snap.model.synth.generator for m in members]

        def loop():
            with torch.no_grad():
                for i, g in enumerate(gens):
                    torch.cat([g(b) for b in x[i].split(B)])

        gen_ms = {"lanes": cuda_ms(lambda: group.generator(x, B), 10),
                  "per_lane_loop": cuda_ms(loop, 10)}
        print(f"generator of 8 lanes x {steps} steps: stacked "
              f"{gen_ms['lanes']!r} ms, the single path's loop "
              f"{gen_ms['per_lane_loop']!r} ms  [{card}]", flush=True)
        return {"launches": launches, "lane_sizes": sizes,
                "lane_dispatches": snap["lane_dispatches_total"],
                "batch_occupancy": snap["batch_occupancy"],
                "fleet": fleet_stats, "single": single_stats,
                "reload_ms": reloads[0] * 1e3, "lane_stages_ms": stages,
                "generator_ms": gen_ms, "lane_rows": 8 * steps * B,
                "spec": members[0].snap.spec}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------- canary and date columns

DATED_ROWS, DATED_SNAPSHOT_ROWS, DATED_REQUEST_ROWS = 4_000, 10_000, 5_000
DATED_FORMATS = {"when": "YYYY-MM-DD", "stamp": "yymmdd|YYYY-MM-DD"}


class TrafficLoop:
    """One client requesting ``url`` back to back in a thread until
    :meth:`stop`; keeps every body and the request count."""

    def __init__(self, url: str):
        self.url, self.bodies, self.errors = url, [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                status, body, _ = fetch(self.url)
                self.bodies.append((status, body))
            except Exception as exc:  # noqa: BLE001 — fatal in stop()
                self.errors.append(repr(exc))
                return

    def stop(self) -> list:
        self._stop.set()
        self._thread.join(timeout=300)
        if self.errors:
            raise AssertionError(f"traffic during a decision: {self.errors}")
        return self.bodies


def canary_phase(synth, meta, encoders, seed: int, card: str,
                 build_root: str, rows: int) -> dict:
    """Canary promotion at full width on the card, on the model
    ``train_phase`` trained, written with reference statistics of its
    training table: a degraded generation rejected under traffic, a clean
    one promoted to the bytes immediate mode serves, two tenants of a fleet
    deciding apart, and statistics derived from the serving model."""
    from fed_tgan_torch.federation.sketch import wd_scores
    from fed_tgan_torch.runtime.checkpoint import (
        SYNTH_DIR,
        load_synthesizer,
        save_synthesizer,
    )
    from fed_tgan_torch.serve.canary import (
        compute_reference_stats,
        reference_stats_path,
        wd_call,
        wd_inputs,
        write_reference_stats,
    )
    from fed_tgan_torch.serve.demo import intrusion_like_raw
    from fed_tgan_torch.serve.fleet import FleetRegistry, FleetService
    from fed_tgan_torch.testing.faults import degrade_checkpoint

    root = tempfile.mkdtemp(prefix="chip_smoke_canary_", dir=build_root)
    stats = compute_reference_stats(
        intrusion_like_raw(TRAIN_ROWS, seed), meta.categorical_columns,
        name=meta.name, probe_rows=64)
    synth_dir = lambda art: os.path.join(art, "models", SYNTH_DIR)

    def artifact(name: str, with_stats: bool = True) -> str:
        art = write_artifact(os.path.join(root, name), synth.to_saved(),
                             meta, encoders)
        if with_stats:
            write_reference_stats(stats, reference_stats_path(
                os.path.join(art, "models"), meta.name))
        return art

    def republish(art: str) -> None:
        """The clean candidate: the trained weights, stream offset + 1000."""
        clean = load_synthesizer(os.path.join(root, "clean", "models",
                                              SYNTH_DIR), device="cuda")
        clean.key_offset += 1000
        save_synthesizer(clean, synth_dir(art))

    decisions, samples = [], 0

    def checked(gates, poll, what: str, requests=lambda: 0) -> None:
        """Run the promotion poll ``poll()``: the K1 launches during it
        must be one per shadow sample of ``gates`` (one chunk each), plus
        one per request ``requests()`` counts after the poll."""
        nonlocal samples
        k1 = fused_apply_activate.launches
        drawn = [g.shadow_samples for g in gates]
        poll()
        served = requests()
        n = sum(g.shadow_samples - d for g, d in zip(gates, drawn))
        got = fused_apply_activate.launches - k1
        if got != n + served:
            raise AssertionError(f"canary {what}: {got} K1 launches for {n} "
                                 f"shadow samples and {served} requests")
        decisions.extend(g.last_decision for g in gates)
        samples += n

    try:
        artifact("clean")
        art = artifact("single")
        fused_apply_activate.launches = 0
        svc = SamplingService(ModelRegistry(art, device="cuda", log=_silent),
                              workers=2, reload_interval_s=0,
                              promote="canary", log=_silent).start()
        try:
            gate = svc.gate
            incumbent = svc.registry.get().model_id
            req = f"{svc.url}/sample?rows={rows}&seed={seed}"
            status, before, _ = fetch(req)
            assert status == 200, status
            # a degraded generation, decided while a client keeps asking
            degrade_checkpoint(synth_dir(art), 100.0)
            traffic = []
            checked([gate], lambda: (traffic.append(TrafficLoop(req)),
                                     svc._maybe_reload()),
                    "degraded", lambda: len(traffic[0].stop()))
            bodies, bad = traffic[0].bodies, gate.last_decision
            if bad["promoted"] or not bad["tripped"] or not bad["per_column"]:
                raise AssertionError(f"degraded generation not rejected: "
                                     f"{ {k: bad[k] for k in ('promoted', 'tripped')} }")
            if any(s != 200 or b != before for s, b in bodies):
                raise AssertionError("a response during the decision was "
                                     "not the incumbent's bytes")
            status, after, _ = fetch(req)
            if status != 200 or after != before or \
                    svc.registry.get().model_id != incumbent:
                raise AssertionError("the rejected generation served")
            scored = gate.scored_total
            os.utime(os.path.join(synth_dir(art), "weights.npz"))
            svc._maybe_reload()
            if gate.scored_total != scored:
                raise AssertionError("a quarantined generation was scored "
                                     "again")
            metrics = fetch(f"{svc.url}/metrics")[1].decode()
            line = (f'fed_tgan_quality_rejections_total{{tenant="'
                    f'{meta.name}"}} 1')
            health = json.loads(fetch(f"{svc.url}/healthz")[1])
            if line not in metrics or health["promotion"]["rejections"] != 1 \
                    or health["model_id"] != incumbent:
                raise AssertionError(f"metrics/health after the rejection: "
                                     f"{health['promotion']}")
            # a clean generation: promoted, then served as immediate mode
            republish(art)
            checked([gate], svc._maybe_reload, "clean")
            good = gate.last_decision
            if not good["promoted"]:
                raise AssertionError(f"clean generation rejected: "
                                     f"{good['tripped']}")
            status, promoted, _ = fetch(req)
            plain = SamplingService(ModelRegistry(art, device="cuda",
                                                  log=_silent)).start()
            try:
                immediate = fetch(req)[1]
            finally:
                plain.shutdown()
            if status != 200 or promoted != immediate:
                raise AssertionError("promoted bytes differ from immediate "
                                     "mode's for the same generation")
            if promoted == before:
                raise AssertionError("the promoted generation serves the "
                                     "incumbent's bytes")
            # the scorer on the card against the CPU on the same inputs,
            # and its time at the canary's shape
            snap = svc.engine.snapshot()
            t0 = time.perf_counter()
            frame = svc.engine.sample_frame(gate.config.shadow_rows,
                                            seed=gate.config.shadow_seed,
                                            snap=snap)
            shadow_ms = (time.perf_counter() - t0) * 1e3
            _, means, stds, weights, _ = wd_inputs(stats, frame)
            args_card = wd_call(means, stds, weights, 512, "cuda")
            card_wd = wd_scores(*args_card).cpu().numpy()
            cpu_wd = wd_scores(*wd_call(means, stds, weights, 512,
                                        "cpu")).numpy()
            wd_err = float(np.abs(card_wd - cpu_wd).max())
            if wd_err > ATOL:
                raise AssertionError(f"scorer card vs CPU {wd_err} > {ATOL}")
            scorer_ms = cuda_ms(lambda: wd_scores(*args_card), 50)
            shadow_ms_warm = []
            for _ in range(5):
                t0 = time.perf_counter()
                svc.engine.sample_frame(gate.config.shadow_rows, seed=seed,
                                        snap=snap)
                shadow_ms_warm.append((time.perf_counter() - t0) * 1e3)
        finally:
            svc.shutdown()

        # two tenants of a fleet: a degraded publish and a clean one
        arts = {"good": artifact("good"), "bad": artifact("bad")}
        fleet = FleetRegistry(promote="canary", device="cuda", log=_silent)
        for name, path in arts.items():
            fleet.load(name, path)
        fsvc = FleetService(fleet, workers=2, reload_interval_s=0,
                            log=_silent).start()
        try:
            incumbents = {n: fleet.get(n).registry.get().model_id
                          for n in arts}
            republish(arts["good"])
            degrade_checkpoint(synth_dir(arts["bad"]), 100.0)
            checked([fleet.get(n).gate for n in ("good", "bad")],
                    fsvc._maybe_reload, "fleet")
            d_good = fleet.get("good").gate.last_decision
            d_bad = fleet.get("bad").gate.last_decision
            if not d_good["promoted"] or d_bad["promoted"]:
                raise AssertionError(f"fleet decisions: good "
                                     f"{d_good['promoted']}, bad "
                                     f"{d_bad['promoted']}")
            if fleet.get("bad").registry.get().model_id != incumbents["bad"]:
                raise AssertionError("the fleet serves the rejected model")
            want = {n: SamplingEngine(open_model(arts[n], device="cuda"))
                    .sample_csv_bytes(rows, seed=seed) for n in ("good",)}
            want["bad"] = SamplingEngine(fleet.get("bad").registry.get()) \
                .sample_csv_bytes(rows, seed=seed)
            run = _load(4, [[(n, rows, seed)] * 2 for n in
                            ("good", "bad", "good", "bad")],
                        lambda t: ("127.0.0.1", fsvc.port, f"/t/{t}/sample"))
            for (c, _), (status, body) in run["bodies"].items():
                tenant = ("good", "bad")[c % 2]
                if status != 200 or body != want[tenant]:
                    raise AssertionError(f"fleet tenant {tenant}: bytes "
                                         "differ from its serving model's")
            rejected = d_bad["candidate"]
            if any(rejected in str(key) for key in fleet.cache.keys()):
                raise AssertionError("a lane group holds the rejected model")
            status_json = json.loads(fetch(f"{fsvc.url}/fleet")[1])
            promo = {t["name"]: t["promotion"]
                     for t in status_json["tenants"]}
            if promo["good"]["promotions"] != 1 or \
                    promo["bad"]["quarantined"] != [rejected]:
                raise AssertionError(f"/fleet promotion state {promo}")
        finally:
            fsvc.shutdown()

        # no statistics file: the gate derives them from the serving model
        derived_art = artifact("derived", with_stats=False)
        dsvc = SamplingService(ModelRegistry(derived_art, device="cuda",
                                             log=_silent),
                               reload_interval_s=0, promote="canary",
                               log=_silent)
        degrade_checkpoint(synth_dir(derived_art), 100.0)
        checked([dsvc.gate], dsvc._maybe_reload, "derived stats")
        derived = dsvc.gate.last_decision
        if derived["promoted"] or not derived["tripped"] or \
                dsvc.gate._stats_cache.stats["source"] != "derived_incumbent":
            raise AssertionError(f"derived stats: {derived['tripped']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = [d["seconds"] for d in decisions]
    # the engine's chunk of a shadow sample: its steps, to a power of two
    due = -(-gate.config.shadow_rows // synth.cfg.batch_size)
    chunk_rows = (1 << (due - 1).bit_length()) * synth.cfg.batch_size
    out = {
        "launches": fused_apply_activate.launches,
        "shadow_samples": samples, "decisions": len(decisions),
        "decision_s_p50": statistics.median(seconds), "decision_s": seconds,
        "tripped_degraded": bad["tripped"], "jsd_delta_degraded":
        bad.get("jsd_delta"), "wd_delta_degraded": bad.get("wd_delta"),
        "jsd_delta_clean": good.get("jsd_delta"),
        "wd_delta_clean": good.get("wd_delta"),
        "scorer_ms": scorer_ms, "scorer_shape": list(means.shape) + [512],
        "scorer_card_vs_cpu": wd_err, "shadow_ms_first": shadow_ms,
        "shadow_ms": statistics.median(shadow_ms_warm),
        "requests_during_degraded_decision": len(bodies),
        "chunk_rows": chunk_rows,
    }
    print(f"canary: {len(decisions)} decisions (degraded rejected, tripped "
          f"{bad['tripped']}, jsd_delta {bad.get('jsd_delta')!r} wd_delta "
          f"{bad.get('wd_delta')!r}, {len(bodies)} requests during it all "
          f"the incumbent's bytes; clean promoted, jsd_delta "
          f"{good.get('jsd_delta')!r} wd_delta {good.get('wd_delta')!r}, "
          f"bytes == immediate mode; fleet good promoted / bad rejected, no "
          f"lane group holds it; derived stats rejected): seconds per "
          f"decision p50 {out['decision_s_p50']!r} ({seconds!r}); K1 "
          f"{out['launches']} launches in the phase, {samples} shadow "
          f"samples of {gate.config.shadow_rows} rows (one "
          f"({chunk_rows}, {synth.spec.dim}) chunk each)  [{card}]",
          flush=True)
    print(f"canary scorer: {scorer_ms!r} ms on the card at (2, "
          f"{means.shape[1]}, {means.shape[2]}) x 512 grid points, card vs "
          f"CPU max abs diff {wd_err!r} (atol {ATOL}); shadow sample of "
          f"{gate.config.shadow_rows} rows {out['shadow_ms']!r} ms (first "
          f"{shadow_ms!r} ms)  [{card}]", flush=True)
    return out


def _valid_date_cell(cell: str, fmt: str) -> bool:
    """``' '``, or a valid date as the JAX package writes the column: a
    ``yymmdd`` origin as the int of its digits, any other as
    ``YYYY-MM-DD 00:00:00``."""
    import datetime as dt

    if cell == " ":
        return True
    try:
        if fmt.startswith("yymmdd"):
            return cell.isdigit() and len(cell) <= 6 and bool(
                dt.datetime.strptime(cell.zfill(6), "%y%m%d"))
        return len(cell) == 19 and cell.endswith(" 00:00:00") and bool(
            dt.datetime.strptime(cell, "%Y-%m-%d %H:%M:%S"))
    except ValueError:
        return False


def _date_cells(blob: bytes, formats: dict) -> dict:
    """{date column: (cells, blanks)} of a CSV; fatal on an invalid cell."""
    lines = list(csv.reader(io.StringIO(blob.decode())))
    header, out = lines[0], {}
    for col, fmt in formats.items():
        j = header.index(col)
        bad = [r[j] for r in lines[1:] if not _valid_date_cell(r[j], fmt)]
        if bad:
            raise AssertionError(f"date column {col}: invalid cells "
                                 f"{bad[:5]}")
        out[col] = (len(lines) - 1, sum(r[j] == " " for r in lines[1:]))
    return out


def dated_phase(root: str, seed: int, card: str) -> dict:
    """Date columns on the card: the training CLI, run in this process so
    that its K1 and K2 launches are counted, trains an Intrusion-shaped
    CSV with a ``YYYY-MM-DD`` and a ``yymmdd`` column (2 clients, 1 round,
    ``--date-format``, ``--save-model``); then ``serve`` answers 5,000-row
    requests from its artifact, one K1 launch per chunk.  Every date cell
    of the snapshot and of the response is valid, and the response equals
    the card's encoded rows of the same request decoded on the CPU."""
    from fed_tgan_torch.cli import main as cli_main
    from fed_tgan_torch.ops.decode import decode_tables, tables_to
    from fed_tgan_torch.serve.demo import write_dated_csv

    data = write_dated_csv(os.path.join(root, "dated.csv"), DATED_ROWS, seed)
    out = os.path.join(root, "dated_out")
    columns = [*INTRUSION_SELECTED, *DATED_FORMATS]
    argv = ["--mode", "fedavg", "--datapath", data, "--dataset", "intrusion",
            "--selected", *columns, "--n-clients", "2", "-epochs", "1",
            "--sample-rows", str(DATED_SNAPSHOT_ROWS), "--eval",
            "--save-model", "--out-dir", out, "--seed", str(seed),
            "--date-format", *(f"{k}={v}" for k, v in DATED_FORMATS.items())]
    stdout = io.StringIO()
    fused_apply_activate.launches = 0
    fused_activate_bwd.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    train_launches = {"K1": fused_apply_activate.launches,
                      "K2": fused_activate_bwd.launches}
    if rc != 0:
        raise AssertionError(f"dated CLI exited {rc}: "
                             f"{stdout.getvalue()[-3000:]}")
    snap = os.path.join(out, "Intrusion_result",
                        "Intrusion_synthesis_epoch_0.csv")
    with open(snap, "rb") as f:
        snap_cells = _date_cells(f.read(), DATED_FORMATS)
    if any(n != DATED_SNAPSHOT_ROWS for n, _ in snap_cells.values()):
        raise AssertionError(f"snapshot rows {snap_cells}")
    registry = ModelRegistry(out, device="cuda", log=_silent)
    model = registry.get()
    if model.meta.date_info != DATED_FORMATS:
        raise AssertionError(f"saved date_info {model.meta.date_info}")
    spec, cfg = model.synth.spec, model.synth.cfg
    B = cfg.batch_size
    # one stacked step of both clients per local step, one snapshot chunk
    shards = next(ast.literal_eval(line.split("rows per shard: ", 1)[1])
                  for line in stdout.getvalue().splitlines()
                  if "rows per shard: " in line)
    max_steps = max(r // B for r in shards)
    service = SamplingService(registry).start()
    try:
        engine = service.engine
        snap_chunks = len(engine._chunk_plan(
            0, -(-DATED_SNAPSHOT_ROWS // B), pow2_tail=False))
        want_train = {"K1": max_steps * (cfg.d_steps + 1) + snap_chunks,
                      "K2": max_steps}
        if train_launches != want_train:
            raise AssertionError(f"dated CLI launches {train_launches} != "
                                 f"{want_train}")
        plan = engine._chunk_plan(0, -(-DATED_REQUEST_ROWS // B))
        url = f"{service.url}/sample?rows={DATED_REQUEST_ROWS}&seed={seed}"
        fused_apply_activate.launches = 0
        status, body, first_s = fetch(url)
        # the same request again, warm: p50 of 5
        warm = [fetch(url) for _ in range(5)]
        serve_launches = fused_apply_activate.launches
        enc = engine.sample_encoded(DATED_REQUEST_ROWS, seed=seed)
    finally:
        service.shutdown()
    if status != 200 or any(s != 200 or b != body for s, b, _ in warm):
        raise AssertionError(f"serve answered {status}, or a repeat "
                             "differs")
    if serve_launches != 6 * len(plan):
        raise AssertionError(f"dated serving: {serve_launches} K1 launches "
                             f"for 6 requests of {len(plan)} chunks")
    request_ms = statistics.median(t for _, _, t in warm) * 1e3
    served_cells = _date_cells(body, DATED_FORMATS)
    # the card's encoded rows of the request, decoded on the CPU
    mat = layout_decode(torch.from_numpy(enc), tables_to(
        decode_tables(model.synth.columns), "cpu")).numpy()
    plain = plain_csv_bytes(decode_columns(mat, model.meta, model.encoders))
    if body != plain:
        raise AssertionError("the dated response differs from the CPU "
                             "decode of the same encoded rows")
    chunk_rows = plan[0][1] * B
    print(f"dated: CLI --date-format {DATED_FORMATS} on {DATED_ROWS} rows, "
          f"2 clients {shards}, 1 round, layout {spec.dim}: exit 0 in "
          f"{wall!r} s, K1/K2 launches {train_launches} (== {want_train}); "
          f"snapshot (rows, blanks) {snap_cells}; serve answered "
          f"{DATED_REQUEST_ROWS} rows in {request_ms!r} ms p50 of 5 (first "
          f"{first_s * 1e3!r} ms), {serve_launches} K1 launches in 6 "
          f"requests (one ({chunk_rows}, {spec.dim}) chunk each), (rows, "
          f"blanks) {served_cells}, every date cell valid, bytes == the "
          f"CPU decode of the card's encoded rows  [{card}]", flush=True)
    return {"cli_wall_s": wall, "snapshot": snap_cells,
            "served": served_cells, "request_ms": request_ms,
            "first_request_ms": first_s * 1e3, "spec": spec,
            "launches": {"train": train_launches, "serve": serve_launches},
            "chunk_rows": chunk_rows, "train_rows": len(shards) * B}


# ---------------------------------------------------------- mixed precision

# bytes one element of each bf16 variant moves: K1 for sampling reads x
# (2) and u (4) and writes out (2); K1 for training also writes its
# float32 result (4), K2's residual; K2 reads dy (2) and out (4) and writes
# dx (2).  Their operations are the float32 kernels'.
BF16_VARIANTS = {"fwd_bf16": ("K1", 8), "fwd_train_bf16": ("K1", 12),
                 "bwd_bf16": ("K2", 8)}


def precision_flags() -> dict:
    """The process-wide matmul flags the bf16 path relies on."""
    matmul = torch.backends.cuda.matmul
    return {"allow_bf16_reduced_precision_reduction":
            matmul.allow_bf16_reduced_precision_reduction,
            "matmul_allow_tf32": matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value of ``v`` (0 at 0)."""
    a = v.float().abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 7), torch.zeros_like(a))


def _ulps(got: torch.Tensor, want: torch.Tensor, atol: float = 0.0):
    """(max abs error, the largest excess over ``atol`` in bf16 ulps of
    ``want``)."""
    diff = (got.float() - want.float()).abs()
    excess = torch.clamp(diff - atol, min=0.0)
    ulp = bf16_ulp(want)
    over = torch.where(excess > 0, excess / torch.where(ulp > 0, ulp, 1.0),
                       torch.zeros_like(excess))
    over = torch.where((ulp == 0) & (excess > 0), torch.inf, over)
    return diff.max().item(), over.max().item()


def check_bf16_kernels(cases: list, card: str) -> dict:
    """Each bf16 variant against its plain version at each case (name,
    spec, rows, variants): results within one bf16 ulp (K2's past the
    float32 kernels' 1e-5 where dy - sum cancels), K1's float32 residual
    within 1e-5; times, plan and bound as for the float32 kernels."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {k: [] for k in BF16_VARIANTS}
    for name, sp, rows, variants in cases:
        x = (torch.randn((rows, sp.dim), generator=gen, device="cuda")
             * 2.0).to(torch.bfloat16)
        u = torch.rand(x.shape, generator=gen, device="cuda")
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        if name.startswith("misaligned"):
            k = 1 if name.endswith("2B") else 2
            x, dy, u = misaligned(x, k), misaligned(dy, k), misaligned(u)
        res = apply_activate_residual(x, sp, u)[1].contiguous()
        for variant in variants:
            kernel, nbytes = BF16_VARIANTS[variant]
            if variant == "fwd_bf16":
                fn = lambda: fused_apply_activate(x, sp, u)
                plain = lambda: apply_activate(x, sp, u)
                got, want = fn(), plain()
                res_err = None
            elif variant == "fwd_train_bf16":
                fn = lambda: activate_cuda._activate(x, sp, u, residual=True)
                plain = lambda: apply_activate_residual(x, sp, u)
                (got, got_res), (want, want_res) = fn(), plain()
                res_err = (got_res - want_res).abs().max().item()
            else:
                fn = lambda: fused_activate_bwd(dy, res, sp)
                plain = lambda: apply_activate_bwd(dy, res, sp)
                got, want = fn(), plain()
                res_err = None
            torch.cuda.synchronize()
            err, ulps = _ulps(got, want, ATOL if kernel == "K2" else 0.0)
            times = measure(kernel, fn, plain, rows, sp.dim, nbytes)
            plan = activate_cuda.plan_for(x, sp).as_dict()
            share = (times["bound_ms"] / times["device_ms"]
                     if times["device_ms"] else None)
            print(f"{variant} {name}: ({rows}, {sp.dim}) max_abs_err {err!r}"
                  f", {ulps!r} bf16 ulps over the plain version"
                  + ("" if res_err is None else
                     f", float32 residual max_abs_err {res_err!r}")
                  + f"; kernel {times['ms']!r} ms, device "
                  f"{times['device_ms']!r} ms, host {times['host_us']!r} us; "
                  f"plain {times['plain_ms']!r} ms; bound "
                  f"{times['bound_ms']!r} ms ({times['bound_by']}, {nbytes} "
                  f"B an element), share {share!r}; plan {plan}  [{card}]",
                  flush=True)
            if not ulps <= 1.0:
                raise AssertionError(f"{variant} {name}: {ulps} bf16 ulps "
                                     "from its plain version")
            if res_err is not None and not res_err <= ATOL:
                raise AssertionError(f"{variant} {name}: residual error "
                                     f"{res_err} > {ATOL}")
            results[variant].append({
                "shape": [rows, sp.dim], "case": name, "max_abs_err": err,
                "max_ulps": ulps, "residual_max_abs_err": res_err, **times,
                "share": share, "plan": plan, "bytes_per_element": nbytes})
    return results


def _variant_launches() -> dict:
    return {"K1": dict(fused_apply_activate.variant_launches),
            "K2": dict(fused_activate_bwd.variant_launches)}


def _trajectory(synth, cfg, seed: int, n_steps: int) -> tuple:
    """``n_steps`` train steps from ``init_models(seed)`` with draws from
    one seeded generator, on ``synth``'s data: (per-metric losses, ms a
    step back to back)."""
    models = steps.init_models(synth.spec, cfg, seed, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mets = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        mets.append(steps.train_step(models, synth.train_data, synth.cond,
                                     synth.rows, steps.draw_step(gen,
                                                                 models)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_steps
    return {k: torch.stack([m[k] for m in mets]).cpu().numpy()
            for k in mets[0]}, ms


def precision_train(seed: int, card: str, f32_training: dict) -> tuple:
    """The standalone trainer with ``TrainConfig(precision="bf16")`` at
    "Training"'s configuration, twice from one seed: exact launches of
    each variant, bit-equal weights; then the f32 and bf16 loss
    trajectories from one init and one draw stream, in turns."""
    matrix, cat_idx, meta, encoders = intrusion_like_table(TRAIN_ROWS, seed)
    cfg = steps.TrainConfig(precision="bf16")
    runs, synth = [], None
    for _ in range(2):
        synth = StandaloneSynthesizer(cfg, seed=seed, device="cuda")
        activate_cuda.reset_launches()
        synth.fit(matrix, cat_idx, epochs=TRAIN_EPOCHS)
        runs.append((_variant_launches(), synth.timings, synth.metrics,
                     [t.detach().clone() for t in
                      [*synth.models.generator.state_dict().values(),
                       *synth.models.discriminator.state_dict().values()]]))
    steps_per_epoch = TRAIN_ROWS // cfg.batch_size
    total = TRAIN_EPOCHS * steps_per_epoch
    want = {"K1": {"f32": 0, "bf16": total * cfg.d_steps,
                   "bf16_train": total},
            "K2": {"f32": 0, "bf16": total}}
    for launches, *_ in runs:
        if launches != want:
            raise AssertionError(f"bf16 training launches {launches} != "
                                 f"{want}")
    equal = all(torch.equal(a, b) for a, b in zip(runs[0][3], runs[1][3]))
    if not equal:
        raise AssertionError("two bf16 trainings from one seed differ")
    if not all(t.dtype in (torch.float32, torch.int64)
               for t in runs[0][3]):
        raise AssertionError("a bf16 master weight is not float32")
    m = runs[0][2]
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"non-finite bf16 losses {m}")
    # loss trajectories, f32 / bf16 / bf16 / f32: one init, one draw stream
    cfg32 = steps.TrainConfig()
    turns = [(c.precision, *_trajectory(synth, c, seed + 5, total))
             for c in (cfg32, cfg, cfg, cfg32)]
    (_, l32, _), (_, l16, _) = turns[0], turns[1]
    if any(not np.array_equal(turns[1][1][k], turns[2][1][k]) for k in l16):
        raise AssertionError("the bf16 trajectory did not repeat")
    gap = {k: float(np.abs(l16[k] - l32[k]).max()) for k in l16}
    ms_turns = [(p, ms) for p, _, ms in turns]
    epoch_ms = [[t * 1e3 / steps_per_epoch for t in r[1]["epoch_s"]]
                for r in runs]
    print(f"precision train: bf16 standalone, {TRAIN_EPOCHS} epochs x "
          f"{steps_per_epoch} steps at layout {synth.spec.dim}; ms/step by "
          f"epoch {epoch_ms!r} (f32 in this call: "
          f"{f32_training['ms_per_step_by_epoch']!r}); launches "
          f"{runs[0][0]} (expected {want}); two runs bit-equal {equal}; last "
          f"losses {m}  [{card}]", flush=True)
    print(f"precision train: loss trajectories from one init and one draw "
          f"stream ({total} steps), largest gap bf16 vs f32 {gap}; ms/step "
          f"in turns {ms_turns!r}  [{card}]", flush=True)
    report = {"ms_per_step_by_epoch": epoch_ms,
              "f32_ms_per_step_by_epoch":
                  f32_training["ms_per_step_by_epoch"],
              "launches": runs[0][0], "launches_expected": want,
              "bit_equal": equal, "losses": m, "trajectory_gap": gap,
              "trajectory_ms_per_step_turns": ms_turns,
              "bgm_fit_s": [r[1]["bgm_fit_s"] for r in runs]}
    return synth, meta, encoders, report


def _state(tr) -> list:
    st = tr.stack
    return [st.generator.params, st.discriminator.params,
            st.generator.bn_state, st.generator.num_batches,
            st.opt_g.exp_avg, st.opt_g.exp_avg_sq, st.opt_g.count,
            st.opt_d.exp_avg, st.opt_d.exp_avg_sq, st.opt_d.count]


def precision_federated(init, seed: int, card: str, root: str,
                        f32_round: dict) -> dict:
    """The federated round in bf16 at "Federated round"'s configuration:
    ``FED_EPOCHS`` rounds with a 40,000-row packed8 snapshot and a save
    after each (exact launches of each variant), then the save after the
    second round loaded and its third round run: bit-equal to the
    uninterrupted run."""
    cfg = steps.TrainConfig(precision="bf16")
    trainer = FederatedTrainer(init, cfg, seed=seed, device="cuda")
    path_fn = result_path_fn(os.path.join(root, "bf16_round_out"),
                             "Intrusion")
    writer = SnapshotWriter(init.global_meta, init.encoders, path_fn,
                            rows=SNAPSHOT_ROWS, seed=seed)
    ckpt = os.path.join(root, "bf16_ckpt")
    max_steps = int(trainer.steps.max())
    chunks = len(trainer._sampler()._chunk_plan(
        0, -(-SNAPSHOT_ROWS // cfg.batch_size), pow2_tail=False))
    save_s = []

    def hook(e, tr):
        writer(e, tr)
        t0 = time.perf_counter()
        save_federated(tr, ckpt, keep=2)
        save_s.append(time.perf_counter() - t0)

    activate_cuda.reset_launches()
    with writer:
        trainer.fit(FED_EPOCHS, sample_hook=hook)
    launches = _variant_launches()
    want = {"K1": {"f32": 0, "bf16": FED_EPOCHS * (max_steps * cfg.d_steps
                                                   + chunks),
                   "bf16_train": FED_EPOCHS * max_steps},
            "K2": {"f32": 0, "bf16": FED_EPOCHS * max_steps}}
    if launches != want:
        raise AssertionError(f"bf16 federated launches {launches} != {want}")
    for e in range(FED_EPOCHS):
        with open(path_fn(e)) as f:
            if sum(1 for _ in f) != SNAPSHOT_ROWS + 1:
                raise AssertionError(f"bf16 snapshot {e}: wrong row count")
    if not np.isfinite(trainer.last_metrics).all():
        raise AssertionError(f"non-finite bf16 round metrics "
                             f"{trainer.last_metrics}")
    host = json.load(open(os.path.join(ckpt, "host.json")))
    if host["cfg"]["precision"] != "bf16":
        raise AssertionError("the bf16 checkpoint does not carry bf16")
    t0 = time.perf_counter()
    resumed = load_federated(f"{ckpt}.1", device="cuda")
    load_s = time.perf_counter() - t0
    if (resumed.completed_epochs, resumed.cfg.precision) != (
            FED_EPOCHS - 1, "bf16"):
        raise AssertionError("the loaded checkpoint is not round "
                             f"{FED_EPOCHS - 1} in bf16")
    resumed.fit(1)
    equal = all(torch.equal(a, b) for a, b in zip(_state(trainer),
                                                  _state(resumed)))
    if not equal:
        raise AssertionError("bf16 resume differs from the uninterrupted "
                             "run")
    # a round and its snapshot, the save left out: what phase 10 times
    rounds_s = [t - s for t, s in zip(trainer.epoch_times[:FED_EPOCHS],
                                      save_s)]
    print(f"precision federated: {FED_CLIENTS} clients, steps "
          f"{trainer.steps.tolist()}, layout {trainer.spec.dim}, bf16 delta "
          f"payload; s/round with its snapshot {rounds_s!r} (f32 in this "
          f"call: {f32_round['round_s']!r}) = local steps "
          f"{trainer.round_split['local_steps'][:FED_EPOCHS]!r} + "
          f"aggregation {trainer.round_split['aggregate'][:FED_EPOCHS]!r} + "
          f"snapshot; then a save {save_s!r} s; load {load_s!r} s; "
          f"launches {launches} (expected {want}); resumed round bit-equal "
          f"{equal}  [{card}]", flush=True)
    return {"round_s": rounds_s, "f32_round_s": f32_round["round_s"],
            "local_steps_s": trainer.round_split["local_steps"][:FED_EPOCHS],
            "aggregate_s": trainer.round_split["aggregate"][:FED_EPOCHS],
            "save_s": save_s, "load_s": load_s, "launches": launches,
            "launches_expected": want, "resume_bit_equal": equal,
            "shape": [FED_CLIENTS * cfg.batch_size, trainer.spec.dim]}


def _segment_ties(enc: np.ndarray, spec: SegmentSpec) -> np.ndarray:
    """(rows, segments) bool: the segment's two largest outputs equal
    (a tie the bf16 rounding made)."""
    out = np.zeros((len(enc), spec.n_segments), dtype=bool)
    start = 0
    for j, (size, kind) in enumerate(spec.output_info):
        if kind == "softmax" and size > 1:
            top = np.sort(enc[:, start:start + size], axis=1)
            out[:, j] = top[:, -1] == top[:, -2]
        start += size
    return out


def bf16_reference(art: str, seed: int, card: str) -> dict:
    """The bf16 artifact on the card against the CPU on the same injected
    draws (2 steps): at least 99% of the generator's bf16 logits equal;
    encoded rows within one bf16 ulp in every segment whose logits are
    equal (the others counted); K1 on equal logits within one ulp;
    categorical cells equal except where a side's bf16 segment ties
    (counted)."""
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

    def logits(engine):
        z, c, u = engine.draw(engine.snapshot(),
                              seed + engine.model.synth.key_offset, 0, 2,
                              None, draws)
        x = torch.cat([z, c], 1).to(torch.bfloat16)
        with torch.no_grad():
            return torch.cat([engine.model.synth.generator(b) for b in
                              x.split(cfg.batch_size)]), u

    raw_g, u_g = logits(gpu)
    raw_c, u_c = logits(cpu)
    raw_err, raw_ulps = _ulps(raw_g.cpu(), raw_c)
    raw_equal = float((raw_g.cpu() == raw_c).float().mean())
    # K1 is row- and segment-wise: where every bf16 logit of a segment is
    # equal on the two sides (the GEMMs' float32 sums round to the same
    # bf16), its outputs are K1's float32 island rounded once, within one
    # ulp; a segment with an unequal logit is counted and set aside
    ids = torch.as_tensor(spec.segment_ids, dtype=torch.long)
    seg_differs = torch.zeros((n, spec.n_segments), dtype=torch.int32
                              ).scatter_add_(1, ids.expand(n, -1),
                                             (raw_g.cpu() != raw_c).int()) > 0
    keep = ~seg_differs[:, ids].numpy()
    err, ulps = _ulps(torch.from_numpy(enc_g[keep]),
                      torch.from_numpy(enc_c[keep]))
    set_aside = int((~keep).sum())
    k1_err, k1_ulps = _ulps(fused_apply_activate(raw_c.cuda(), spec,
                                                 u_c.cuda()).cpu(),
                            apply_activate(raw_c, spec, u_c))
    dec_g = gpu.sample_decoded(n, seed=seed, draws=draws)
    dec_c = cpu.sample_decoded(n, seed=seed, draws=draws)
    ties = _segment_ties(enc_g, spec) | _segment_ties(enc_c, spec)
    # each softmax segment of a discrete column is one decoded column
    seg_of_col, seg = [], 0
    for col in gpu.model.synth.columns:
        seg_of_col.append(seg)
        seg += 2 if not isinstance(col, DiscreteColumn) else 1
    cat_cols = [j for j, col in enumerate(gpu.model.synth.columns)
                if isinstance(col, DiscreteColumn)]
    mism = tied = 0
    for j in cat_cols:
        diff = dec_g[:, j] != dec_c[:, j]
        tie = ties[:, seg_of_col[j]]
        mism += int((diff & ~tie).sum())
        tied += int((diff & tie).sum())
    print(f"precision reference: bf16 artifact card vs CPU on injected "
          f"draws, {n} rows: generator logits max_abs_err {raw_err!r} "
          f"({raw_ulps!r} bf16 ulps; {raw_equal!r} of them equal); encoded "
          f"rows where a segment's logits are equal max_abs_err {err!r} "
          f"({ulps!r} ulps), {set_aside} values of {enc_g.size} in segments "
          f"with an unequal logit set aside; K1 vs plain on the CPU's logits "
          f"{k1_ulps!r} ulps; categorical cells differing {mism} outside "
          f"ties, {tied} where a side ties  [{card}]", flush=True)
    if mism:
        raise AssertionError(f"{mism} categorical cells differ card vs CPU "
                             "outside bf16 ties")
    if not k1_ulps <= 1.0:
        raise AssertionError(f"K1 bf16 on equal logits: {k1_ulps} ulps")
    if not ulps <= 1.0:
        raise AssertionError(f"bf16 encoded rows card vs CPU: {ulps} ulps "
                             "where the logits are equal")
    if not raw_equal >= 0.99:
        raise AssertionError(f"only {raw_equal} of the bf16 logits are "
                             "equal card vs CPU")
    return {"encoded_max_abs_err": err, "encoded_max_ulps": ulps,
            "encoded_values_set_aside": set_aside,
            "logits_max_ulps": raw_ulps, "logits_equal_share": raw_equal,
            "k1_on_equal_logits_ulps": k1_ulps,
            "categorical_cells_tied_differently": tied}


def precision_serve(synth16, synth32, meta, encoders, rows: int, seed: int,
                    card: str, root: str) -> dict:
    """The bf16 trained model and the f32 one (one layout) served through
    the HTTP service in turns (f32, bf16, bf16, f32): p50 and rows/s,
    chunked bytes == one-shot bytes; K1's bf16 sampling variant once per
    chunk and no other; then the card against the CPU."""
    arts = {}
    for prec, synth in (("f32", synth32), ("bf16", synth16)):
        arts[prec] = write_artifact(os.path.join(root, f"serve_{prec}"),
                                    synth.to_saved(), meta, encoders)
    engine = SamplingEngine(open_model(arts["bf16"], device="cuda"))
    B = engine.cfg.batch_size
    # serve_phase's requests: 1 + 5 of `rows`, 3 offset chunks, 600 rows
    thirds = (rows // 3, rows // 3, rows - 2 * (rows // 3))
    reqs = [(rows, 0)] * 6 + [(n, sum(thirds[:i])) for i, n in
                              enumerate(thirds)] + [(600, 0)]
    chunks = sum(len(engine._chunk_plan(o // B, -(-(o % B + n) // B)))
                 for n, o in reqs)
    turns = []
    for prec in ("f32", "bf16", "bf16", "f32"):
        activate_cuda.reset_launches()
        res = serve_phase(arts[prec], rows, seed, card)
        launches = _variant_launches()
        if prec == "bf16":
            want = {"K1": {"f32": 0, "bf16": chunks, "bf16_train": 0},
                    "K2": {"f32": 0, "bf16": 0}}
            if launches != want:
                raise AssertionError(f"bf16 serving launches {launches} != "
                                     f"{want}")
        turns.append({"precision": prec, **res, "launches": launches})
    ref = bf16_reference(arts["bf16"], seed, card)
    for prec in ("f32", "bf16"):
        shutil.rmtree(arts[prec], ignore_errors=True)
    print(f"precision serve: {rows}-row requests in turns "
          f"{[(t['precision'], t['p50_ms'], t['rows_per_s']) for t in turns]}"
          f" (precision, p50 ms, rows/s); bf16 K1 launches per turn "
          f"{chunks} = one per chunk  [{card}]", flush=True)
    return {"turns": turns, "chunks_per_turn": chunks, "reference": ref,
            "chunk_rows": engine._chunk_plan(0, -(-rows // B))[0][1] * B}


def precision_phase(seed: int, card: str, root: str, rows: int,
                    synth32, f32_training: dict, init,
                    f32_round: dict) -> dict:
    """Mixed precision on the card: the flags, the trainer, the federated
    round and serving in bf16 (each main path with every launch count set
    to 0 just before it and read just after), then each bf16 variant held
    against its plain version at the shapes those paths give it."""
    resolve_precision("bf16")
    flags = precision_flags()
    print(f"precision flags: {flags}  [{card}]", flush=True)
    if flags["allow_bf16_reduced_precision_reduction"] is not False:
        raise AssertionError("bf16 GEMMs may reduce in bf16")
    if flags["matmul_allow_tf32"] or flags["cudnn_allow_tf32"]:
        raise AssertionError("TF32 is on for float32 products")
    synth16, meta, encoders, train = precision_train(seed, card, f32_training)
    fed = precision_federated(init, seed, card, root, f32_round)
    serve = precision_serve(synth16, synth32, meta, encoders, rows, seed,
                            card, root)
    _, _, columns = intrusion_layout(np.random.default_rng(seed))
    serving_spec = SegmentSpec.from_output_info(output_info(columns))
    fed_spec = SegmentSpec.from_output_info(init.output_info)
    B = steps.TrainConfig().batch_size
    fwd, train_fwd, bwd = "fwd_bf16", "fwd_train_bf16", "bwd_bf16"
    shapes = check_bf16_kernels([
        ("served", synth16.spec, serve["chunk_rows"], (fwd,)),
        ("serving", serving_spec, 8000, (fwd,)),
        ("lanes", serving_spec, 64000, (fwd,)),
        ("train", synth16.spec, B, (fwd, train_fwd, bwd)),
        ("stacked", fed_spec, FED_CLIENTS * B, (fwd, train_fwd, bwd)),
        ("misaligned2B", serving_spec, B, (fwd, train_fwd, bwd)),
        ("misaligned4B", serving_spec, B, (fwd, train_fwd, bwd)),
    ], card)
    paths = {"training": train["launches"], "federated": fed["launches"],
             "serving": serve["turns"][1]["launches"]}
    return {"flags": flags, "training": train, "federated": fed,
            "serving": serve, "shapes": shapes, "launches_by_path": paths}


# ------------------------------------------------- onboarding and churn

# the JAX onboarding sweep's configuration (``BENCH_r13.json``): N IID
# clients of 200 rows; the smoke runs N = 64 and 256 (1,024 through
# ``--onboard 1024``), and registers 64 newcomers into the 256
ONBOARD_POPULATIONS, ONBOARD_ROWS, ONBOARD_NEWCOMERS = (64, 256), 200, 64
# the exact init's host WD passes grow with N x total rows: compared up to
# the JAX sweep's largest comparator population
EXACT_MAX = 256
# the churn run: the federated round's CSV and clients, 8 slots, 8 rounds,
# a 10,000-row snapshot and a save every round, a drift window every 2
CHURN_CAPACITY, CHURN_ROUNDS, CHURN_SNAPSHOT_ROWS, CHURN_EVERY = 8, 8, 10_000, 2
CHURN_FAULTS = ("join:round=3,count=2;leave:client=1,round=5;"
                "drift:client=0,round=6,shift=2.0")
GMM_FIELDS = ("means", "stds", "weights", "mean_precision", "dof", "stick_a",
              "stick_b")


def _onboard_clients(n: int, seed: int) -> list:
    """``n`` IID Intrusion-shaped clients of ``ONBOARD_ROWS`` raw rows."""
    from fed_tgan_torch.serve.demo import intrusion_like_raw

    kw = preprocessor_kwargs(PRESETS["intrusion"])
    shards = shard_table(intrusion_like_raw(n * ONBOARD_ROWS, seed), n,
                         "iid", seed=seed)
    return [TablePreprocessor(table=t, name="Intrusion", **kw)
            for t in shards]


def _timed_init(clients, seed: int, **kw):
    """``federated_initialize`` on the card, timed, with the peak device
    memory it allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init = federated_initialize(clients, seed=seed, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sum(c.n_rows for c in clients)
    return init, {"s": wall, "clients_per_s": len(clients) / wall,
                  "rows_per_s": rows / wall, "phases_s": dict(init.timings),
                  "peak_device_mib":
                  torch.cuda.max_memory_allocated() / 2 ** 20}


def _same_init(what: str, a, b) -> None:
    if not (len(a.client_matrices) == len(b.client_matrices)
            and all(np.array_equal(x, y) for x, y in
                    zip(a.client_matrices, b.client_matrices))
            and np.array_equal(a.weights, b.weights)
            and a.output_info == b.output_info):
        raise AssertionError(f"{what}: matrices, weights or output_info "
                             "differ")


def _cache_ops(cache) -> dict:
    ops: dict = {}
    for e in cache.events:
        key = f"{e['op']}_{e['scope']}"
        ops[key] = ops.get(key, 0) + int(e["count"])
    return ops


def _sketch_vs_exact(n: int, exact, cold, t_exact: dict, card: str) -> dict:
    """The sketch init's weights against the exact init's: within 5e-3,
    and the same argmax wherever the exact weights' top two lie further
    apart than twice the delta (IID clients' weights tie to sampling
    noise)."""
    delta = float(np.abs(exact.weights - cold.weights).max())
    top2 = np.sort(exact.weights)[-2:]
    gap = float(top2[1] - top2[0])
    same = bool(exact.weights.argmax() == cold.weights.argmax())
    if not delta < 5e-3 or (gap > 2 * delta and not same):
        raise AssertionError(f"N={n}: sketch weights {delta} from exact "
                             f"(bound 5e-3), or another argmax with a "
                             f"top-two gap {gap} > 2 x {delta}")
    print(f"onboard N={n}: cold exact {t_exact['s']!r} s "
          f"({t_exact['clients_per_s']!r} clients/s, "
          f"{t_exact['rows_per_s']!r} rows/s; {t_exact['phases_s']}); sketch "
          f"vs exact weights max delta {delta!r} (bound 5e-3), same argmax "
          f"{same} (exact top-two gap {gap!r})  [{card}]", flush=True)
    return {"exact": t_exact, "sketch_vs_exact_max_weight_delta": delta,
            "exact_top2_gap": gap, "same_argmax": same}


def onboard_phase(root: str, seed: int, card: str,
                  populations=ONBOARD_POPULATIONS) -> dict:
    """Device-side init and onboarding at population scale, for each N:
    a cold sketch init into a fresh init cache and a warm restore
    (bit-identical matrices, weights, layout); up to ``EXACT_MAX``, a
    cold exact init and the sketch's weights against it
    (:func:`_sketch_vs_exact`); at the smallest N, a ``corrupt_cache:nth=1`` store detected
    and refitted by a later init over the same shards; at the largest N,
    one shard fitted alone equal bit for bit to its fit in the batch of
    all N shards, and 64 newcomers registered into the resident N."""
    from fed_tgan_torch.features.bgm import fit_columns, fit_shards
    from fed_tgan_torch.federation.init_cache import InitCache
    from fed_tgan_torch.federation.streaming import OnboardingSession

    report = {}
    for n in populations:
        grow = n == max(populations)
        clients = _onboard_clients(n + (ONBOARD_NEWCOMERS if grow else 0),
                                   seed)
        clients, newcomers = clients[:n], clients[n:]
        cache = InitCache(os.path.join(root, f"cache_{n}"))
        cold, t_cold = _timed_init(clients, seed, similarity="sketch",
                                   cache=cache)
        warm, t_warm = _timed_init(clients, seed, similarity="sketch",
                                   cache=cache)
        _same_init(f"N={n} warm restore", cold, warm)
        entry = {"sketch_cold": t_cold, "warm": t_warm,
                 "cache_ops": _cache_ops(cache)}
        print(f"onboard N={n} x {ONBOARD_ROWS} rows: cold sketch "
              f"{t_cold['s']!r} s ({t_cold['clients_per_s']!r} clients/s, "
              f"{t_cold['rows_per_s']!r} rows/s; {t_cold['phases_s']}), "
              f"peak device memory {t_cold['peak_device_mib']!r} MiB; warm "
              f"{t_warm['s']!r} s ({t_warm['phases_s']}), bit-identical; "
              f"cache {entry['cache_ops']}  [{card}]", flush=True)
        if n <= EXACT_MAX:
            exact, t_exact = _timed_init(clients, seed, similarity="exact")
            entry.update(_sketch_vs_exact(n, exact, cold, t_exact, card))
        if n == min(populations):
            croot = os.path.join(root, f"corrupt_{n}")
            install_plan(FaultPlan.parse("corrupt_cache:nth=1"))
            try:
                federated_initialize(clients, seed=seed, device="cuda",
                                     similarity="sketch", cache=croot)
            finally:
                install_plan(None)
            # another init over the same shards reads the client entries:
            # the truncated one is refitted, to the same bits
            ccache = InitCache(croot)
            refit = federated_initialize(clients, seed=seed, device="cuda",
                                         similarity="sketch", cache=ccache,
                                         transform_matrices=False)
            ops = _cache_ops(ccache)
            if (ops.get("corrupt_client") != 1
                    or ops.get("hit_client") != n - 1
                    or not np.array_equal(refit.weights, cold.weights)):
                raise AssertionError(f"corrupt_cache:nth=1 not detected and "
                                     f"refitted to the same weights: {ops}")
            entry["corrupt_cache"] = ops
            print(f"onboard N={n}: corrupt_cache:nth=1 detected and refitted "
                  f"({ops}); weights equal the cold run's  [{card}]",
                  flush=True)
        if grow:
            cont = cold.onboarding["cont_idx"]
            enc = [c.encode(cold.encoders)[0] for c in clients]
            shards = [[m[:, j] for j in cont] for m in enc]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = fit_shards(shards, device="cuda")
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            k = n // 2
            alone = fit_columns(shards[k], device="cuda")
            for a, b in zip(alone, batch[k]):
                for f in GMM_FIELDS:
                    if not np.array_equal(getattr(a, f), getattr(b, f)):
                        raise AssertionError(
                            f"client {k}'s fit alone differs from its fit "
                            f"in the batch of {n} ({f})")
            session = OnboardingSession(warm, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grown = session.register_clients(newcomers)
            torch.cuda.synchronize()
            reg_s = time.perf_counter() - t0
            if (len(grown.client_matrices) != n + len(newcomers)
                    or not np.isclose(grown.weights.sum(), 1.0)):
                raise AssertionError("registration did not grow the init")
            entry.update({"fit_shards_s": fit_s, "register_s": reg_s,
                          "register_clients_per_s": len(newcomers) / reg_s})
            print(f"onboard N={n}: fit_shards of {n} x {len(cont)} columns "
                  f"{fit_s!r} s; client {k} fitted alone == in the batch, "
                  f"bit for bit; register_clients of {len(newcomers)} "
                  f"newcomers into {n}: {reg_s!r} s  [{card}]", flush=True)
        report[f"n{n}"] = entry
    return report


@contextlib.contextmanager
def journaled():
    """A run journal installed as the process journal while the block
    runs (validation armed); yields the list its events land in when the
    block ends."""
    fd, path = tempfile.mkstemp(suffix=".jsonl", dir=os.path.join(
        REPO, "fed_tgan_torch", "_build"))
    os.close(fd)
    events: list = []
    journal = RunJournal(path, validate=True)
    prev = set_journal(journal)
    try:
        yield events
    finally:
        set_journal(prev)
        journal.close()
        events.extend(read_journal(path))
        os.remove(path)


def _churn_cli(root: str, csv_path: str, seed: int, tag: str) -> dict:
    """The CLI in this process with the churn plan; returns its launches,
    events, wall and output directory."""
    from fed_tgan_torch.cli import main as cli_main

    out = os.path.join(root, f"churn_{tag}")
    argv = ["--mode", "fedavg", "--datapath", csv_path,
            "--dataset", "intrusion", "--n-clients", str(FED_CLIENTS),
            "-epochs", str(CHURN_ROUNDS), "--sample-rows",
            str(CHURN_SNAPSHOT_ROWS), "--out-dir", out, "--seed", str(seed),
            "--elastic-capacity", str(CHURN_CAPACITY), "--drift-every",
            str(CHURN_EVERY), "--save-every", "1", "--ckpt-keep",
            str(CHURN_ROUNDS), "--watchdog", "--faults", CHURN_FAULTS]
    stdout = io.StringIO()
    fused_apply_activate.launches = 0
    fused_activate_bwd.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout), journaled() as events:
            rc = cli_main(argv)
    finally:
        install_plan(None)
        os.environ.pop("FED_TGAN_TORCH_FAULTS", None)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"churn CLI exited {rc}: "
                             f"{stdout.getvalue()[-3000:]}")
    return {"out": out, "wall_s": wall, "events": events,
            "launches": {"K1": fused_apply_activate.launches,
                         "K2": fused_activate_bwd.launches},
            "stdout": stdout.getvalue()}


def _checkpoint_arrays(path: str) -> tuple:
    with open(os.path.join(path, "host.json")) as f:
        host = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return host, {k: z[k] for k in z.files}


def churn_phase(root: str, seed: int, card: str) -> dict:
    """Elastic membership at full width through the CLI, in this process
    (its launches counted): the federated round's 20,000-row CSV over 4
    clients, ``--elastic-capacity 8``, 8 rounds, a join of 2 at round 3, a
    departure of client 1 at round 5 and a drift of client 0 at round 6,
    a drift window every 2 rounds, a save every round under the watchdog.
    The population goes 4 -> 6 with client 1 dropped; the window after
    the drift alarms for client 0 and its weights are recomputed in it;
    the last snapshot is finite; a second run ends bit-equal; K1 and K2
    launch exactly ``max(steps) * (d_steps + 1) + chunks`` and
    ``max(steps)`` times a round at (8 * 500, D).  Then s/round of the
    same 4 clients at capacity 8 and at capacity 0, in turns."""
    csv_path = os.path.join(root, "churn.csv")
    write_intrusion_csv(csv_path, FED_ROWS, seed)
    runs = [_churn_cli(root, csv_path, seed, tag) for tag in ("a", "b")]
    run = runs[0]
    ck = os.path.join(run["out"], "checkpoint")
    host, arrays = _checkpoint_arrays(ck)
    rows = host["init"]["rows_per_client"]
    if len(rows) != FED_CLIENTS + 2 or host["dropped_clients"] != [1]:
        raise AssertionError(f"population {len(rows)} (want "
                             f"{FED_CLIENTS + 2}), dropped "
                             f"{host['dropped_clients']} (want [1])")
    if host["capacity"] != CHURN_CAPACITY:
        raise AssertionError(f"capacity {host['capacity']}")
    windows = [e for e in run["events"] if e["type"] == "drift_window"]
    alarms = [e for e in run["events"] if e["type"] == "drift_alarm"]
    drift_round = 5  # drift:round=6 lands at the start of 0-based round 5
    caught = [w for w in windows if 0 in w.get("drifted", [])]
    if not caught or caught[0]["round"] > drift_round + CHURN_EVERY \
            or caught[0].get("recompute_lag_rounds") != 0:
        raise AssertionError(f"drift of client 0 not caught within one "
                             f"window: {windows}")
    # the saves around the catching window: the weights moved in it
    gens = list_resumable(ck, max_rotations=CHURN_ROUNDS)
    by_round = {}
    for g in gens:
        h, _ = _checkpoint_arrays(g)
        by_round[h["completed_epochs"]] = h["weights"]
    w_round = caught[0]["round"]
    if by_round.get(w_round) == by_round.get(w_round + 1):
        raise AssertionError(f"weights not recomputed in the window of "
                             f"round {w_round}")
    restored = load_federated(ck, device="cuda")
    spec = restored.spec
    meta = restored.init.global_meta
    snap = os.path.join(run["out"], "Intrusion_result",
                        f"Intrusion_synthesis_epoch_{CHURN_ROUNDS - 1}.csv")
    with open(snap, "rb") as f:
        blob = f.read()
    head = blob.split(b"\n", 1)[0].decode().split(",")
    check_csv(blob, CHURN_SNAPSHOT_ROWS, True,
              [i for i, c in enumerate(head) if c in meta.continuous_columns])
    # the bit-exact rule: two runs from one seed end equal
    _, arrays_b = _checkpoint_arrays(os.path.join(runs[1]["out"],
                                                  "checkpoint"))
    if arrays.keys() != arrays_b.keys() or not all(
            np.array_equal(arrays[k], arrays_b[k]) for k in arrays):
        raise AssertionError("two churn runs from one seed differ")
    # launches: every round max(steps) stacked steps over all 8 slots
    cfg = steps.TrainConfig()
    B = cfg.batch_size
    steps_per_round = max(r // B for r in rows)
    chunks = len(restored._sampler()._chunk_plan(
        0, -(-CHURN_SNAPSHOT_ROWS // B), pow2_tail=False))
    per_round = {"K1": steps_per_round * (cfg.d_steps + 1) + chunks,
                 "K2": steps_per_round}
    want = {k: CHURN_ROUNDS * v for k, v in per_round.items()}
    for r in runs:
        if r["launches"] != want:
            raise AssertionError(f"churn launches {r['launches']} != {want}")
    # what the padded slots cost: the same 4 clients at capacity 8 and 0
    init = _fed_init(csv_path, FED_CLIENTS, seed, "cuda")
    turns = {}
    for cap in (CHURN_CAPACITY, 0, 0, CHURN_CAPACITY):
        tr = FederatedTrainer(init, cfg, seed=seed, device="cuda",
                              capacity=cap)
        tr.fit(3)
        turns.setdefault(cap, []).extend(tr.epoch_times[1:])
    ratio = statistics.median(turns[CHURN_CAPACITY]) / statistics.median(
        turns[0])
    report = {"wall_s": [r["wall_s"] for r in runs],
              "population": len(rows), "dropped": host["dropped_clients"],
              "windows": windows, "alarms": alarms,
              "launches": run["launches"], "launches_per_round": per_round,
              "s_per_round": {"capacity_8": turns[CHURN_CAPACITY],
                              "capacity_0": turns[0]},
              "padded_cost_ratio_p50": ratio,
              "train_rows": CHURN_CAPACITY * B, "spec": spec}
    print(f"churn: CLI --elastic-capacity {CHURN_CAPACITY} --faults "
          f"{CHURN_FAULTS!r}, {CHURN_ROUNDS} rounds: exit 0 in "
          f"{[r['wall_s'] for r in runs]!r} s; population {FED_CLIENTS} -> "
          f"{len(rows)}, dropped {host['dropped_clients']}; drift of client "
          f"0 caught in the window of round {caught[0]['round']} (drift at "
          f"round {drift_round}), weights recomputed there; windows "
          f"{[(w['round'], w.get('drifted')) for w in windows]}; two runs "
          f"bit-equal; launches {run['launches']} (== {want}, "
          f"{per_round} a round at ({CHURN_CAPACITY * B}, {spec.dim})); "
          f"s/round capacity 8 {turns[CHURN_CAPACITY]!r} vs capacity 0 "
          f"{turns[0]!r} (p50 ratio {ratio!r})  [{card}]", flush=True)
    return report



# --------------------------------------------------- slice 11: round scale

# the cohort federation: 32 IID clients of 1,000 rows (2 steps each), 8
# sampled a round, a 10,000-row snapshot a round
COHORT_CLIENTS, COHORT_ROWS, COHORT_C, COHORT_ROUNDS = 32, 1000, 8, 4
ROUND_SNAPSHOT_ROWS = 10_000
BUFFERED_FAULT = "straggle:rank=2,delay=2,round=2,until=3"
BUFFERED_ROUNDS = 5
EMA_DECAY, EMA_ROUNDS = 0.99, 4
RPP_ROUNDS, RPP_K = 8, 4
MDGAN_ROUNDS = 3


def _cli_run(argv: list) -> dict:
    """The training CLI in this process (its launches counted): K1/K2
    launches, the journal's events (a ``--journal`` of the argv takes
    them instead), stdout and wall seconds; fails unless it exits 0."""
    from fed_tgan_torch.cli import main as cli_main

    stdout = io.StringIO()
    activate_cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout), journaled() as events:
            rc = cli_main(argv)
    finally:
        install_plan(None)
        os.environ.pop("FED_TGAN_TORCH_FAULTS", None)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI {argv} exited {rc}: "
                             f"{stdout.getvalue()[-3000:]}")
    return {"launches": {"K1": fused_apply_activate.launches,
                         "K2": fused_activate_bwd.launches},
            "events": events, "stdout": stdout.getvalue(),
            "wall_s": wall}


def _fed_argv(csv_path: str, out: str, seed: int, cache: str,
              clients: int, epochs: int, *extra) -> list:
    return ["--datapath", csv_path, "--dataset", "intrusion",
            "--n-clients", str(clients), "-epochs", str(epochs),
            "--sample-rows", str(ROUND_SNAPSHOT_ROWS), "--out-dir", out,
            "--seed", str(seed), "--init-cache", cache, *extra]


def _same_checkpoint(what: str, a: str, b: str) -> None:
    """Two checkpoints hold equal arrays (weights, BatchNorm and Adam
    state, every generator's state, the EMA)."""
    ha, xa = _checkpoint_arrays(a)
    hb, xb = _checkpoint_arrays(b)
    bad = sorted(k for k in set(xa) | set(xb)
                 if k not in xa or k not in xb
                 or not np.array_equal(xa[k], xb[k]))
    if bad or ha["completed_epochs"] != hb["completed_epochs"]:
        raise AssertionError(f"{what}: {len(bad)} arrays differ "
                             f"({bad[:5]}), rounds {ha['completed_epochs']} "
                             f"vs {hb['completed_epochs']}")


def _chunks(trainer, rows: int) -> int:
    """K1 launches of one sample of ``rows`` rows (one a chunk)."""
    return len(trainer._sampler()._chunk_plan(
        0, -(-rows // trainer.cfg.batch_size), pow2_tail=False))


def _turns(make, labels: list, rounds: int) -> tuple[dict, dict]:
    """s/round of each label's trainer (``make(label)``), in the order
    given (turns), the first round of each run left out (warm-up); and
    the trainers of each label."""
    out, trainers = {}, {}
    for label in labels:
        tr = make(label)
        tr.fit(rounds)
        torch.cuda.synchronize()
        out.setdefault(label, []).extend(tr.epoch_times[1:])
        trainers.setdefault(label, []).append(tr)
    return out, trainers


def _stack_state(tr) -> list:
    """A stacked trainer's weights, BatchNorm, Adam state and
    generators."""
    st = tr.stack
    return [st.generator.params, st.generator.bn_state,
            st.discriminator.params, st.opt_g.exp_avg, st.opt_g.exp_avg_sq,
            st.opt_g.count, st.opt_d.exp_avg, st.opt_d.exp_avg_sq,
            st.opt_d.count] + [g.get_state() for g in tr.gens]


def cohort_phase(root: str, seed: int, card: str) -> dict:
    """Cohort sampling at full width: 32 IID clients of 1,000 rows, 8
    sampled a round, 4 rounds through the CLI with a snapshot a round: K1
    ``2 * steps + chunks`` and K2 ``steps`` launches a round over the
    cohort's (8 x 500, D) rows; the save after round 2 resumed for 2
    rounds ends bit-equal to the straight run, every slot's Adam count
    what its cohorts give it, two runs in this process bit-equal.  Then s/round at cohort 8 of 32, full participation of 32 and
    8 resident clients, in turns, and the peak device memory of 32
    resident slots."""
    csv_path = os.path.join(root, "cohort.csv")
    write_intrusion_csv(csv_path, COHORT_CLIENTS * COHORT_ROWS, seed)
    cache = os.path.join(root, "cohort_cache")
    kw = preprocessor_kwargs(PRESETS["intrusion"])
    shards = shard_table(read_csv(csv_path), COHORT_CLIENTS, "iid",
                         seed=seed)
    t0 = time.perf_counter()
    init32 = federated_initialize(
        [TablePreprocessor(table=t, name="Intrusion", **kw) for t in shards],
        seed=seed, device="cuda", cache=cache)
    init_s = time.perf_counter() - t0
    # 8 resident clients: the first 8 of the 32, their weights renormalized
    init8 = dataclasses.replace(
        init32, client_matrices=init32.client_matrices[:COHORT_C],
        transformers=init32.transformers[:COHORT_C],
        weights=init32.weights[:COHORT_C] / init32.weights[:COHORT_C].sum(),
        rows_per_client=init32.rows_per_client[:COHORT_C])
    cohort = ["--population", str(COHORT_CLIENTS), "--cohort",
              str(COHORT_C), "--save-every", "2", "--ckpt-keep", "2"]
    straight = _cli_run(_fed_argv(
        csv_path, os.path.join(root, "cohort_a"), seed, cache,
        COHORT_CLIENTS, COHORT_ROUNDS, *cohort))
    ck = os.path.join(root, "cohort_a", "checkpoint")
    # the save after round 2, resumed in a directory of its own
    half = os.path.join(root, "cohort_b")
    shutil.copytree(ck + ".1", os.path.join(half, "checkpoint"))
    resumed = _cli_run(_fed_argv(csv_path, half, seed, cache,
                                 COHORT_CLIENTS, COHORT_ROUNDS, *cohort,
                                 "--resume"))
    _same_checkpoint("cohort 4 rounds vs 2 + resume + 2", ck,
                     os.path.join(half, "checkpoint"))
    tr = load_federated(ck, device="cuda")
    B = tr.cfg.batch_size
    steps_per = COHORT_ROWS // B
    ids = [tr.cohort_ids(e) for e in range(COHORT_ROUNDS)]
    want_counts = np.zeros(COHORT_CLIENTS, dtype=np.int64)
    for row in ids:
        want_counts[row] += steps_per
    if not np.array_equal(tr.stack.opt_g.count.cpu().numpy(), want_counts):
        raise AssertionError(f"Adam counts {tr.stack.opt_g.count.tolist()} "
                             f"are not the cohorts' {want_counts.tolist()}")
    per_round = {"K1": steps_per * 2 + _chunks(tr, ROUND_SNAPSHOT_ROWS),
                 "K2": steps_per}
    want = {k: COHORT_ROUNDS * v for k, v in per_round.items()}
    if straight["launches"] != want:
        raise AssertionError(f"cohort launches {straight['launches']} != "
                             f"{want}")
    resumed_want = {k: (COHORT_ROUNDS - 2) * v for k, v in per_round.items()}
    if resumed["launches"] != resumed_want:
        raise AssertionError(f"resumed launches {resumed['launches']} != "
                             f"{resumed_want}")
    cfg = steps.TrainConfig()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = FederatedTrainer(init32, cfg, seed=seed, device="cuda").fit(1)
    peak_full = torch.cuda.max_memory_allocated() - base
    del full
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    FederatedTrainer(init32, dataclasses.replace(cfg, cohort=COHORT_C),
                     seed=seed, device="cuda").fit(1)
    peak_cohort = torch.cuda.max_memory_allocated() - base

    def make(label):
        init = init8 if label == "resident_8" else init32
        c = dataclasses.replace(cfg, cohort=COHORT_C if label ==
                                "cohort_8_of_32" else 0)
        return FederatedTrainer(init, c, seed=seed, device="cuda")

    order = ["cohort_8_of_32", "full_32", "resident_8", "resident_8",
             "full_32", "cohort_8_of_32"]
    turns, runs = _turns(make, order, 4)
    _require_equal("two cohort runs", *(_stack_state(t) for t in
                                        runs["cohort_8_of_32"]))
    p50 = {k: statistics.median(v) for k, v in turns.items()}
    report = {"clients": COHORT_CLIENTS, "cohort": COHORT_C,
              "rows_per_client": COHORT_ROWS, "init_s": init_s,
              "cli_wall_s": straight["wall_s"],
              "launches": straight["launches"],
              "launches_per_round": per_round, "cohorts": [
                  r.tolist() for r in ids],
              "s_per_round": turns, "s_per_round_p50": p50,
              "peak_mem_bytes": {"full_32": peak_full,
                                 "cohort_8_of_32": peak_cohort},
              "train_rows": COHORT_C * B, "spec": tr.spec}
    print(f"cohort: CLI --population {COHORT_CLIENTS} --cohort {COHORT_C}, "
          f"{COHORT_ROUNDS} rounds: exit 0 in {straight['wall_s']!r} s "
          f"(init {init_s!r} s in process, then cached); launches "
          f"{straight['launches']} (== {want}, {per_round} a round at "
          f"({COHORT_C * B}, {tr.spec.dim})); 2 rounds + --resume + 2 "
          f"rounds bit-equal to 4 straight, Adam counts = the cohorts'; two "
          f"in-process runs bit-equal; "
          f"cohorts {report['cohorts']}; s/round in turns {turns!r} (p50 "
          f"{p50!r}); peak device memory of a round of 32 resident slots "
          f"{peak_full} B, of a cohort round {peak_cohort} B  [{card}]",
          flush=True)
    return report


def buffered_phase(root: str, seed: int, card: str) -> dict:
    """Buffered aggregation through the CLI on the federated round's 4
    clients: ``--aggregation buffered --faults straggle:rank=2,delay=2,
    round=2,until=3`` for 5 rounds, the two deltas landing at rounds 4
    and 5 (1-based) with discount ``weight * 0.5^2``; the same run with no
    fault equal to ``--aggregation sync`` bit for bit."""
    csv_path = os.path.join(root, "fed.csv")
    cache = os.path.join(root, "fed_cache")
    outs = {}
    for tag, extra in (("straggle", ["--aggregation", "buffered",
                                     "--faults", BUFFERED_FAULT]),
                       ("buffered", ["--aggregation", "buffered"]),
                       ("sync", [])):
        outs[tag] = os.path.join(root, f"buffered_{tag}")
        run = _cli_run(_fed_argv(
            csv_path, outs[tag], seed, cache, FED_CLIENTS, BUFFERED_ROUNDS,
            "--sample-every", "0", "--save-every", str(BUFFERED_ROUNDS),
            *extra))
        if tag == "straggle":
            straggle = run
    _same_checkpoint("buffered without a straggler vs sync",
                     os.path.join(outs["buffered"], "checkpoint"),
                     os.path.join(outs["sync"], "checkpoint"))
    host, _ = _checkpoint_arrays(os.path.join(outs["straggle"], "checkpoint"))
    w = host["weights"][1]
    landed = [(e["origin"], e["round"], e["staleness"], e["discount"])
              for e in straggle["events"] if e.get("type") == "aggregate"
              and e.get("aggregator") == "buffered"]
    if [x[:3] for x in landed] != [(1, 3, 2), (2, 4, 2)] or not all(
            math.isclose(x[3], w * 0.25, rel_tol=1e-6) for x in landed):
        raise AssertionError(f"buffered arrivals {landed}, weight {w}")
    print(f"buffered: CLI --aggregation buffered --faults {BUFFERED_FAULT!r}"
          f", {BUFFERED_ROUNDS} rounds: exit 0 in {straggle['wall_s']!r} s; "
          f"client 1's deltas (origin, round, staleness, discount) "
          f"{landed} (weight {w!r} x 0.25); without the fault bit-equal to "
          f"--aggregation sync  [{card}]", flush=True)
    return {"arrivals": landed, "weight": w, "wall_s": straggle["wall_s"]}


def ema_phase(root: str, seed: int, card: str) -> dict:
    """``--ema-decay 0.99`` through the CLI, 4 rounds with a snapshot and
    a save each: the last snapshot's bytes are the debiased EMA's rows
    (not the raw aggregate's), the ``--save-model`` artifact's generator
    is ``_global_model()``, and the save after round 2 resumed for 2
    rounds ends bit-equal to the straight run, EMA included."""
    from fed_tgan_torch.runtime.checkpoint import SYNTH_DIR, load_synthesizer

    csv_path = os.path.join(root, "fed.csv")
    out = os.path.join(root, "ema")
    run = _cli_run(_fed_argv(csv_path, out, seed,
                             os.path.join(root, "fed_cache"), FED_CLIENTS,
                             EMA_ROUNDS, "--ema-decay", str(EMA_DECAY),
                             "--save-every", "1", "--ckpt-keep",
                             str(EMA_ROUNDS), "--save-model"))
    ck = os.path.join(out, "checkpoint")
    tr = load_federated(ck, device="cuda")
    if tr._ema_updates != EMA_ROUNDS:
        raise AssertionError(f"EMA updates {tr._ema_updates}")
    art = load_synthesizer(os.path.join(out, "models", SYNTH_DIR), "cuda")
    ema = tr._global_model()
    saved = art.generator.state_dict()
    if any(not torch.equal(saved[k], v) for k, v in ema.items()):
        raise AssertionError("the artifact's generator is not the EMA")
    last = EMA_ROUNDS - 1
    meta, enc = tr.init.global_meta, tr.init.encoders
    want = plain_csv_bytes(decode_columns(tr.decode.assemble(
        tr.sample_parts(ROUND_SNAPSHOT_ROWS, seed=seed + last)), meta, enc))
    snap = os.path.join(out, "Intrusion_result",
                        f"Intrusion_synthesis_epoch_{last}.csv")
    with open(snap, "rb") as f:
        if f.read() != want:
            raise AssertionError("the last snapshot is not the EMA's rows")
    raw = tr.sample_encoded(2000, seed=1, use_ema=False)
    smooth = tr.sample_encoded(2000, seed=1)
    if np.allclose(raw, smooth):
        raise AssertionError("EMA and raw generators sample alike")
    gens = {_checkpoint_arrays(g)[0]["completed_epochs"]: g
            for g in list_resumable(ck, max_rotations=EMA_ROUNDS)}
    mid = load_federated(gens[2], device="cuda").fit(EMA_ROUNDS - 2)
    for a, b in zip([*mid.ema, mid.stack.generator.params,
                     mid.stack.discriminator.params,
                     mid.stack.opt_d.exp_avg_sq],
                    [*tr.ema, tr.stack.generator.params,
                     tr.stack.discriminator.params,
                     tr.stack.opt_d.exp_avg_sq]):
        if not torch.equal(a, b):
            raise AssertionError("EMA resume after round 2 differs")
    print(f"ema: CLI --ema-decay {EMA_DECAY}, {EMA_ROUNDS} rounds with a "
          f"save each: exit 0 in {run['wall_s']!r} s; the artifact's "
          f"generator == _global_model() (debiased by 1/(1 - "
          f"{EMA_DECAY}^{EMA_ROUNDS})); the last snapshot's bytes are the "
          f"EMA's rows; the save after round 2 resumed bit-equal, EMA "
          f"included  [{card}]", flush=True)
    return {"wall_s": run["wall_s"], "ema_updates": tr._ema_updates}


def rounds_per_program_phase(init, seed: int, card: str) -> dict:
    """8 hook-free rounds of the federated round's 4 clients in chunks of
    4 and of 1: bit-equal, 2 host copies against 8, launches exact; then
    s/round of each in turns (4, 1, 1, 4)."""
    cfg = steps.TrainConfig()
    runs, copies = {}, {}
    activate_cuda.reset_launches()
    for k in (RPP_K, 1, 1, RPP_K):
        tr = FederatedTrainer(init, cfg, seed=seed, device="cuda")
        t0 = time.perf_counter()
        tr.fit(RPP_ROUNDS, max_rounds_per_call=k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.setdefault(k, []).append((tr, wall / RPP_ROUNDS))
        copies.setdefault(k, []).append(tr.host_copies)
    n = int(runs[1][0][0].steps.max())
    want = {"K1": 4 * RPP_ROUNDS * n * 2, "K2": 4 * RPP_ROUNDS * n}
    launches = {"K1": fused_apply_activate.launches,
                "K2": fused_activate_bwd.launches}
    if launches != want:
        raise AssertionError(f"rounds-per-program launches {launches} != "
                             f"{want}")
    if copies != {RPP_K: [RPP_ROUNDS // RPP_K] * 2, 1: [RPP_ROUNDS] * 2}:
        raise AssertionError(f"host copies {copies}")
    _require_equal(f"K = {RPP_K} vs K = 1", _trainer_state(runs[RPP_K][0][0]),
                   _trainer_state(runs[1][0][0]))
    s_per = {f"K{k}": [w for _, w in v] for k, v in runs.items()}
    print(f"rounds per program: {RPP_ROUNDS} hook-free rounds at K = {RPP_K}"
          f" bit-equal to K = 1; host copies {copies}; launches {launches}; "
          f"s/round in turns {s_per!r}  [{card}]", flush=True)
    return {"host_copies": copies, "s_per_round": s_per,
            "launches": launches}


def mdgan_phase(root: str, init, seed: int, card: str) -> dict:
    """``--mode mdgan`` through the CLI on the federated round's 4
    clients, 3 rounds with a snapshot and a save each: K1 ``2 * steps +
    chunks`` and K2 ``steps`` launches a round over (4 x 500, D), the 4
    discriminators apart, the shared generator without a clients axis, a
    run of 2 rounds + ``--resume`` bit-equal to 3 straight, two runs in
    this process bit-equal.  Then one
    step's generator update on the card against the CPU from the same
    weights and injected draws (``step_reference_phase``'s tolerances),
    and s/round beside fedavg's on the same clients, in turns."""
    from fed_tgan_torch.train.mdgan import MDGANTrainer

    csv_path = os.path.join(root, "fed.csv")
    cache = os.path.join(root, "fed_cache")
    a, b = (os.path.join(root, f"mdgan_{t}") for t in ("a", "b"))
    common = ["--mode", "mdgan", "--save-every", "1"]
    run = _cli_run(_fed_argv(csv_path, a, seed, cache, FED_CLIENTS,
                             MDGAN_ROUNDS, *common))
    _cli_run(_fed_argv(csv_path, b, seed, cache, FED_CLIENTS, 2, *common))
    _cli_run(_fed_argv(csv_path, b, seed, cache, FED_CLIENTS, MDGAN_ROUNDS,
                       *common, "--resume"))
    _same_checkpoint("mdgan 3 rounds vs 2 + resume + 1",
                     os.path.join(a, "checkpoint"),
                     os.path.join(b, "checkpoint"))
    tr = load_federated(os.path.join(a, "checkpoint"), device="cuda")
    n_steps = int(tr.steps.max())
    per_round = {"K1": 2 * n_steps + _chunks(tr, ROUND_SNAPSHOT_ROWS),
                 "K2": n_steps}
    want = {k: MDGAN_ROUNDS * v for k, v in per_round.items()}
    if run["launches"] != want:
        raise AssertionError(f"mdgan launches {run['launches']} != {want}")
    d = tr.disc.stack.params
    if tr.gen.params.shape[0] != 1 or any(
            torch.equal(d[0], d[i]) for i in range(1, d.shape[0])):
        raise AssertionError("MD-GAN models: shared G or distinct D lost")

    # one step on the card against the CPU
    cfg = steps.TrainConfig()
    spec = tr.spec
    host_models = steps.init_models(spec, cfg, seed + 5, "cpu")
    gen = torch.Generator().manual_seed(seed + 6)
    draws = [steps.draw_step(gen, host_models) for _ in range(FED_CLIENTS)]
    res = {}
    for dev in ("cuda", "cpu"):
        one = MDGANTrainer(init, cfg, seed=seed, device=dev,
                           models=steps.init_models(spec, cfg, seed + 5, dev),
                           draws=lambda e, i, s, dev=dev: draws[i].to(dev))
        one.steps = np.ones(FED_CLIENTS, dtype=np.int64)
        one.fit(1)
        res[dev] = [x.detach().cpu().numpy() for x in (
            one.gen.params, one.gen.opt.grad, one.disc.stack.params,
            one.disc.opt.grad)] + [one.last_metrics]
    (gp_c, gg_c, dp_c, dg_c, met_c), (gp_h, gg_h, dp_h, dg_h, met_h) = (
        res["cuda"], res["cpu"])
    if not np.allclose(met_c, met_h, rtol=1e-4, atol=1e-6):
        raise AssertionError(f"mdgan losses card {met_c} vs CPU {met_h}")
    grad_err = max(_close("G gradient", gg_c, gg_h, 1e-5, 1e-3)[0],
                   _close("D gradient", dg_c, dg_h, 1e-5, 1e-3)[0])
    par_err, skipped = 0.0, 0
    for pc, ph, gh in ((gp_c, gp_h, gg_h), (dp_c, dp_h, dg_h)):
        err, n = _close("parameter", pc, ph, 1e-6, 0.0,
                        skip=np.abs(gh) < 1e-6)
        par_err, skipped = max(par_err, err), skipped + n

    def make(label):
        cls = MDGANTrainer if label == "mdgan" else FederatedTrainer
        return cls(init, cfg, seed=seed, device="cuda")

    turns, runs = _turns(make, ["mdgan", "fedavg", "fedavg", "mdgan"], 3)
    _require_equal("two MD-GAN runs", *([
        t.gen.params, t.gen.state, t.gen.opt.exp_avg_sq, t.disc.stack.params,
        t.disc.opt.exp_avg] + [g.get_state() for g in t.gens]
        for t in runs["mdgan"]))
    print(f"mdgan: CLI --mode mdgan, {MDGAN_ROUNDS} rounds: exit 0 in "
          f"{run['wall_s']!r} s; launches {run['launches']} (== {want}, "
          f"{per_round} a round at ({FED_CLIENTS * cfg.batch_size}, "
          f"{spec.dim})); 2 rounds + --resume bit-equal to 3 straight, two "
          f"in-process runs bit-equal; G "
          f"{tuple(tr.gen.params.shape)}, 4 discriminators apart; one step "
          f"card vs CPU: losses within rtol 1e-4, gradients max abs diff "
          f"{grad_err!r} (atol 1e-5 + rtol 1e-3), parameters {par_err!r} "
          f"(atol 1e-6, {skipped} tiny-gradient entries set aside); s/round "
          f"in turns {turns!r}  [{card}]", flush=True)
    return {"wall_s": run["wall_s"], "launches": run["launches"],
            "launches_per_round": per_round, "grad_max_diff": grad_err,
            "param_max_diff": par_err, "tiny_grad_entries": skipped,
            "s_per_round": turns, "train_rows": FED_CLIENTS * cfg.batch_size,
            "spec": spec}


def round_scale_phases(root: str, init, seed: int, card: str) -> dict:
    """Slice 11's phases, their wall seconds each."""
    write_intrusion_csv(os.path.join(root, "fed.csv"), FED_ROWS, seed)
    out, wall = {}, {}
    for name, fn in (
            ("cohort", lambda: cohort_phase(root, seed, card)),
            ("buffered", lambda: buffered_phase(root, seed, card)),
            ("ema", lambda: ema_phase(root, seed, card)),
            ("rounds_per_program",
             lambda: rounds_per_program_phase(init, seed, card)),
            ("mdgan", lambda: mdgan_phase(root, init, seed, card))):
        t0 = time.perf_counter()
        out[name] = fn()
        wall[name] = time.perf_counter() - t0
    out["wall_s"] = wall
    return out

# slice 12's world: rank 0 and one participant per 5,000-row shard of the
# federated round's CSV, 3 rounds, a 40,000-row snapshot a round
MP_CLIENTS, MP_ROUNDS = 4, 3
_mp_port = [20000 + (os.getpid() * 13) % 9000]


def _free_ports() -> int:
    """A port p with p and p + 1 free (the transport's and the process
    group's store), below Linux's ephemeral range."""
    import socket

    while True:
        p = _mp_port[0]
        _mp_port[0] += 2
        try:
            for q in (p, p + 1):
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", q))
            return p
        except OSError:
            continue


def _mp_world(root: str, tag: str, shards: list, seed: int, epochs: int,
              *extra, rank1_here: bool = True, env=None, profile=False,
              timeout: float = 420.0) -> dict:
    """A world of rank 0 and one participant per shard through the CLI
    (``-ip 127.0.0.1 -port P -rank r``): rank 0 and ranks 2..N as
    processes of their own; rank 1 in this process (``rank1_here``, its
    K1/K2 launches counted, optionally under ``torch.profiler``) or as a
    process too.  Every process is waited for within ``timeout`` seconds
    and killed past it.  Returns each rank's exit code, stdout and
    stderr, rank 1's ``_cli_run`` result, the profile's K1/K2 launches
    and rank 1's device busy ms beside its wall, and the wall seconds."""
    out = os.path.join(root, tag)
    port = _free_ports()
    common = ["--dataset", "intrusion", "-epochs", str(epochs),
              "--sample-rows", str(SNAPSHOT_ROWS), "--seed", str(seed),
              "--out-dir", out, "--params-out", os.path.join(out, "params"),
              "-ip", "127.0.0.1", "-port", str(port), *extra]
    argvs = [common + ["-rank", "0", "-world_size", str(len(shards) + 1)]]
    argvs += [common + ["-rank", str(r), "-datapath", sh]
              for r, sh in enumerate(shards, start=1)]
    penv = {**os.environ, **(env or {}),
            "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    os.makedirs(out, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for rank, argv in enumerate(argvs):
        if rank == 1 and rank1_here:
            continue
        logs = [open(os.path.join(out, f"r{rank}.{k}"), "w+")
                for k in ("out", "err")]
        procs[rank] = (subprocess.Popen(
            [sys.executable, "-m", "fed_tgan_torch", *argv], cwd=REPO,
            env=penv, stdout=logs[0], stderr=logs[1]), logs)
    here = events = None
    try:
        if rank1_here:
            if profile:
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile as prof

                with prof(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as tr:
                    here = _cli_run(argvs[1])
                    torch.cuda.synchronize()
                dev = [e for e in tr.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)]
                events = {k: sum(1 for e in dev if name in e.name)
                          for k, name in KERNEL_NAMES.items()}
                # the device's busy time over rank 1's whole run (init,
                # round, snapshot), against the run's wall
                events["busy_ms"] = sum(e.time_range.elapsed_us()
                                        for e in dev) / 1e3
                events["wall_s"] = here["wall_s"]
            else:
                here = _cli_run(argvs[1])
        deadline = t0 + timeout
        for p, _ in procs.values():
            p.wait(timeout=max(0.0, deadline - time.perf_counter()))
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    res = {"rcs": {}, "out": {}, "err": {}, "here": here, "events": events,
           "wall_s": wall, "dir": out}
    for rank, (p, logs) in procs.items():
        res["rcs"][rank] = p.returncode
        for k, f in zip(("out", "err"), logs):
            f.seek(0)
            res[k][rank] = f.read()
            f.close()
    if here is not None:
        res["rcs"][1], res["out"][1], res["err"][1] = 0, here["stdout"], ""
    return res


def _world_ok(what: str, res: dict) -> None:
    bad = {r: rc for r, rc in res["rcs"].items() if rc != 0}
    if bad:
        raise AssertionError(f"{what}: ranks {bad} exited non-zero: " + " | ".join(
            res["err"].get(r, "")[-1500:] for r in bad))


def _world_params(res: dict, n: int) -> list:
    return [torch.load(os.path.join(res["dir"], "params",
                                    f"params_rank{r}.pt"))
            for r in range(1, n + 1)]


def _num(pattern: str, text: str) -> float:
    import re

    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"no {pattern!r} in {text[-1500:]!r}")
    return float(m.group(1))


def _round_tolerance(what: str, got: dict, want: dict) -> dict:
    """``got`` against ``want`` (generator state dicts) by the round
    tolerance of PERF.md §2 and the cohort tests: at least 99% of the
    model's float entries within atol 1e-5 + rtol 1e-3; returns the max
    abs error, the share within (the model's and its worst tensor's) and
    whether the two are bit-equal."""
    worst, inside, total, equal, low = 0.0, 0, 0, True, 1.0
    for k, v in want.items():
        a = np.asarray(got[k])
        equal &= np.array_equal(a, v)
        if a.dtype.kind != "f":
            continue
        close = np.abs(a - v) <= 1e-5 + 1e-3 * np.abs(v)
        worst = max(worst, float(np.abs(a.astype(np.float64) - v).max()))
        inside += int(close.sum())
        total += close.size
        low = min(low, float(close.mean()))
    if inside < 0.99 * total:
        raise AssertionError(f"{what}: {inside} of {total} entries within "
                             "the round tolerance")
    return {"max_abs_err": worst, "share_within": inside / total,
            "worst_tensor_share": low, "bit_equal": bool(equal)}


def _artifact_generator(out_dir: str) -> dict:
    with np.load(os.path.join(out_dir, "models", "synthesizer_torch",
                              "weights.npz")) as z:
        return {k[len("generator."):]: z[k] for k in z.files
                if k.startswith("generator.")}


def multiprocess_phase(root: str, seed: int, card: str) -> dict:
    """Slice 12's main path: the federated round's data as 4 shard CSVs
    of 5,000 rows, a world of rank 0 and 4 participants through the CLI,
    3 rounds at full width with a 40,000-row packed8 snapshot a round
    (rank 1 in this process, its launches counted).  The ranks' final
    generators equal, and equal to a second world's; a world's first
    round against the in-process CLI's first round on the same 4 CSVs
    (``--client-data``, same seed) within the round tolerance, whether
    bit-equal printed (later rounds grow any rounding difference, as the
    GAN does; the 3-round difference is printed); the init's weights
    equal to the in-process init's; that 1-round world, its save and
    ``--resume`` to 3 equal to the straight world; K1/K2 launches a round
    in rank 1 (counted, and under ``torch.profiler``); s/round per
    participant, rank 0's wall, the all-gather's bytes and ms a round and the
    collective backend, beside the in-process stacked round's s/round (in
    turns: world, in-process, in-process, world).  A participant killed
    mid-run is :func:`pod_phase`'s departure pod (``--pod``)."""
    from fed_tgan_torch.parallel import multihost as mh

    table = read_csv(write_intrusion_csv(os.path.join(root, "mp.csv"),
                                         FED_ROWS, seed))
    shards = []
    for i, part in enumerate(shard_table(table, MP_CLIENTS, "iid",
                                         seed=seed)):
        shards.append(os.path.join(root, f"shard{i + 1}.csv"))
        write_csv(part, shards[-1])
    install_plan(None)
    out = {"clients": MP_CLIENTS, "rounds": MP_ROUNDS,
           "rows_per_client": FED_ROWS // MP_CLIENTS}

    def in_process(tag, rounds=MP_ROUNDS):
        r = _cli_run(["--client-data", *shards, "--dataset", "intrusion",
                      "-epochs", str(rounds), "--sample-rows",
                      str(SNAPSHOT_ROWS), "--seed", str(seed), "--save-model",
                      "--out-dir", os.path.join(root, tag)])
        return r, _num(r"\(([\d.]+)s/round\)", r["stdout"])

    # turns: world, in-process, in-process, world
    mh.stats["bytes"].clear()
    mh.stats["seconds"].clear()
    w1 = _mp_world(root, "w1", shards, seed, MP_ROUNDS)
    _world_ok("world", w1)
    gather_bytes = list(mh.stats["bytes"])
    gather_s = list(mh.stats["seconds"])
    launches = w1["here"]["launches"]
    _, s_in1 = in_process("in1")
    _, s_in2 = in_process("in2")
    # the second world journals: one journal per rank
    w4 = _mp_world(root, "w4", shards, seed, MP_ROUNDS, "--journal",
                   os.path.join(root, "w4", "journal.jsonl"))
    _world_ok("second world", w4)
    rank_journals = [os.path.join(w4["dir"], f"journal_rank{r}.jsonl")
                     for r in range(MP_CLIENTS + 1)]
    rc, text, err = _obs_tool("report", "--format", "json", *rank_journals)
    merged = json.loads(text) if rc == 0 else {}
    if (rc != 0 or merged["rounds"]["total_rounds"] != MP_ROUNDS
            or merged["clients"]["tracked"] != MP_CLIENTS
            or merged["by_type"].get("schema_violation")):
        raise AssertionError(f"merged per-rank report (rc {rc}): "
                             f"{merged.get('rounds')}, "
                             f"{merged.get('clients', {}).get('tracked')}, "
                             f"{merged.get('by_type')} {err[-1500:]}")

    text0 = w1["out"][0]
    if f"final aggregated params identical across {MP_CLIENTS}" not in text0:
        raise AssertionError(f"rank 0's equality check: {text0[-1500:]}")
    backend = "gloo" if "collective backend gloo" in w1["out"][1] else (
        "nccl" if "collective backend nccl" in w1["out"][1] else None)
    params = _world_params(w1, MP_CLIENTS)
    for r, pr in enumerate(params[1:], start=2):
        _require_equal(f"rank {r} vs rank 1 generator",
                       list(pr["generator"].values()),
                       list(params[0]["generator"].values()))
    _require_equal("two worlds from one seed",
                   list(_world_params(w4, 1)[0]["generator"].values()),
                   list(params[0]["generator"].values()))
    result = os.path.join(w1["dir"], "Intrusion_result")
    for e in range(MP_ROUNDS):
        with open(os.path.join(result,
                               f"Intrusion_synthesis_epoch_{e}.csv")) as f:
            rows = f.read().splitlines()
        if len(rows) != SNAPSHOT_ROWS + 1 or len(rows[0].split(",")) != 42:
            raise AssertionError(f"snapshot {e}: {len(rows)} lines")
    final = {k: v.numpy() for k, v in params[0]["generator"].items()}
    want3 = _artifact_generator(os.path.join(root, "in1"))
    after3 = {"max_abs_err": max(
        float(np.abs(final[k].astype(np.float64) - v).max())
        for k, v in want3.items() if v.dtype.kind == "f"),
        "bit_equal": all(np.array_equal(final[k], v)
                         for k, v in want3.items())}
    # the init's weights against the in-process init's, bit for bit
    kw = preprocessor_kwargs(PRESETS["intrusion"])
    sel = kw.pop("selected_columns", None)
    tables = [read_csv(p) for p in shards]
    pres = [TablePreprocessor(table=t, name="Intrusion",
                              selected_columns=list(sel or tables[0]), **kw)
            for t in tables]
    init = federated_initialize(pres, seed=seed)
    world_w = ast.literal_eval(text0.split("weights=", 1)[1].splitlines()[0])
    if not torch.equal(torch.tensor(world_w, dtype=torch.float64),
                       torch.tensor(np.asarray(init.weights),
                                    dtype=torch.float64)):
        raise AssertionError(f"init weights {world_w} vs {init.weights}")
    spec = SegmentSpec.from_output_info(init.output_info)
    # 1 round and a save (rank 1 under the profiler), held against the
    # in-process CLI's first round; then --resume to 3
    w2 = _mp_world(root, "w2", shards, seed, 1, "--save-every", "1",
                   profile=True)
    _world_ok("1 round", w2)
    in_process("in0", rounds=1)
    first = _round_tolerance(
        "world vs in-process after round 1",
        {k: v.numpy() for k, v in
         _world_params(w2, 1)[0]["generator"].items()},
        _artifact_generator(os.path.join(root, "in0")))
    w3 = _mp_world(root, "w2", shards, seed, MP_ROUNDS, "--save-every", "1",
                   "--resume")
    _world_ok("resume", w3)
    for r, pr in enumerate(_world_params(w3, MP_CLIENTS), start=1):
        _require_equal(f"rank {r} resumed vs straight",
                       list(pr["generator"].values()),
                       list(params[r - 1]["generator"].values()))

    per_rank = {r: {k: _num(pat, w1["out"][r]) for k, pat in (
        ("s_per_round", r"training complete: ([\d.e-]+)s/round"),
        ("local_steps_s", r"local steps ([\d.e-]+)s"),
        ("all_gather_ms", r"all-gather ([\d.e-]+) ms"),
        ("snapshot_dispatch_s", r"snapshot dispatch ([\d.e-]+)s"))}
        for r in range(1, MP_CLIENTS + 1)}
    csv_s = ast.literal_eval(text0.split("snapshot CSVs written in ", 1)[1]
                             .split(" s on", 1)[0])
    world_wall = [_num(r"\(([\d.]+)s/round incl\. snapshots\)", w["out"][0])
                  for w in (w1, w4)]
    out.update({
        "backend": backend, "init_s": _num(r"clients in ([\d.]+)s", text0),
        "by_rank": per_rank, "rank0_csv_s": csv_s,
        "world_wall_s_per_round": world_wall,
        "in_process_s_per_round": [s_in1, s_in2],
        "all_gather": {"bytes": gather_bytes[0] if gather_bytes else None,
                       "ms": [1e3 * x for x in gather_s]},
        "launches_rank1": launches,
        "launches_per_round": {k: v / MP_ROUNDS for k, v in
                               launches.items()},
        "rank1_profile_one_round": w2["events"],
        "journaled_world": {"rounds": merged["rounds"]["total_rounds"],
                            "clients": merged["clients"]["tracked"],
                            "events": merged["by_type"]},
        "vs_in_process_round1": first, "vs_in_process_round3": after3,
        "world_wall_s": [w1["wall_s"], w4["wall_s"]],
        "resume_wall_s": [w2["wall_s"], w3["wall_s"]],
        "train_rows": steps.TrainConfig().batch_size, "spec": spec,
        # the straight world's final generator: the pod phase's reference
        "world_generator": params[0]["generator"]})
    print(f"multiprocess: {MP_CLIENTS} participants + rank 0, backend "
          f"{backend}; init {out['init_s']!r} s; by rank {per_rank}; rank "
          f"0's snapshot CSVs {csv_s} s (writer thread); "
          f"rank 0 wall {world_wall} s/round incl. snapshots (worlds in "
          f"turns 1 and 4) against the in-process stacked round "
          f"{[s_in1, s_in2]} s/round (turns 2 and 3); all-gather "
          f"{out['all_gather']['bytes']} bytes a round, "
          f"{out['all_gather']['ms']} ms  [{card}]", flush=True)
    print(f"multiprocess: K1/K2 launches in rank 1 over {MP_ROUNDS} rounds "
          f"{launches} ({out['launches_per_round']} a round; one round under "
          f"torch.profiler {w2['events']}); world vs in-process after round "
          f"1 {first}, after {MP_ROUNDS} rounds {after3}; resume == straight; "
          f"two worlds bit-equal (the second journaled: merged per-rank "
          f"report {merged['rounds']['total_rounds']} rounds, "
          f"{merged['clients']['tracked']} clients); init weights "
          f"bit-equal  [{card}]", flush=True)
    return out


def _multiprocess_with_checks(build_root: str, seed: int, card: str):
    """:func:`multiprocess_phase` in a scratch directory, then K1 and K2
    against their plain versions at a participant's shape (one batch of
    the federation's layout); returns the phase's numbers and both
    kernels' results."""
    mp_root = tempfile.mkdtemp(prefix="chip_smoke_mp_", dir=build_root)
    try:
        mp = multiprocess_phase(mp_root, seed, card)
    finally:
        shutil.rmtree(mp_root, ignore_errors=True)
    rows = (("multiprocess", mp["train_rows"]),)
    sp = mp.pop("spec")
    return (mp, check_kernel(sp, card, rows, extra=False),
            check_bwd_kernel(sp, card, rows, extra=False))


# --------------------------------------------------------- the observatory

OBS_ROUNDS = 3  # the CLI run's rounds; the last one traced
OBS_TURN_ROUNDS = 5  # rounds of each in-process turn, observatory on/off
OBS_SPANS = ("train.local_steps", "train.aggregate.sync", "train.snapshot")


def _get(url: str, timeout: float = 10.0) -> tuple:
    """``(body, headers, ms)`` of one GET."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body, headers = r.read(), dict(r.headers)
    return body, headers, 1e3 * (time.perf_counter() - t0)


def _watch_exporter(lines: list, done: threading.Event) -> dict:
    """While the CLI runs: find its exporter's URL in its output, poll
    ``/healthz`` until it reports ``training``, then read ``/metrics``
    and ``/journal?offset=0`` once."""
    seen: dict = {}
    url = None
    while not done.is_set() and url is None:
        for ln in list(lines):
            if ln.startswith("obs: live telemetry on "):
                url = ln.split()[4]
        time.sleep(0.02)
    while url is not None and not done.is_set():
        try:
            health = json.loads(_get(url + "/healthz")[0])
        except OSError:
            time.sleep(0.02)
            continue
        if health.get("status") == "training":
            metrics = _get(url + "/metrics")[0].decode()
            body, headers, _ = _get(url + "/journal?offset=0")
            seen = {"url": url, "health": health,
                    "client_weight_series": sorted(
                        ln.split()[0] for ln in metrics.splitlines()
                        if ln.startswith("fed_tgan_client_weight{")),
                    "journal_bytes": len(body),
                    "journal_lines": len(body.splitlines()),
                    "x_journal_offset": headers.get("X-Journal-Offset")}
            break
        time.sleep(0.02)
    return seen


def _obs_cli(root: str, csv_path: str, seed: int) -> dict:
    """The CLI as a process of its own with ``--journal --obs-port 0
    --profile-dir --profile-rounds 1`` (validation armed), its exporter
    read while it runs."""
    out = os.path.join(root, "obs_cli")
    jpath, prof = os.path.join(out, "journal.jsonl"), os.path.join(out, "prof")
    argv = [sys.executable, "-m", "fed_tgan_torch", "--mode", "fedavg",
            "--datapath", csv_path, "--dataset", "intrusion", "--n-clients",
            str(FED_CLIENTS), "-epochs", str(OBS_ROUNDS), "--sample-rows",
            str(SNAPSHOT_ROWS), "--monitor-every", "1", "--save-every", "1",
            "--precision", "f32", "--out-dir", out, "--seed", str(seed),
            "--journal", jpath, "--obs-port", "0", "--profile-dir", prof,
            "--profile-rounds", "1"]
    env = {**os.environ, "FED_TGAN_TORCH_VALIDATE_JOURNAL": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines: list = []
    done = threading.Event()
    err: list = []
    readers = [threading.Thread(target=lambda: lines.extend(
        ln.rstrip("\n") for ln in proc.stdout), daemon=True),
        threading.Thread(target=lambda: err.append(proc.stderr.read()),
                         daemon=True)]
    for t in readers:
        t.start()
    live: dict = {}
    watcher = threading.Thread(
        target=lambda: live.update(_watch_exporter(lines, done)), daemon=True)
    watcher.start()
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        done.set()
    for t in readers + [watcher]:
        t.join(timeout=30)
    stdout = "\n".join(lines)
    if rc != 0:
        raise AssertionError(f"observatory CLI exited {rc}: "
                             f"{(err[0] if err else '')[-3000:]}")
    return {"out": out, "journal": jpath, "prof": prof, "stdout": stdout,
            "live": live, "wall_s": time.perf_counter() - t0}


def _obs_tool(*args) -> tuple:
    """``python -m fed_tgan_torch.obs ARGS``: ``(exit code, stdout,
    stderr)``."""
    proc = subprocess.run([sys.executable, "-m", "fed_tgan_torch.obs",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    return proc.returncode, proc.stdout, proc.stderr


def _require_events(what: str, events: list, types: tuple) -> dict:
    """The journaled ``events`` hold every one of ``types`` and no
    ``schema_violation``; returns the count of each type."""
    counts: dict = {}
    for e in events:
        counts[e["type"]] = counts.get(e["type"], 0) + 1
    missing = [t for t in types if not counts.get(t)]
    if missing or counts.get("schema_violation"):
        raise AssertionError(f"{what} journal: missing {missing}, events "
                             f"{counts}")
    return counts


def _trace_counts(prof_dir: str) -> dict:
    """K1/K2 kernels, the host spans and the device's busy ms in the
    ``torch.profiler`` trace that ``--profile-dir`` wrote."""
    files = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"profile dir holds {files}")
    with open(os.path.join(prof_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device = [e for e in events if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in OBS_SPANS:
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    return {"file": files[0], "bytes": os.path.getsize(
        os.path.join(prof_dir, files[0])),
        "K1": sum(KERNEL_NAMES["K1"] in e["name"] for e in kernels),
        "K2": sum(KERNEL_NAMES["K2"] in e["name"] for e in kernels),
        "kernels": len(kernels),
        "busy_ms": sum(e.get("dur", 0.0) for e in device) / 1e3,
        "spans": spans}


def _count_syncs(fn) -> tuple:
    """``(fn(), synchronising calls it made)``: one warning per sync under
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message).lower() for w in caught)


def _obs_turns(init, root: str, seed: int) -> dict:
    """One trainer's ``OBS_TURN_ROUNDS`` rounds with a 40,000-row snapshot
    each, in this process, after a warm-up turn, in turns off, on,
    journal, journal, on, off: ``journal`` = a validated journal, a span
    tracer and the first chunk's ``program_cost``; ``on`` = the same and
    the exporter, ``/metrics`` scraped every 50 ms by a thread of this
    process while the rounds run (JAX's ``bench.py`` cadence).  The final
    states must be equal and the synchronising calls as many."""
    from fed_tgan_torch.obs import (
        TelemetryExporter,
        start_tracing,
        stop_tracing,
    )

    # a warm-up turn first: a process's first round makes synchronising
    # calls of its own (the allocator's, the libraries' set-up)
    turns = []
    for i, mode in enumerate((None, "off", "on", "journal", "journal", "on",
                              "off")):
        tr = FederatedTrainer(init, steps.TrainConfig(), seed=seed,
                              device="cuda")
        writer = SnapshotWriter(init.global_meta, init.encoders,
                                result_path_fn(os.path.join(root, f"t{i}"),
                                               "Intrusion"),
                                rows=SNAPSHOT_ROWS, seed=seed)
        scrapes: list = []
        stop = threading.Event()
        jpath = os.path.join(root, f"turn{i}.jsonl")
        with contextlib.ExitStack() as stack:
            if mode in ("on", "journal"):
                journal = RunJournal(jpath, validate=True)
                prev = set_journal(journal)
                stack.callback(journal.close)
                stack.callback(set_journal, prev)
                start_tracing()
                stack.callback(stop_tracing)
            if mode == "on":
                exp = stack.enter_context(TelemetryExporter(port=0))

                def scrape(url=exp.url):
                    while not stop.is_set():
                        scrapes.append(_get(url + "/metrics")[2])
                        time.sleep(0.05)

                scraper = threading.Thread(target=scrape, daemon=True)
                scraper.start()
                stack.callback(scraper.join, 10)
                stack.callback(stop.set)
            with writer:
                t0 = time.perf_counter()
                _, syncs = _count_syncs(
                    lambda: tr.fit(OBS_TURN_ROUNDS, sample_hook=writer))
                wall = time.perf_counter() - t0
            health = None
            if mode == "on":
                health = json.loads(_get(exp.url + "/healthz")[0])
        if mode is None:
            continue
        turns.append({"mode": mode, "wall_s": wall, "syncs": syncs,
                      "s_per_round": list(tr.epoch_times),
                      "scrapes": scrapes, "health": health,
                      "state": _stack_state(tr),
                      "journal_bytes": (os.path.getsize(jpath)
                                        if mode != "off" else None)})
    for t in turns[1:]:
        _require_equal("observatory on vs off, final state", t["state"],
                       turns[0]["state"])
    if len({t["syncs"] for t in turns}) != 1:
        raise AssertionError("synchronising calls differ with the "
                             f"observatory: {[t['syncs'] for t in turns]}")
    for t in turns:
        if t["mode"] == "on" and (
                t["health"]["status"] != "training"
                or t["health"]["live_clients"] != FED_CLIENTS):
            raise AssertionError(f"/healthz after the rounds {t['health']}")

    def steady(mode):  # rounds 1.. (a journaled turn's round 0 is costed)
        return statistics.mean(x for t in turns if t["mode"] == mode
                               for x in t["s_per_round"][1:])

    lat = sorted(x for t in turns for x in t["scrapes"])
    off, on, jonly = steady("off"), steady("on"), steady("journal")
    return {"turns": [{k: v for k, v in t.items()
                       if k not in ("state", "scrapes")} for t in turns],
            "s_per_round_off": off, "s_per_round_on": on,
            "s_per_round_journal": jonly,
            "overhead_frac": on / off - 1.0,
            "overhead_frac_journal": jonly / off - 1.0,
            "costed_round_s": [t["s_per_round"][0] for t in turns
                               if t["mode"] != "off"],
            "scrapes": len(lat),
            "scrape_p50_ms": lat[len(lat) // 2] if lat else None,
            "scrape_p99_ms": (lat[min(len(lat) - 1, int(0.99 * len(lat)))]
                              if lat else None),
            "syncs": turns[0]["syncs"]}


def observatory_phase(root: str, seed: int, card: str) -> dict:
    """Slice 13's path: the federated round of phase 9 journaled, exported
    live, costed and device-traced (see the module docstring)."""
    csv_path = write_intrusion_csv(os.path.join(root, "obs.csv"), FED_ROWS,
                                   seed)
    run = _obs_cli(root, csv_path, seed)
    events = list(read_journal(run["journal"]))
    by_type: dict = {}
    for e in events:
        by_type.setdefault(e["type"], []).append(e)
    live = run["live"]
    want_series = [f'fed_tgan_client_weight{{client="{i}"}}'
                   for i in range(FED_CLIENTS)]
    if (live.get("health", {}).get("status") != "training"
            or live.get("client_weight_series") != want_series
            or not live.get("journal_lines")
            or live.get("x_journal_offset") is None):
        raise AssertionError(f"live exporter during the run: {live}")
    if by_type.get("schema_violation"):
        raise AssertionError(f"schema violations {by_type['schema_violation']}")
    printed = ast.literal_eval(run["stdout"].split(
        "aggregation weights: ", 1)[1].splitlines()[0])
    contribs = by_type.get("client_contribution", [])
    if [e["round"] for e in contribs] != list(range(OBS_ROUNDS)):
        raise AssertionError(f"client_contribution rounds "
                             f"{[e['round'] for e in contribs]}")
    for e in contribs:
        w = e["weights"]
        if (e["clients"] != list(range(FED_CLIENTS))
                or abs(sum(w) - 1.0) > 1e-6
                or any(abs(a - b) > 5.1e-5 for a, b in zip(w, printed))):
            raise AssertionError(f"contribution {e} vs printed {printed}")
    counts = {k: len(by_type.get(k, [])) for k in (
        "round", "similarity", "checkpoint", "device_trace", "program_cost")}
    traces = by_type.get("device_trace", [])
    costs = by_type.get("program_cost", [])
    if (counts["round"] != OBS_ROUNDS or counts["similarity"] != OBS_ROUNDS
            or counts["checkpoint"] != OBS_ROUNDS or len(traces) != 1
            or not traces[0]["ok"] or not costs
            or not all(c["flops"] > 0 and c["bytes_accessed"] > 0
                       for c in costs)):
        raise AssertionError(f"journal counts {counts}, traces {traces}, "
                             f"costs {costs}")
    tools = {}
    for cmd in ("report", "slo", "watch"):
        rc, text, err = _obs_tool(cmd, run["journal"])
        tools[cmd] = rc
        text += err
        if rc != 0:
            raise AssertionError(f"obs {cmd} exited {rc}: {text[-2000:]}")
        if cmd == "report" and (f"clients: {FED_CLIENTS} tracked over "
                                f"{OBS_ROUNDS} round(s)") not in text:
            raise AssertionError(f"obs report: {text[-2000:]}")
    trace = _trace_counts(run["prof"])
    # the traced round: max(steps) = 10 steps, K1 twice a step and once
    # for the snapshot's one chunk, K2 once a step; the similarity
    # monitor's probe is one more K1 launch
    steps_per_round = (FED_ROWS // FED_CLIENTS) // steps.TrainConfig(
    ).batch_size
    want = {"K1": 2 * steps_per_round + 1, "K2": steps_per_round}
    if (trace["K1"] != want["K1"] + 1 or trace["K2"] != want["K2"]
            or set(trace["spans"]) != set(OBS_SPANS)):
        raise AssertionError(f"device trace {trace}, want {want} + 1 K1 "
                             "monitor probe")
    attribution = trace_attribution_check(run["prof"], trace, card)
    init = _fed_init(csv_path, FED_CLIENTS, seed, "cuda")
    turns = _obs_turns(init, root, seed)
    jbytes = os.path.getsize(run["journal"])
    out = {
        "cli_wall_s": run["wall_s"], "live": live,
        "journal_events": {k: len(v) for k, v in sorted(by_type.items())},
        "journal_bytes": jbytes,
        "journal_bytes_per_round": jbytes / OBS_ROUNDS,
        "program_cost": [{k: c[k] for k in ("name", "flops",
                                            "bytes_accessed", "peak_bytes")}
                         for c in costs],
        "contribution_weights": contribs[-1]["weights"],
        "trace": {**trace, "want": want, "monitor_probe_K1": 1},
        "attribution": attribution, "tools": tools, **turns}
    print(f"observatory: CLI with --journal --obs-port 0 --profile-dir "
          f"--profile-rounds 1, {OBS_ROUNDS} rounds: exit 0 in "
          f"{run['wall_s']!r} s; live /healthz training, "
          f"{len(live['client_weight_series'])} client weight series, "
          f"/journal {live['journal_lines']} lines (X-Journal-Offset "
          f"{live['x_journal_offset']}); journal {out['journal_events']}, "
          f"0 schema violations, {jbytes} bytes; program_cost "
          f"{out['program_cost']}; traced round: K1 {trace['K1']} (want "
          f"{want['K1']} + 1 monitor probe), K2 {trace['K2']}, busy "
          f"{trace['busy_ms']!r} ms, spans {trace['spans']}  [{card}]",
          flush=True)
    print(f"observatory: in-process turns off/on/journal/journal/on/off "
          f"bit-equal, {turns['syncs']} synchronising calls each; s/round "
          f"off {turns['s_per_round_off']!r}, journal "
          f"{turns['s_per_round_journal']!r} (overhead "
          f"{turns['overhead_frac_journal']!r}), on "
          f"{turns['s_per_round_on']!r} (overhead "
          f"{turns['overhead_frac']!r}); a costed first round "
          f"{turns['costed_round_s']!r} s; /metrics scrape p50 "
          f"{turns['scrape_p50_ms']!r} p99 {turns['scrape_p99_ms']!r} ms "
          f"over {turns['scrapes']} scrapes  [{card}]", flush=True)
    return out


# the tooling phase: the federated round's CLI runs (plain, --sanitize,
# --sanitize-nans) of TOOL_ROUNDS rounds each, and the fault run's one
TOOL_ROUNDS = 3
# the doctor's checks on the card, every one OK
DOCTOR_CHECKS = 25
# the doctor's checks that phase 24 reads (slice 17's analysis checks)
ANALYSIS_CHECKS = ("static-analysis", "program-contracts", "analysis-all",
                   "backend-seam")
# the gradient-flow summary: atol + rtol per layer, card against CPU
GRADFLOW_ATOL, GRADFLOW_RTOL = 1e-6, 1e-3
_SYNC_LINE = re.compile(r"^\s+(\S+) entry (\d+)(?: \(warm-up, unguarded\))?: "
                        r"(\d+) unsanctioned, (\d+) sanctioned \((.*)\)$")
_ROUND_LINE = re.compile(r"^round (\d+): .*\(([\d.]+)s/round\)$")


def _tool_cli(argv: list, timeout: int = 600) -> dict:
    """The training CLI as a process of its own (a sanitized one must set
    up cuBLAS before its first CUDA call), through a wrapper that prints
    its K1/K2 launch counts last: exit code, stdout, stderr, wall seconds,
    launches (None when it raised) and its per-round seconds."""
    code = ("import json, sys\n"
            "from fed_tgan_torch import cli\n"
            "from fed_tgan_torch.ops import activate_cuda as k\n"
            f"rc = cli.main({argv!r})\n"
            "print(json.dumps({'launches': {"
            "'K1': k.fused_apply_activate.launches, "
            "'K2': k.fused_activate_bwd.launches}}))\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    launches = None
    if lines and lines[-1].startswith('{"launches"'):
        launches = json.loads(lines.pop())["launches"]
    rounds = [float(m.group(2)) for m in map(_ROUND_LINE.match, lines) if m]
    return {"rc": proc.returncode, "stdout": "\n".join(lines),
            "stderr": proc.stderr, "wall_s": wall, "launches": launches,
            "s_per_round": rounds}


def _sync_entries(report: str) -> list:
    """The ``(region, entry, unsanctioned, sanctioned, sites)`` lines of a
    sanitize report."""
    return [(m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4)),
             m.group(5)) for m in map(_SYNC_LINE.match, report.splitlines())
            if m]


def _require_clean_report(what: str, out: str) -> dict:
    """A sanitize report with no budget violation and no unsanctioned sync
    after a region's warm-up entry; returns its build count, the steady
    entries and the syncs outside the regions."""
    if "SANITIZE:" in out or "sanitize: " not in out:
        raise AssertionError(f"{what}: report {out[-3000:]}")
    entries = _sync_entries(out)
    bad = [e for e in entries if e[1] > 1 and e[2]]
    if bad or not any(e[1] > 1 for e in entries):
        raise AssertionError(f"{what}: unsanctioned steady syncs {bad} in "
                             f"{entries}")
    builds = re.search(r"sanitize: (\d+) build event", out)
    return {"builds": int(builds.group(1)) if builds else 0,
            "steady_entries": [e for e in entries if e[1] > 1],
            "outside": [ln.strip() for ln in out.splitlines()
                        if "outside the hot regions" in ln]}


def _same_snapshots(what: str, a: str, b: str) -> int:
    """Two runs wrote the same snapshot files, byte for byte; returns how
    many."""
    da, db = (os.path.join(x, "Intrusion_result") for x in (a, b))
    names = sorted(os.listdir(da))
    if names != sorted(os.listdir(db)) or not names:
        raise AssertionError(f"{what}: snapshots {names} vs "
                             f"{sorted(os.listdir(db))}")
    for n in names:
        with open(os.path.join(da, n), "rb") as f, \
                open(os.path.join(db, n), "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"{what}: {n} differs")
    return len(names)


def _same_generator(what: str, a: str, b: str) -> None:
    ga, gb = _artifact_generator(a), _artifact_generator(b)
    if ga.keys() != gb.keys() or not all(
            torch.equal(torch.from_numpy(ga[k]), torch.from_numpy(gb[k]))
            for k in ga):
        raise AssertionError(f"{what}: final generators differ")


class _Server:
    """``python -m fed_tgan_torch ARGV`` serving in a process of its own:
    its URL from its first line; :meth:`stop` interrupts it (a drain, then
    its report) and returns exit code and output."""

    def __init__(self, argv: list):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "fed_tgan_torch", *argv], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.lines: list = []
        self.err: list = []
        self._readers = [
            threading.Thread(target=lambda: self.lines.extend(
                ln.rstrip("\n") for ln in self.proc.stdout), daemon=True),
            threading.Thread(target=lambda: self.err.append(
                self.proc.stderr.read()), daemon=True)]
        for t in self._readers:
            t.start()
        deadline = time.time() + 300
        self.url = None
        while self.url is None:
            if self.proc.poll() is not None or time.time() > deadline:
                self.stop()
                raise AssertionError(f"server {argv} did not start: "
                                     f"{self.output()[-3000:]}")
            for ln in list(self.lines):
                m = re.search(r"on (http://[\d.]+:\d+)", ln)
                if m:
                    self.url = m.group(1)
            time.sleep(0.05)

    def output(self) -> str:
        return "\n".join(self.lines) + "\n" + "".join(self.err)

    def stop(self, timeout: float = 120) -> tuple:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        for t in self._readers:
            t.join(timeout=30)
        return rc, self.output()


def _encoded_rows(spec: SegmentSpec, n: int, seed: int) -> np.ndarray:
    """A random encoded matrix of ``spec``'s layout: tanh dims in
    (-0.99, 0.99), one-hot softmax segments."""
    rng = np.random.default_rng(seed)
    parts = []
    for size, kind in spec.output_info:
        if kind == "tanh":
            parts.append(rng.uniform(-0.99, 0.99, (n, 1)))
        else:
            oh = np.zeros((n, size))
            oh[np.arange(n), rng.integers(0, size, n)] = 1.0
            parts.append(oh)
    return np.concatenate(parts, axis=1).astype(np.float32)


def gradflow_check(spec: SegmentSpec, seed: int, card: str) -> dict:
    """``ops/diagnostics.py::gradient_flow`` at full width (TrainConfig()
    defaults) on the card against the CPU, from the same weights and the
    same draws; the launches it made on the card."""
    import copy

    from fed_tgan_torch.ops.diagnostics import gradient_flow

    cfg = steps.TrainConfig()
    data = _encoded_rows(spec, 4 * cfg.batch_size, seed)
    cpu_models = steps.init_models(spec, cfg, seed=seed, device="cpu")
    draws = steps.draw_step(torch.Generator().manual_seed(seed), cpu_models)
    card_models = steps.Models.build(
        copy.deepcopy(cpu_models.generator).to("cuda"),
        copy.deepcopy(cpu_models.discriminator).to("cuda"), spec, cfg)
    want = gradient_flow(cpu_models, torch.from_numpy(data),
                         CondSampler.from_data(data, spec, "cpu"),
                         RowSampler.from_data(data, spec, "cpu"), draws)
    activate_cuda.reset_launches()
    got = gradient_flow(card_models, torch.from_numpy(data).cuda(),
                        CondSampler.from_data(data, spec, "cuda"),
                        RowSampler.from_data(data, spec, "cuda"),
                        draws.to("cuda"))
    launches = {"K1": fused_apply_activate.launches,
                "K2": fused_activate_bwd.launches}
    worst = 0.0
    for net in want:
        for name, ref in want[net].items():
            for stat in ("avg_abs", "max_abs"):
                d = abs(got[net][name][stat] - ref[stat])
                if d > GRADFLOW_ATOL + GRADFLOW_RTOL * abs(ref[stat]):
                    raise AssertionError(f"gradient flow {net} {name} {stat}"
                                         f": card {got[net][name][stat]} vs "
                                         f"CPU {ref[stat]}")
                worst = max(worst, d / (GRADFLOW_ATOL
                                        + GRADFLOW_RTOL * abs(ref[stat])))
    if launches != {"K1": 2, "K2": 1}:
        raise AssertionError(f"gradient flow launched {launches}, want K1 2 "
                             "(D fake batch, G step) and K2 1")
    layers = sum(len(v) for v in want.values())
    print(f"tooling: gradient flow at (500, {spec.dim}), card vs CPU on the "
          f"same weights and draws: {layers} layers within atol "
          f"{GRADFLOW_ATOL} + rtol {GRADFLOW_RTOL} (worst {worst!r} of the "
          f"tolerance); K1 {launches['K1']}, K2 {launches['K2']} launches  "
          f"[{card}]", flush=True)
    return {"layers": layers, "worst_of_tolerance": worst,
            "launches": launches}


def guard_check(spec: SegmentSpec, card: str) -> dict:
    """The sync guard and the NaN guard in this process (no determinism
    guard: cuBLAS is long set up here): a deliberate ``.item()`` in a
    steady region raises naming it while another thread's syncs do not,
    and a NaN logit fed to K1 raises naming K1."""
    from fed_tgan_torch.analysis import sanitizers

    x = torch.ones(1000, device="cuda")
    other_errors: list = []

    def other():
        try:
            for _ in range(50):
                x.sum().item()
        except Exception as exc:  # noqa: BLE001 -- fatal below
            other_errors.append(repr(exc))

    raised = None
    with sanitizers.sanitize(deterministic=False):
        with sanitizers.hot_region("tooling.guard"):
            x.sum().item()  # the warm-up entry
        try:
            with sanitizers.hot_region("tooling.guard"):
                x.sum().item()
        except sanitizers.SyncGuardError as exc:
            raised = str(exc)
        with sanitizers.hot_region("tooling.guard"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
        census = sanitizers.sync_census()
    if raised is None or "tooling.guard" not in raised \
            or "chip_smoke.py" not in raised or other_errors:
        raise AssertionError(f"sync guard: raised {raised!r}, other thread "
                             f"{other_errors}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    logits = torch.randn((500, spec.dim), generator=gen, device="cuda")
    u = torch.rand((500, spec.dim), generator=gen, device="cuda")
    logits[7, 3] = float("nan")
    nan_error = backward_error = None
    with sanitizers.sanitize(nan_debug=True, deterministic=False):
        try:
            fused_apply_activate(logits, spec, u)
        except FloatingPointError as exc:
            nan_error = str(exc)
        # a NaN only the backward makes (0 * d log(x) at 0), on the
        # autograd engine's device thread
        xg = torch.zeros(8, device="cuda", requires_grad=True)
        loss = torch.where(xg > 0, torch.log(xg), torch.zeros_like(xg)).sum()
        try:
            loss.backward()
        except FloatingPointError as exc:
            backward_error = str(exc)
    if nan_error is None or "K1" not in nan_error:
        raise AssertionError(f"the NaN guard on K1: {nan_error!r}")
    if backward_error is None or "aten." not in backward_error:
        raise AssertionError(f"the NaN guard in the backward: "
                             f"{backward_error!r}")
    other_syncs = sum(c["count"] for c in census if c["region"] is None)
    print(f"tooling: sync guard in this process: {raised!r}; another "
          f"thread's {other_syncs} syncs meanwhile raised nothing; a NaN "
          f"logit fed to K1: {nan_error!r}; a NaN of the backward: "
          f"{backward_error!r}  [{card}]", flush=True)
    return {"sync_guard": raised, "other_thread_syncs": other_syncs,
            "nan_guard_k1": nan_error, "nan_guard_backward": backward_error}


def _serve_sanitized(art: str, seed: int, rows: int, card: str) -> dict:
    """``serve --sanitize`` answers ``rows``-row requests and requests of
    2,000 rows (another chunk size) with the bytes of an unsanitized
    engine; its report after the drain holds the serving budget and no
    unsanctioned sync after the warm-up."""
    want_engine = SamplingEngine(open_model(art, device="cuda"))
    server = _Server(["serve", art, "--sanitize", "--port", "0",
                      "--workers", "2", "--reload-interval", "0"])
    try:
        seeds = [(seed + 11 + i, n) for i in range(4) for n in (rows, 2000)]
        t0 = time.perf_counter()
        for s, n in seeds:
            body = urllib.request.urlopen(
                f"{server.url}/sample?rows={n}&seed={s}", timeout=120).read()
            if body != want_engine.sample_csv_bytes(n, seed=s):
                raise AssertionError(f"serve --sanitize: {n} rows of seed "
                                     f"{s} differ from an unsanitized engine")
        wall = time.perf_counter() - t0
    finally:
        rc, out = server.stop()
    if rc != 0:
        raise AssertionError(f"serve --sanitize exited {rc}: {out[-3000:]}")
    report = _require_clean_report("serve --sanitize", out)
    sizes = sorted({e[0] for e in report["steady_entries"]})
    if len(sizes) < 2:
        raise AssertionError(f"serve --sanitize: chunk regions {sizes}")
    print(f"tooling: serve --sanitize answered {len(seeds)} requests of "
          f"{rows} and 2000 rows over chunk regions {sizes}, bytes equal to an "
          f"unsanitized engine, {report['builds']} builds, no unsanctioned "
          f"sync after the warm-up (steady entries "
          f"{report['steady_entries']}), exit 0  [{card}]", flush=True)
    return {"requests": len(seeds), "rows": rows, "wall_s": wall,
            **report}


def _fleet_lockwatch(seed: int, rows: int, card: str, root: str) -> dict:
    """``fleet --sanitize --lockwatch`` over the fleet phase's 4 tenants,
    16 clients x 4 requests of ``rows`` rows: every body its tenant's
    single engine's; after the drain no lock-order cycle, no re-entry,
    the fleet budget, each lock's hold p99."""
    arts = {name: build_random_artifact(os.path.join(root, name),
                                        seed=seed + s, table=table)
            for name, table, s in FLEET_TENANTS}
    names = [name for name, _, _ in FLEET_TENANTS]
    mix = [[(names[(c + k) % len(names)], rows,
             2000 + c * FLEET_REQUESTS + k)
            for k in range(FLEET_REQUESTS)] for c in range(FLEET_CLIENTS)]
    singles = {name: SamplingEngine(open_model(art, device="cuda"))
               for name, art in arts.items()}
    want = {(t, n, s): singles[t].sample_csv_bytes(n, seed=s)
            for reqs in mix for t, n, s in reqs}
    server = _Server(["fleet", *(f"{n}={a}" for n, a in arts.items()),
                      "--sanitize", "--lockwatch", "--port", "0",
                      "--workers", "2", "--coalesce-window", "0.005",
                      "--reload-interval", "0"])
    try:
        base = urllib.parse.urlsplit(server.url)
        run = _load(FLEET_CLIENTS, mix,
                    lambda t: (base.hostname, base.port, f"/t/{t}/sample"))
        _check_bodies(run, mix, want)
    finally:
        rc, out = server.stop()
    if rc != 0 or "LOCKWATCH:" in out:
        raise AssertionError(f"fleet --sanitize --lockwatch exited {rc}: "
                             f"{out[-3000:]}")
    report = _require_clean_report("fleet --sanitize", out)
    locks = {}
    for m in re.finditer(r"lockwatch: (\S+): (\d+) acq \((\d+) contended\)"
                         r", hold p99 ([\d.]+) ms", out):
        locks[m.group(1)] = {"acquisitions": int(m.group(2)),
                             "contentions": int(m.group(3)),
                             "hold_p99_ms": float(m.group(4))}
    if "fleet_adm" not in locks:
        raise AssertionError(f"lockwatch summary {locks}")
    stats = _load_stats(run, rows)
    print(f"tooling: fleet --sanitize --lockwatch, {FLEET_CLIENTS} clients "
          f"x {FLEET_REQUESTS} {rows}-row requests over {len(names)} "
          f"tenants: every body its tenant's single engine's, no cycle, no "
          f"re-entry, fleet budget held ({report['builds']} builds); "
          f"{stats['rows_per_s']!r} rows/s, p99 {stats['p99_ms']!r} ms; "
          f"hold p99 by lock " + ", ".join(
              f"{k} {v['hold_p99_ms']!r} ms ({v['acquisitions']} acq, "
              f"{v['contentions']} contended)" for k, v in sorted(
                  locks.items())) + f"  [{card}]", flush=True)
    return {"load": stats, "locks": locks, **report}


def tooling_phase(root: str, seed: int, card: str, rows: int) -> dict:
    """Slice 14's path (see the module docstring, phase 20)."""
    t_phase = time.perf_counter()
    csv_path = write_intrusion_csv(os.path.join(root, "tool.csv"), FED_ROWS,
                                   seed)
    runs = {}

    def argv(tag, *extra, epochs=TOOL_ROUNDS):
        # the plain run fills the init cache, the others restore it (a
        # warm init is the cold one, bit for bit)
        return ["--mode", "fedavg", "--datapath", csv_path, "--dataset",
                "intrusion", "--n-clients", str(FED_CLIENTS), "-epochs",
                str(epochs), "--sample-rows", str(SNAPSHOT_ROWS),
                "--save-model", "--out-dir", os.path.join(root, tag),
                "--seed", str(seed), "--init-cache",
                os.path.join(root, "init_cache"), *extra]

    # the timed runs, one after another: plain, sanitized, NaN-guarded
    for tag, extra in (("plain", ()), ("sanitize", ("--sanitize",)),
                       ("nans", ("--sanitize-nans",))):
        runs[tag] = _tool_cli(argv(tag, *extra))
        if runs[tag]["rc"] != 0:
            raise AssertionError(f"CLI {tag} exited {runs[tag]['rc']}: "
                                 f"{runs[tag]['stderr'][-3000:]}")
    # untimed, beside the rest: the fault run, the doctor and the ledger
    side = {name: subprocess.Popen(
        [sys.executable, "-m", *cmd], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, cmd in (("doctor", ["fed_tgan_torch.doctor"]),
                          ("ledger", ["fed_tgan_torch.obs", "ledger",
                                      "--json"]))}
    side_t0 = time.perf_counter()
    fault_box: dict = {}
    fault_thread = threading.Thread(target=lambda: fault_box.update(
        _tool_cli(argv("fault", "--sanitize-nans", "--faults",
                       "nan_update:rank=1,round=1", epochs=1))))
    fault_thread.start()
    try:
        steps_per_round = (FED_ROWS // FED_CLIENTS) // steps.TrainConfig(
        ).batch_size
        want = {"K1": TOOL_ROUNDS * (2 * steps_per_round + 1),
                "K2": TOOL_ROUNDS * steps_per_round}
        for tag in ("plain", "sanitize", "nans"):
            if runs[tag]["launches"] != want:
                raise AssertionError(f"{tag}: launches "
                                     f"{runs[tag]['launches']}, want {want}")
        san = _require_clean_report("--sanitize", runs["sanitize"]["stdout"])
        rounds = [e for e in san["steady_entries"]
                  if e[0].startswith("train.chunk")]
        if [e[1] for e in rounds] != list(range(2, TOOL_ROUNDS + 1)):
            raise AssertionError(f"steady round entries {rounds}")
        _require_clean_report("--sanitize-nans", runs["nans"]["stdout"])
        out_of = lambda tag: os.path.join(root, tag)  # noqa: E731
        snaps = _same_snapshots("--sanitize vs plain", out_of("plain"),
                                out_of("sanitize"))
        _same_snapshots("--sanitize-nans vs plain", out_of("plain"),
                        out_of("nans"))
        _same_generator("--sanitize vs plain", out_of("plain"),
                        out_of("sanitize"))
        _same_generator("--sanitize-nans vs plain", out_of("plain"),
                        out_of("nans"))
        steady = lambda tag: runs[tag]["s_per_round"][1:]  # noqa: E731
        for tag in ("plain", "sanitize", "nans"):
            print(f"tooling: CLI {tag}: {TOOL_ROUNDS} rounds, exit 0 in "
                  f"{runs[tag]['wall_s']!r} s, K1 {runs[tag]['launches']['K1']}"
                  f" K2 {runs[tag]['launches']['K2']} launches (want {want}), "
                  f"s/round {runs[tag]['s_per_round']!r}  [{card}]",
                  flush=True)
        print(f"tooling: --sanitize: {san['builds']} builds, the training "
              f"budget held; steady rounds' syncs " + "; ".join(
                  f"{r[0]} entry {r[1]}: {r[2]} unsanctioned, {r[3]} "
                  f"sanctioned ({r[4]})" for r in rounds)
              + f"; outside the regions {san['outside']}; {snaps} snapshots"
              f" and the final generator torch.equal to the plain run's, "
              f"and so --sanitize-nans's  [{card}]", flush=True)
        spec = SegmentSpec.from_output_info(output_info(intrusion_layout(
            np.random.default_rng(seed))[2]))
        guards = guard_check(spec, card)
        gradflow = gradflow_check(spec, seed, card)
        art = build_random_artifact(os.path.join(root, "art"), seed=seed)
        serving = _serve_sanitized(art, seed, rows, card)
        fleet = _fleet_lockwatch(seed, rows, card, os.path.join(root, "fl"))
    finally:
        fault_thread.join(timeout=600)
        side_out = {}
        for name, proc in side.items():
            try:
                out, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            side_out[name] = (proc.returncode, out, err)
    side_wall = time.perf_counter() - side_t0
    m = re.search(r"FloatingPointError: (NaN in the output of \S+ at \S+)",
                  fault_box.get("stderr", ""))
    if fault_box.get("rc") in (0, None) or m is None:
        raise AssertionError(f"nan_update under --sanitize-nans: rc "
                             f"{fault_box.get('rc')}, "
                             f"{fault_box.get('stderr', '')[-2000:]}")
    print(f"tooling: a nan_update fault under --sanitize-nans: exit "
          f"{fault_box['rc']}, {m.group(1)!r}  [{card}]", flush=True)
    rc, out, err = side_out["doctor"]
    checks = re.findall(r"^(OK  |FAIL) (\S+):", out, re.MULTILINE)
    if (rc != 0 or len(checks) != DOCTOR_CHECKS
            or any(k != "OK  " for k, _ in checks)):
        raise AssertionError(f"doctor exited {rc}: {(out + err)[-3000:]}")
    doctor_s = float(re.search(r"checks passed in ([\d.]+) s", out).group(1))
    analysis_lines = [ln for ln in out.splitlines() if re.match(
        r"(OK  |FAIL) (%s):" % "|".join(ANALYSIS_CHECKS), ln)]
    print(f"tooling: python -m fed_tgan_torch.doctor: {len(checks)}/"
          f"{len(checks)} checks OK, exit 0, {doctor_s!r} s of checks (beside "
          f"the phase's other runs; all side runs done {side_wall!r} s after "
          f"their start)  [{card}]", flush=True)
    rc, out, err = side_out["ledger"]
    if rc != 0:
        raise AssertionError(f"obs ledger exited {rc}: {err[-3000:]}")
    ledger = json.loads(out)
    hollow = [n for n, e in ledger.items()
              if not (e["flops"] > 0 and e["peak_bytes"] > 0)]
    if hollow or len({e["family"] for e in ledger.values()}) != 4:
        raise AssertionError(f"obs ledger: {ledger}")
    print("tooling: obs ledger --json on the card: " + ", ".join(
        f"{n} {e['flops']!r} flops, {e['bytes_accessed']!r} bytes, peak "
        f"{e['peak_bytes']}" for n, e in sorted(ledger.items()))
        + f"  [{card}]", flush=True)
    mode = torch.cuda.get_sync_debug_mode()
    if mode != 0 or torch.are_deterministic_algorithms_enabled():
        raise AssertionError(f"the process left with sync debug mode {mode}"
                             ", deterministic algorithms "
                             f"{torch.are_deterministic_algorithms_enabled()}")
    phase_s = time.perf_counter() - t_phase
    plain_s, san_s, nan_s = (statistics.mean(steady(t))
                             for t in ("plain", "sanitize", "nans"))
    print(f"tooling: steady s/round plain {plain_s!r}, --sanitize {san_s!r} "
          f"({san_s / plain_s - 1.0!r}), --sanitize-nans {nan_s!r} "
          f"({nan_s / plain_s - 1.0!r}); the phase {phase_s!r} s; sync "
          f"debug mode 0 and deterministic algorithms off after it  "
          f"[{card}]", flush=True)
    return {"runs": {t: {k: v for k, v in r.items()
                         if k not in ("stdout", "stderr")}
                     for t, r in runs.items()},
            "launches_want": want, "sanitize": san, "snapshots_equal": snaps,
            "nan_fault": m.group(1), "guards": guards, "gradflow": gradflow,
            "serving": serving, "fleet": fleet,
            "doctor": {"checks": len(checks), "checks_s": doctor_s,
                       "side_wall_s": side_wall,
                       "analysis_lines": analysis_lines},
            "round_spec": open_model(os.path.join(root, "sanitize"),
                                     device="cpu").synth.spec,
            "gradflow_spec": spec,
            "ledger": ledger, "steady_s_per_round": {
                "plain": plain_s, "sanitize": san_s, "nans": nan_s},
            "phase_s": phase_s}


def _tooling_with_checks(build_root: str, seed: int, card: str,
                         rows: int):
    """The tooling phase, then K1 and K2 against their plain versions at
    its shapes: the sanitized round's stacked step and the
    gradient-flow summary's batch."""
    root = tempfile.mkdtemp(prefix="chip_smoke_tool_", dir=build_root)
    try:
        tooling = tooling_phase(root, seed, card, rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    B = steps.TrainConfig().batch_size
    shapes, bwd = [], []
    for spec, sizes in ((tooling.pop("round_spec"),
                         (("tool_round", FED_CLIENTS * B),)),
                        (tooling.pop("gradflow_spec"),
                         (("tool_gradflow", B),))):
        shapes += check_kernel(spec, card, sizes, extra=False)
        bwd += check_bwd_kernel(spec, card, sizes, extra=False)
    return tooling, shapes, bwd


def _tooling_kernels(tooling: dict, shapes: list, bwd: list) -> list:
    """The kernels' entries of the tooling paths: the sanitized round's
    launches (counted in its own process) and the gradient-flow
    summary's."""
    fwd, bwd_ref = ("fed_tgan_tpu/ops/activate_pallas.py:81",
                    "fed_tgan_tpu/ops/activate_pallas.py:102")
    out = []
    for name, kernel, replaces, results, case, launches, path in (
            ("fused_gumbel_activation_fwd_sanitized", "K1", fwd, shapes,
             "tool_round", tooling["runs"]["sanitize"]["launches"]["K1"],
             "federated --sanitize"),
            ("fused_gumbel_activation_bwd_sanitized", "K2", bwd_ref, bwd,
             "tool_round", tooling["runs"]["sanitize"]["launches"]["K2"],
             "federated --sanitize"),
            ("fused_gumbel_activation_fwd_gradflow", "K1", fwd, shapes,
             "tool_gradflow", tooling["gradflow"]["launches"]["K1"],
             "gradient flow"),
            ("fused_gumbel_activation_bwd_gradflow", "K2", bwd_ref, bwd,
             "tool_gradflow", tooling["gradflow"]["launches"]["K2"],
             "gradient flow")):
        main = next(r for r in results if r["case"] == case)
        out.append({
            "name": name, "route": "cuda",
            "source": "fed_tgan_torch/csrc/activate.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "device_ms": main["device_ms"], "host_us": main["host_us"],
            "plan": main["plan"], "library_ms": None, "path": path,
            "shape": main["shape"], "shapes": results})
    return out


# ------------------------------------------------------ the run-level tools
# slice 15: the backend probe, the pod launcher, the soaks and trace
# attribution (scripts/torch_launch_pod.py, scripts/torch_soak.py,
# scripts/torch_trace_attribution.py)

def _script(name: str):
    """``scripts/<name>.py`` as a module (scripts/ is not a package)."""
    import importlib.util

    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def backend_phase(card: str, build_root: str) -> dict:
    """The backend probe on the card: a fresh probe (its stamp ignored)
    answers with this card's count, name, compute capability and power
    limit (``gpu_line()``'s) and, for 4 participants, ``choose_backend``'s
    process group (gloo on one card); a second probe is the cached stamp;
    the fresh probe's ``backend_probe`` event passes the journal's
    validation; ``--backend tpu`` exits non-zero naming the flags;
    ``python -m fed_tgan_torch.doctor --wait-healthy --wait-timeout-min 2``
    exits 0.  The cold and cached probes in ms."""
    from fed_tgan_torch.parallel.multihost import choose_backend
    from fed_tgan_torch.runtime import backend as rb

    t_phase = time.perf_counter()
    jdir = tempfile.mkdtemp(prefix="chip_smoke_probe_", dir=build_root)
    journal = RunJournal(os.path.join(jdir, "journal.jsonl"),
                         run_id="backend-probe", validate=True)
    prev = set_journal(journal)
    try:
        t0 = time.perf_counter()
        fresh = rb.get_backend("gpu").probe(ignore_cache=True)
        cold_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        cached = rb.get_backend("gpu").probe()
        cached_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        set_journal(prev)
        journal.close()
    events = [e for e in read_journal(journal.path)]
    shutil.rmtree(jdir, ignore_errors=True)
    if not fresh.ok:
        raise AssertionError(f"backend probe failed: {fresh.reason}")
    info = fresh.info
    first = info["cards"][0]
    seen = f"{first['name']}, {first['power_limit']}"
    capability = "%d.%d" % torch.cuda.get_device_capability(0)
    if (info["count"] != torch.cuda.device_count() or seen != card
            or first["capability"] != capability):
        raise AssertionError(f"probe saw {info}, the card is {card!r} "
                             f"(sm {capability})")
    world4 = fresh.world(4)
    want_pg = choose_backend(4)
    if world4["process_group"] != want_pg or (
            info["count"] == 1 and want_pg != "gloo"):
        raise AssertionError(f"probe's world of 4 {world4}, choose_backend "
                             f"{want_pg}")
    if not (cached.ok and cached.cached and cached.info == info):
        raise AssertionError(f"second probe {cached}")
    probes = [e for e in events if e["type"] == "backend_probe"]
    if (journal.schema_violations or len(probes) != 1
            or not probes[0]["ok"] or probes[0].get("attempts") != 1):
        raise AssertionError(f"backend_probe events {events}")
    # the refusal and the waiter, side by side
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *cmd], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, cmd in (
            ("tpu", ["fed_tgan_torch", "--backend", "tpu", "--datapath",
                     "none.csv"]),
            ("wait", ["fed_tgan_torch.doctor", "--wait-healthy",
                      "--wait-timeout-min", "2"]))}
    res = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=180)
        res[name] = (p.returncode, stdout, stderr, time.perf_counter() - t0)
    rc, _, err, _ = res["tpu"]
    named = "--backend tpu: the port runs on a CUDA card or the CPU"
    if rc == 0 or named not in err:
        raise AssertionError(f"--backend tpu: rc {rc}, {err[-1000:]}")
    rc, stdout, err, wait_s = res["wait"]
    if rc != 0 or "CUDA backend healthy" not in stdout:
        raise AssertionError(f"doctor --wait-healthy: rc {rc}, "
                             f"{(stdout + err)[-1500:]}")
    out = {"cold_probe_ms": cold_ms, "cached_probe_ms": cached_ms,
           "cards": info["cards"], "nccl": info["nccl"], "world_of_4": world4,
           "backend_tpu_rc": res["tpu"][0], "wait_healthy_s": wait_s,
           "load_1min": os.getloadavg()[0],
           "wall_s": time.perf_counter() - t_phase}
    print(f"backend: a fresh probe {cold_ms!r} ms (torch.cuda.init() in a "
          f"fresh interpreter), the cached stamp {cached_ms!r} ms; "
          f"{info['count']} card(s): {seen} (sm {capability}); a world of 4 "
          f"participants {world4}; backend_probe journaled and valid; "
          f"--backend tpu exit {res['tpu'][0]}; doctor --wait-healthy exit "
          f"0 in {wait_s!r} s; phase {out['wall_s']!r} s  [{card}]",
          flush=True)
    return out


class StampWatch:
    """The backend probe's stamp, polled while the script runs: each new
    mtime is at least one cold probe by some process (a CLI process
    probes unless the stamp is fresher than 300 s; this process, with
    CUDA up, never does).  Probes that write the stamp within one poll of
    each other, as a pod's ranks starting together do, count once, so
    ``stop()`` returns a lower bound."""

    def __init__(self, period: float = 0.5):
        from fed_tgan_torch.runtime.backend import _probe_stamp_path

        self.path = _probe_stamp_path()
        self.writes = 0
        self._last = self._mtime()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(period,),
                                        daemon=True, name="stamp-watch")
        self._thread.start()

    def _mtime(self):
        try:
            return os.lstat(self.path).st_mtime
        except OSError:
            return None

    def _run(self, period: float) -> None:
        while not self._stop.wait(period):
            m = self._mtime()
            if m is not None and m != self._last:
                self.writes += 1
                self._last = m

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        return self.writes


POD_ROUNDS = 3
_LAUNCH_LINE = re.compile(r"K1 launches (\d+), K2 launches (\d+)")


def _pod_shards(root: str, seed: int) -> list:
    """The multi-process phase's data, written again: the federated
    round's CSV as 4 IID shard CSVs (the same bytes)."""
    table = read_csv(write_intrusion_csv(os.path.join(root, "pod.csv"),
                                         FED_ROWS, seed))
    shards = []
    for i, part in enumerate(shard_table(table, MP_CLIENTS, "iid",
                                         seed=seed)):
        shards.append(os.path.join(root, f"shard{i + 1}.csv"))
        write_csv(part, shards[-1])
    return shards


def _run_pod(root: str, tag: str, shards: list, seed: int, env=None,
             grace: float = 60.0, timeout: float = 420.0) -> dict:
    """``scripts/torch_launch_pod.py`` at full width on the shards, with
    the flags of the multi-process phase's straight world (the Intrusion
    preset, ``TrainConfig()`` widths, a 40,000-row snapshot a round):
    rank 0 and one participant per shard, each a process of its own on
    the card; returns its exit code, output, ``federation.json``, the
    ranks' logs and its wall."""
    out = os.path.join(root, tag)
    argv = [sys.executable, os.path.join(REPO, "scripts",
                                         "torch_launch_pod.py"),
            "--processes", str(len(shards) + 1), "--datapath", *shards,
            "--dataset", "intrusion", "--batch-size", "500",
            "--embedding-dim", "128", "--epochs", str(POD_ROUNDS),
            "--sample-every", "1", "--sample-rows", str(SNAPSHOT_ROWS),
            "--seed", str(seed), "--port", str(_free_ports()),
            "--out-dir", out, "--grace", str(grace),
            "--timeout", str(timeout - 30)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, **(env or {})},
                          timeout=timeout)
    wall = time.perf_counter() - t0
    fed_path = os.path.join(out, "federation.json")
    fed = None
    if os.path.exists(fed_path):
        with open(fed_path) as f:
            fed = json.load(f)
    logs = {}
    for r in range(len(shards) + 1):
        with open(os.path.join(out, f"rank{r}.log")) as f:
            logs[r] = f.read()
    return {"rc": proc.returncode, "stdout": proc.stdout,
            "stderr": proc.stderr, "federation": fed, "logs": logs,
            "wall_s": wall, "dir": out}


def pod_phase(root: str, seed: int, card: str, mp_world_s_per_round=None,
              world_generator=None) -> dict:
    """Slice 15's full-width path: ``scripts/torch_launch_pod.py
    --processes 5`` on the multi-process phase's 4 shards with its
    straight world's flags (20,000 rows, ``TrainConfig()`` widths: batch
    500, embedding 128; a 40,000-row snapshot a round), 3 rounds: every
    rank exits 0, every participant's generator ``torch.equal`` to the
    others' and to that world's (``world_generator``; without it a world
    of the same flags, started as phase 18 starts it, one world at a
    time), ``federation.json`` with 5 journals and 3 rounds, K1/K2
    launched in every participant (its own counters, printed at exit);
    then a departure pod (``kill_client:rank=2,round=2`` in the
    launcher's environment) returns 1, rank 0 names ``--resume``, and
    every rank ends within the grace period.  The pod's wall and rank 0's
    s/round beside the world's."""
    t_phase = time.perf_counter()
    shards = _pod_shards(root, seed)
    install_plan(None)
    pod = _run_pod(root, "pod", shards, seed)
    if pod["rc"] != 0:
        raise AssertionError(f"pod exited {pod['rc']}: "
                             f"{(pod['stdout'] + pod['stderr'])[-3000:]}")
    fed = pod["federation"]
    n = len(shards) + 1
    if (fed is None or len(fed["paths"]) != n
            or fed["rounds"]["total_rounds"] != POD_ROUNDS
            or fed["pod"]["exit_codes"] != {str(r): 0 for r in range(n)}):
        raise AssertionError(f"federation.json {fed and fed.get('pod')}, "
                             f"rounds {fed and fed.get('rounds')}")
    steps_per_round = (FED_ROWS // MP_CLIENTS) // steps.TrainConfig(
    ).batch_size
    launches = {}
    for r in range(1, n):
        m = _LAUNCH_LINE.search(pod["logs"][r])
        if m is None:
            raise AssertionError(f"pod rank {r}: {pod['logs'][r][-1500:]}")
        launches[r] = {"K1": int(m.group(1)), "K2": int(m.group(2))}
        # 2 K1 and 1 K2 a step; rank 1 also samples the snapshots' chunks
        if (launches[r]["K2"] != POD_ROUNDS * steps_per_round
                or launches[r]["K1"] < 2 * POD_ROUNDS * steps_per_round):
            raise AssertionError(f"pod rank {r} launches {launches[r]}")
    world = None
    if world_generator is None:
        world = _mp_world(root, "pod_world", shards, seed, POD_ROUNDS)
        _world_ok("pod's world", world)
        world_generator = _world_params(world, n - 1)[0]["generator"]
        mp_world_s_per_round = [_num(
            r"\(([\d.]+)s/round incl\. snapshots\)", world["out"][0])]
    for r in range(1, n):
        g = torch.load(os.path.join(pod["dir"], "params",
                                    f"params_rank{r}.pt"))["generator"]
        if sorted(g) != sorted(world_generator) or not all(
                torch.equal(g[k], world_generator[k])
                for k in world_generator):
            raise AssertionError(f"pod participant {r}'s generator differs "
                                 "from the world's")
    rank0 = {k: _num(pat, pod["logs"][0]) for k, pat in (
        ("s_per_round", r"rounds in [\d.]+s \(([\d.]+)s/round\)"),
        ("wall_s_per_round", r"\(([\d.]+)s/round incl\. snapshots\)"))}
    # the departure pod: rank 2 hard-exits at round 2, the survivors
    # abort on the heartbeats (10 s) and the collective's timeout
    grace = 60.0
    dep = _run_pod(root, "departure", shards, seed, grace=grace, env={
        "FED_TGAN_TORCH_FAULTS": "kill_client:rank=2,round=2",
        "FED_TGAN_TORCH_TRANSPORT_HEARTBEAT_TIMEOUT_MS": "10000",
        "FED_TGAN_TORCH_TRANSPORT_TRAIN_MS": "60000"})
    dfed = dep["federation"] or {}
    dpod = dfed.get("pod") or {}
    departed = dpod.get("departed") or {}
    if (dep["rc"] != 1 or departed.get("rank") != 2
            or departed.get("code") != 17
            or dpod["wall_s"] - departed["at_s"] > grace + 10
            or any(c == 0 for c in dpod["exit_codes"].values())
            or "relaunch with --resume" not in dep["logs"][0]):
        raise AssertionError(f"departure pod rc {dep['rc']}, {dpod}: "
                             f"{dep['stdout'][-2000:]}")
    out = {"processes": n, "rounds": POD_ROUNDS, "wall_s": pod["wall_s"],
           "pod_wall_s": fed["pod"]["wall_s"], "rank0": rank0,
           "launches": launches,
           "launches_total": {k: sum(v[k] for v in launches.values())
                              for k in ("K1", "K2")},
           "world": "phase 18's" if world is None else "this phase's",
           "world_wall_s": None if world is None else world["wall_s"],
           "world_rank0_wall_s_per_round": mp_world_s_per_round,
           "bit_equal_to_world": True,
           "departure": {"exit_codes": dpod["exit_codes"],
                         "departed_at_s": departed["at_s"],
                         "ended_s": dpod["wall_s"], "grace_s": grace,
                         "wall_s": dep["wall_s"]},
           "train_rows": steps.TrainConfig().batch_size,
           "wall_phase_s": time.perf_counter() - t_phase}
    print(f"pod: scripts/torch_launch_pod.py --processes {n} at full width, "
          f"{POD_ROUNDS} rounds: every rank exit 0 in {pod['wall_s']!r} s "
          f"(the launcher's wall {fed['pod']['wall_s']!r} s); rank 0 "
          f"{rank0['s_per_round']!r} s/round ({rank0['wall_s_per_round']!r} "
          f"incl. snapshots) beside {out['world']} world of the same flags "
          f"{mp_world_s_per_round}; participants' generators torch.equal "
          f"to each other and the world's; federation.json {n} journals, "
          f"{POD_ROUNDS} rounds; launches {out['launches_total']}  [{card}]",
          flush=True)
    print(f"pod: departure (kill_client:rank=2,round=2): launcher exit 1, "
          f"codes {dpod['exit_codes']}, rank 0 names --resume, rank 2 "
          f"departed at {departed['at_s']!r} s, every rank reaped at "
          f"{dpod['wall_s']!r} s (grace {grace} s); phase "
          f"{out['wall_phase_s']!r} s  [{card}]", flush=True)
    return out


def _pod_with_checks(build_root: str, seed: int, card: str,
                     mp_world_s_per_round=None, world_generator=None):
    """:func:`pod_phase` in a scratch directory, then K1 and K2 against
    their plain versions at a participant's shape (one batch of the
    federation's layout)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_pod_", dir=build_root)
    try:
        pod = pod_phase(root, seed, card, mp_world_s_per_round,
                        world_generator)
        kw = preprocessor_kwargs(PRESETS["intrusion"])
        selected = kw.pop("selected_columns", None)
        pres = [TablePreprocessor(table=read_csv(p), name="Intrusion",
                                  selected_columns=selected, **kw)
                for p in _pod_shards(root, seed)]
        spec = SegmentSpec.from_output_info(federated_initialize(
            pres, seed=seed, device="cuda").output_info)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows = (("pod", pod["train_rows"]),)
    return (pod, check_kernel(spec, card, rows, extra=False),
            check_bwd_kernel(spec, card, rows, extra=False))


SOAK_SEEDS = 5


def soak_phase(root: str, card: str) -> dict:
    """The soaks on the card, in this process (launches counted):
    ``run_soak`` for seeds 0-4 (3 clients stacked, 3 rounds, a random
    fault plan each), each completed with finite parameters or aborted
    cleanly; then ``run_churn_soak`` at 50 rounds meeting JAX's
    acceptance (completed, finite, nothing built across the joins, a
    rollback, a drift alarm, clients 1 and 5 dropped, ``obs slo`` 0)."""
    soak = _script("torch_soak")
    t_phase = time.perf_counter()
    activate_cuda.reset_launches()
    seeds = []
    for s in range(SOAK_SEEDS):
        t0 = time.perf_counter()
        r = soak.run_soak(seed=s, epochs=3, n_clients=3, rows=240,
                          device="cuda")
        r["wall_s"] = time.perf_counter() - t0
        clean = (r["outcome"] == "aborted"
                 and r["detail"].startswith(("RuntimeError: ",
                                             "ValueError: ")))
        if not (clean or (r["outcome"] == "completed"
                          and r["finite_params"])):
            raise AssertionError(f"soak seed {s}: {r}")
        seeds.append(r)
    soak_launches = {"K1": fused_apply_activate.launches,
                     "K2": fused_activate_bwd.launches}
    activate_cuda.reset_launches()
    t0 = time.perf_counter()
    churn = soak.run_churn_soak(seed=0, epochs=50,
                                out_dir=os.path.join(root, "churn"),
                                device="cuda")
    churn["wall_s"] = time.perf_counter() - t0
    churn_launches = {"K1": fused_apply_activate.launches,
                      "K2": fused_activate_bwd.launches}
    if not soak.churn_ok(churn) or churn["schema_violations"]:
        raise AssertionError(f"churn soak: {churn}")
    for what, n in (("soak", soak_launches), ("churn soak", churn_launches)):
        if not (n["K1"] > 0 and n["K2"] > 0):
            raise AssertionError(f"{what} launched {n}")
    out = {
        "seeds": [{k: r[k] for k in ("seed", "faults", "aggregator",
                                     "outcome", "detail", "finite_params",
                                     "dropped", "wall_s")} for r in seeds],
        "launches": soak_launches,
        "churn": {k: churn[k] for k in (
            "outcome", "finite_params", "join_compiles", "rollbacks",
            "alarms", "dropped", "slo_exit", "windows", "population",
            "buffered_applied", "canary_avg_jsd", "canary_avg_wd",
            "builds", "wall_s")},
        "churn_launches": churn_launches,
        "soak_step": (seeds[0]["step_rows"], seeds[0]["output_info"]),
        "churn_step": (churn["step_rows"], churn["output_info"]),
        "wall_s": time.perf_counter() - t_phase}
    for r in seeds:
        print(f"soak: seed {r['seed']} {r['faults']!r} ({r['aggregator']}): "
              f"{r['outcome']}, finite {r['finite_params']}, dropped "
              f"{r['dropped']} {r['detail']} in {r['wall_s']!r} s  [{card}]",
              flush=True)
    c = out["churn"]
    print(f"soak: churn soak, 50 rounds: {c['outcome']}, finite "
          f"{c['finite_params']}, builds across the joins "
          f"{c['join_compiles']}, rollbacks {c['rollbacks']}, alarms "
          f"{c['alarms']}, dropped {c['dropped']}, obs slo exit "
          f"{c['slo_exit']}, canary JSD {c['canary_avg_jsd']} WD "
          f"{c['canary_avg_wd']} in {c['wall_s']!r} s; launches soak "
          f"{soak_launches}, churn {churn_launches}; phase "
          f"{out['wall_s']!r} s  [{card}]", flush=True)
    return out


def _soak_with_checks(build_root: str, card: str):
    """:func:`soak_phase`, then K1 and K2 against their plain versions at
    the soaks' stacked steps (3 clients' and 16 slots' batches of the toy
    layout)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_soak_", dir=build_root)
    try:
        soak = soak_phase(root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    shapes, bwd = [], []
    for case in ("soak", "churn"):
        rows, info = soak.pop(f"{case}_step")
        spec = SegmentSpec.from_output_info([tuple(s) for s in info])
        soak[f"{case}_step_rows"] = rows
        shapes += check_kernel(spec, card, ((case, rows),), extra=False)
        bwd += check_bwd_kernel(spec, card, ((case, rows),), extra=False)
    return soak, shapes, bwd


def trace_attribution_check(prof_dir: str, trace: dict, card: str) -> dict:
    """``scripts/torch_trace_attribution.py`` on the observatory's trace,
    through its CLI: its K1 and K2 counts in ``device_modules_ms`` equal
    the phase's own counts of the same trace, its summed busy ms is
    within 1% of the phase's, and the round's spans are host hotspots."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_trace_attribution.py"),
         prof_dir], cwd=REPO, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"trace attribution: {proc.stderr[-2000:]}")
    attr = json.loads(proc.stdout)[prof_dir]
    counts = {k: sum(v["count"] for m, v in attr["device_modules_ms"].items()
                     if name in m) for k, name in KERNEL_NAMES.items()}
    busy = sum(attr["device_stream_ms"].values())
    spans = [s for s in OBS_SPANS if s in attr["host_hotspots_ms"]]
    if (counts["K1"] != trace["K1"] or counts["K2"] != trace["K2"]
            or abs(busy - trace["busy_ms"]) > 0.01 * trace["busy_ms"]
            or spans != list(OBS_SPANS)):
        raise AssertionError(f"attribution {counts}, busy {busy!r}, spans "
                             f"{spans} against the trace's {trace}")
    print(f"trace attribution: K1 {counts['K1']} and K2 {counts['K2']} "
          f"(the phase's {trace['K1']}, {trace['K2']}), busy {busy!r} ms "
          f"(the phase's {trace['busy_ms']!r}) over "
          f"{len(attr['device_stream_ms'])} stream(s); top kernels "
          f"{list(attr['device_modules_ms'])[:4]}; host hotspots "
          f"{ {k: v['total'] for k, v in attr['host_hotspots_ms'].items()} }"
          f"  [{card}]", flush=True)
    return {"K1": counts["K1"], "K2": counts["K2"], "busy_ms": busy,
            **{k: attr[k] for k in ("device_stream_ms", "device_modules_ms",
                                    "host_hotspots_ms")}}


# ------------------------------------------------------ offline evaluation
# slice 16: the similarity report over a run's snapshots, the monitor's
# cross-check, the encoder zoo on the card, and the paths that need a host
# library (pyarrow, sklearn), which run where it imports and exit 2 naming
# it where it does not

OFFLINE_ROUNDS = 2
ZOO_ROWS = 40_000
ZOO_ENCODERS = (("binning", lambda dev: zoo.BinningTransformer(32, device=dev)),
                ("minmax_sigmoid", lambda dev: zoo.MinMaxTransformer(
                    "sigmoid", device=dev)),
                ("minmax_tanh", lambda dev: zoo.MinMaxTransformer(
                    "tanh", device=dev)),
                ("grid", lambda dev: zoo.GridTransformer(7, device=dev)))


def _offline_argv(csv_path: str, out: str, seed: int,
                  rounds: int = OFFLINE_ROUNDS) -> list:
    """The fedavg CLI at full width on the Intrusion-like CSV: a 40,000-row
    snapshot and an on-device monitor probe each round."""
    return ["--mode", "fedavg", "--datapath", csv_path, "--dataset",
            "intrusion", "--n-clients", str(FED_CLIENTS), "-epochs",
            str(rounds), "--sample-every", "1", "--monitor-every", "1",
            "--sample-rows", str(SNAPSHOT_ROWS), "--out-dir", out, "--seed",
            str(seed)]


def _start(cmd: list, root: str, tag: str, env=None) -> dict:
    """``cmd`` in a process of its own (cwd the repository), its output
    in files under ``root``; a thread notes when it ends."""
    out = open(os.path.join(root, f"{tag}.out"), "w+")
    err = open(os.path.join(root, f"{tag}.err"), "w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=out, stderr=err,
                            env={**os.environ, **(env or {})})
    job = {"tag": tag, "proc": proc, "out": out, "err": err, "t0": t0}

    def note_end():
        proc.wait()
        job["t1"] = time.perf_counter()

    threading.Thread(target=note_end, daemon=True).start()
    return job


def _wait(job: dict, timeout: float = 600) -> tuple:
    """``(returncode, stdout, stderr, seconds it ran)`` of a started
    process."""
    try:
        rc = job["proc"].wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        job["proc"].kill()
        job["proc"].wait()
        raise AssertionError(f"{job['tag']}: still running after {timeout} s")
    texts = []
    for f in (job["out"], job["err"]):
        f.seek(0)
        texts.append(f.read())
        f.close()
    return (rc, texts[0], texts[1],
            job.get("t1", time.perf_counter()) - job["t0"])


# path -> (the library it needs, what the path is)
HOST_PATHS = {"parquet": ("pyarrow", "--snapshot-format parquet"),
              "feather": ("pyarrow", "--snapshot-format feather"),
              "sklearn_fit": ("sklearn", "--bgm-backend sklearn"),
              "utility": ("sklearn", "python -m fed_tgan_torch.eval.utility")}


def _has(lib: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(lib) is not None


def _start_host_path(name: str, root: str, csv_path: str, seed: int,
                     snapshot: str) -> dict:
    """One host-library path in a process of its own.  Where its library
    does not import, the process sees no card (``CUDA_VISIBLE_DEVICES``
    empty): its exit 2 then shows the check came before any CUDA work (a
    probe would exit 3)."""
    lib, _ = HOST_PATHS[name]
    env = None if _has(lib) else {"CUDA_VISIBLE_DEVICES": ""}
    out = os.path.join(root, f"host_{name}")
    if name == "utility":
        test_csv = os.path.join(root, "intrusion_test.csv")
        if not os.path.exists(test_csv):
            write_intrusion_csv(test_csv, 5_000, seed + 1)
        cmd = [sys.executable, "-m", "fed_tgan_torch.eval.utility",
               "--real-train", csv_path, "--real-test", test_csv,
               "--synthetic", snapshot, "--target", "class",
               "--categorical", *PRESETS["intrusion"].categorical_columns,
               "--json"]
    elif name == "sklearn_fit":
        cmd = [sys.executable, "-m", "fed_tgan_torch",
               *_offline_argv(csv_path, out, seed, rounds=1),
               "--bgm-backend", "sklearn"]
    else:
        # one round: round 0 (constant learning rate) and its snapshot are
        # the main run's round 0
        cmd = [sys.executable, "-m", "fed_tgan_torch",
               *_offline_argv(csv_path, out, seed, rounds=1),
               "--snapshot-format", name]
    job = _start(cmd, root, f"host_{name}", env)
    job.update(name=name, lib=lib, present=env is None, out_dir=out)
    return job


def _columnar_equals_csv(path: str, csv_blob: bytes) -> int:
    """A columnar snapshot read back, written as a CSV (a null as
    ``' '``), is the CSV snapshot's bytes; returns the rows compared."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    table = (pq.read_table(path) if path.endswith(".parquet")
             else pa.ipc.open_file(path).read_all()).to_pydict()
    cells = {name: np.array([" " if v is None else v for v in values],
                            dtype=object) for name, values in table.items()}
    if plain_csv_bytes(cells) != csv_blob:
        raise AssertionError(f"{path}: its values differ from the CSV "
                             "snapshot's")
    return len(next(iter(table.values()), []))


def _finish_host_path(job: dict, result_dir: str) -> dict:
    """Wait for one host-library path and check the branch it took."""
    rc, out, err, wall = _wait(job)
    name, lib, what = job["name"], job["lib"], HOST_PATHS[job["name"]][1]
    res = {"library": lib, "present": job["present"], "rc": rc,
           "wall_s": wall}
    if not job["present"]:
        if rc != 2 or f"needs {lib}" not in err:
            raise AssertionError(f"{what} without {lib}: exit {rc}, "
                                 f"{err[-600:]!r}")
        if name != "utility" and os.path.exists(job["out_dir"]):
            raise AssertionError(f"{what} without {lib} wrote {job['out_dir']}")
        res["branch"] = f"exit 2 naming {lib}, no CUDA touched"
        return res
    if rc != 0:
        raise AssertionError(f"{what}: exit {rc}: {err[-3000:]}")
    own = os.path.join(job["out_dir"], "Intrusion_result")
    if name in ("parquet", "feather"):
        res["rows_equal"] = _columnar_equals_csv(
            os.path.join(own, f"Intrusion_synthesis_epoch_0.{name}"),
            open(os.path.join(result_dir, "Intrusion_synthesis_epoch_0.csv"),
                 "rb").read())
        res["branch"] = (f"ran: the .{name} snapshot of round 0 equal to "
                         "the CSV's values")
    elif name == "sklearn_fit":
        snap = read_csv(os.path.join(own, "Intrusion_synthesis_epoch_0.csv"))
        if not all(np.isfinite(snap[c]).all() for c in ("duration",
                                                        "src_bytes")):
            raise AssertionError("--bgm-backend sklearn: non-finite snapshot")
        res["branch"] = "ran: a host-fit init and one round on the card"
    else:
        res["utility"] = json.loads(out.strip().splitlines()[-1])
        if not all(math.isfinite(v) for row in res["utility"]["difference"]
                   for v in row):
            raise AssertionError(f"utility: {res['utility']}")
        res["branch"] = "ran: LR/DT/RF/MLP on the snapshot, finite"
    return res


def offline_eval_phase(root: str, seed: int, card: str) -> dict:
    """Slice 16's offline workflow on the card: the fedavg CLI (2 rounds,
    snapshots and monitor probes every round, launches counted in this
    process), ``python -m fed_tgan_torch.eval.similarity`` over its
    snapshots and timing (rows = the snapshot rounds, values equal to
    ``statistical_similarity`` here), the monitor's cross-check
    (``scripts/torch_crosscheck_monitor.py``, 2 rounds compared), the
    closed-form zoo encoders on 40,000 rows (card tensors ``torch.equal``
    to the CPU's) and the four host-library paths."""
    t_phase = time.perf_counter()
    csv_path = os.path.join(root, "intrusion.csv")
    write_intrusion_csv(csv_path, FED_ROWS, seed)
    out = os.path.join(root, "offline_out")
    result_dir = os.path.join(out, "Intrusion_result")
    snapshots = [os.path.join(result_dir, f"Intrusion_synthesis_epoch_{e}.csv")
                 for e in range(OFFLINE_ROUNDS)]
    # the CLI paths beside the run (processes of their own); the utility
    # CLI reads the run's last snapshot, so it starts after the run
    host = [_start_host_path(name, root, csv_path, seed, snapshots[-1])
            for name in ("parquet", "feather", "sklearn_fit")]
    run = _cli_run(_offline_argv(csv_path, out, seed))
    names = sorted(os.listdir(result_dir))
    if names != sorted(os.path.basename(p) for p in snapshots):
        raise AssertionError(f"offline run: snapshots {names}")
    if min(run["launches"].values()) <= 0:
        raise AssertionError(f"offline run launched {run['launches']}")
    host.append(_start_host_path("utility", root, csv_path, seed,
                                 snapshots[-1]))

    categorical = list(PRESETS["intrusion"].categorical_columns)
    report_csv = os.path.join(root, "report.csv")
    timing = os.path.join(out, "timestamp_experiment.csv")
    report_job = _start(
        [sys.executable, "-m", "fed_tgan_torch.eval.similarity", "--real",
         csv_path, "--result-dir", result_dir, "--name", "Intrusion",
         "--categorical", *categorical, "--timing", timing, "-o",
         report_csv], root, "report")
    # the same metrics in this process, while the report runs
    real = read_csv(csv_path)
    want = [statistical_similarity(real, read_csv(p), categorical)[:2]
            for p in snapshots]
    rc, rout, rerr, report_s = _wait(report_job)
    if rc != 0 or "RuntimeWarning" in rerr:
        raise AssertionError(f"the similarity report exited {rc}: "
                             f"{rerr[-2000:]}")
    report = read_csv(report_csv)
    per_round = [float(line.split(",")[0]) for line in open(timing)
                 if line.strip()]
    if report["Epoch_No."].tolist() != list(range(OFFLINE_ROUNDS)):
        raise AssertionError(f"report rounds {report['Epoch_No.']}")
    got = list(zip(report["Avg_JSD"].tolist(), report["Avg_WD"].tolist()))
    if got != want or not np.isfinite(got).all():
        raise AssertionError(f"report {got} != statistical_similarity {want}")
    if report["time_stamp"].tolist() != np.cumsum(per_round).tolist():
        raise AssertionError("report time_stamp is not the cumulative "
                             "round time")

    xc_out = io.StringIO()
    with contextlib.redirect_stdout(xc_out):
        _script("torch_crosscheck_monitor").main([
            "--monitor-csv", os.path.join(out, "monitor_similarity.csv"),
            "--similarity-csv", report_csv])
    gaps = json.loads(xc_out.getvalue().strip().splitlines()[-1])
    if gaps["rounds_compared"] != OFFLINE_ROUNDS:
        raise AssertionError(f"cross-check: {gaps}")

    raw = intrusion_like_raw(ZOO_ROWS, seed)
    data = np.empty((ZOO_ROWS, len(raw)), dtype=object)
    for i, v in enumerate(raw.values()):
        data[:, i] = v
    cat_idx = [i for i, v in enumerate(raw.values()) if v.dtype.kind != "f"]
    zoo_res = {}
    for name, make in ZOO_ENCODERS:
        tensors, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            enc = make(dev)
            enc.fit(data, categorical_columns=cat_idx)
            tensors[dev] = enc.transform(data)
            if dev == "cuda":
                torch.cuda.synchronize()
            secs[dev] = time.perf_counter() - t0
        card_t = tensors["cuda"].cpu()
        err = float((card_t.double() - tensors["cpu"].double()).abs().max())
        if tensors["cuda"].device.type != "cuda" or not torch.equal(
                card_t, tensors["cpu"]):
            raise AssertionError(f"zoo {name}: the card's tensor differs from "
                                 f"the CPU's (max abs error {err!r})")
        zoo_res[name] = {"shape": list(card_t.shape),
                         "dtype": str(card_t.dtype), "max_abs_err": err,
                         "fit_transform_s": secs}

    branches = {job["name"]: _finish_host_path(job, result_dir)
                for job in host}
    phase_s = time.perf_counter() - t_phase
    for name, b in branches.items():
        print(f"offline eval: {HOST_PATHS[name][1]} -> {b['branch']} "
              f"({b['wall_s']!r} s)  [{card}]", flush=True)
    print(f"offline eval: fedavg CLI {OFFLINE_ROUNDS} rounds in "
          f"{run['wall_s']!r} s (K1 {run['launches']['K1']}, K2 "
          f"{run['launches']['K2']}); report rows {got} equal to this "
          f"process's in {report_s!r} s; monitor vs offline: "
          f"{json.dumps(gaps)}; zoo on {ZOO_ROWS} rows card == CPU "
          f"({', '.join(zoo_res)}); phase {phase_s!r} s  [{card}]",
          flush=True)
    return {"cli_wall_s": run["wall_s"], "launches": run["launches"],
            "report": {"rows": got, "time_stamp": report["time_stamp"]
                       .tolist(), "seconds": report_s},
            "crosscheck": gaps, "zoo": zoo_res, "host_paths": branches,
            "phase_s": phase_s}


def _offline_eval_with_checks(build_root: str, seed: int, card: str,
                              shapes=None, bwd_shapes=None):
    """:func:`offline_eval_phase` in a scratch directory.  Alone (no
    ``shapes`` from the federated phases): K1 and K2 against their plain
    versions at its stacked step and K1 at its snapshot chunk."""
    root = tempfile.mkdtemp(prefix="chip_smoke_offline_", dir=build_root)
    try:
        phase = offline_eval_phase(root, seed, card)
        if shapes is None:
            spec = SegmentSpec.from_output_info(_fed_init(
                os.path.join(root, "intrusion.csv"), FED_CLIENTS, seed,
                "cuda").output_info)
            B = steps.TrainConfig().batch_size
            shapes = check_kernel(spec, card, (("fed", FED_CLIENTS * B),
                                               ("fed_snapshot", 128 * B)),
                                  extra=False)
            bwd_shapes = check_bwd_kernel(spec, card,
                                          (("fed", FED_CLIENTS * B),),
                                          extra=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fwd, bwd = ("fed_tgan_tpu/ops/activate_pallas.py:81",
                "fed_tgan_tpu/ops/activate_pallas.py:102")
    kernels = []
    for name, replaces, results, kernel in (
            ("fused_gumbel_activation_fwd_offline_eval", fwd, shapes, "K1"),
            ("fused_gumbel_activation_bwd_offline_eval", bwd, bwd_shapes,
             "K2")):
        main = next(r for r in results if r["case"] == "fed")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fed_tgan_torch/csrc/activate.cu",
            "replaces": replaces, "launches": phase["launches"][kernel],
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "device_ms": main["device_ms"], "host_us": main["host_us"],
            "plan": main["plan"], "library_ms": None,
            "path": "offline evaluation run (fedavg CLI, monitored)",
            "shape": main["shape"], "shapes": results})
    return phase, kernels


def _run_level_kernels(pod, pod_shapes, pod_bwd, soak, soak_shapes,
                       soak_bwd) -> list:
    """The kernels' entries of slice 15's paths: a pod participant's step
    (launches summed over the participants' own counters), the fault
    soak's and the churn soak's stacked steps (counted here)."""
    fwd, bwd_ref = ("fed_tgan_tpu/ops/activate_pallas.py:81",
                    "fed_tgan_tpu/ops/activate_pallas.py:102")
    out = []
    for name, replaces, results, case, launches, path in (
            ("fused_gumbel_activation_fwd_pod", fwd, pod_shapes, "pod",
             pod and pod["launches_total"]["K1"], "pod launcher"),
            ("fused_gumbel_activation_bwd_pod", bwd_ref, pod_bwd, "pod",
             pod and pod["launches_total"]["K2"], "pod launcher"),
            ("fused_gumbel_activation_fwd_soak", fwd, soak_shapes, "soak",
             soak and soak["launches"]["K1"], "fault soak"),
            ("fused_gumbel_activation_bwd_soak", bwd_ref, soak_bwd, "soak",
             soak and soak["launches"]["K2"], "fault soak"),
            ("fused_gumbel_activation_fwd_churn_soak", fwd, soak_shapes,
             "churn", soak and soak["churn_launches"]["K1"], "churn soak"),
            ("fused_gumbel_activation_bwd_churn_soak", bwd_ref, soak_bwd,
             "churn", soak and soak["churn_launches"]["K2"], "churn soak")):
        if not results:
            continue
        main = next(r for r in results if r["case"] == case)
        out.append({
            "name": name, "route": "cuda",
            "source": "fed_tgan_torch/csrc/activate.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "device_ms": main["device_ms"], "host_us": main["host_us"],
            "plan": main["plan"], "library_ms": None, "path": path,
            "shape": main["shape"], "shapes": results})
    return out


# ---------------------------------------------------- the program contracts
# slice 17: the dispatch contracts on the card and the doctor's analysis
# checks (fed_tgan_torch/analysis/contracts/, fed_tgan_torch/doctor.py)

# the doctor's four analysis checks on the card, their subprocesses at once
_DOCTOR_ANALYSIS = (
    "from fed_tgan_torch import doctor as d\n"
    "procs = (d._spawn_analysis(['--contracts'], 'cuda'),\n"
    "         d._spawn_analysis(['--all'], 'cuda'), d._spawn_seam('cuda'))\n"
    "d.check_static_analysis('cuda')\n"
    "d.check_program_contracts('cuda', proc=procs[0])\n"
    "d.check_analysis_all('cuda', proc=procs[1])\n"
    "d.check_backend_seam('cuda', proc=procs[2])\n")


def _communicate(proc, timeout: float) -> tuple:
    """``(returncode, stdout, stderr)`` of ``proc``, killed past
    ``timeout``."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{proc.args[:4]} timed out after {timeout} s")
    return proc.returncode, out, err


def contracts_phase(card: str, doctor_lines=None) -> dict:
    """Phase 24: the card's program contracts and the doctor's analysis
    checks, in two processes at once; fails on a contract regression, a
    harness error, a K1/K2 count that differs from the CPU contract's or
    a failed check.  ``doctor_lines``: the four checks' lines of a doctor
    this script already ran on the card (phase 20's), read in place of
    running them again."""
    from fed_tgan_torch.analysis.contracts.check import (
        CONTRACTS_DIR,
        load_contracts,
    )

    t0 = time.perf_counter()
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    pipes = dict(cwd=REPO, env=env, stdout=subprocess.PIPE,
                 stderr=subprocess.PIPE, text=True)
    procs = [subprocess.Popen([sys.executable, "-m",
                               "fed_tgan_torch.analysis", "--contracts",
                               "--backend", "gpu", "--format", "json"],
                              **pipes)]
    if doctor_lines is None:
        procs.append(subprocess.Popen([sys.executable, "-c",
                                       _DOCTOR_ANALYSIS], **pipes))
    try:
        rc, out, err = _communicate(procs[0], 600)
        drc, dout, derr = (_communicate(procs[1], 900) if doctor_lines is None
                           else (0, "\n".join(doctor_lines), ""))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    lines = [ln for ln in dout.splitlines() if ln.startswith(("OK ", "FAIL"))]
    for line in lines:
        print(f"doctor {line}  [{card}]", flush=True)
    if rc != 0:
        raise AssertionError(f"--contracts --backend gpu exited {rc}: "
                             f"{(out or '')[-1500:]} {(err or '')[-1500:]}")
    report = json.loads(out)
    checks = {ln.split()[1].rstrip(":"): ln.startswith("OK ")
              for ln in lines}
    if drc != 0 or sorted(checks) != sorted(ANALYSIS_CHECKS) or \
            not all(checks.values()):
        raise AssertionError(f"doctor analysis checks {checks} (exit {drc}): "
                             f"{(derr or '')[-1500:]}")
    cpu = load_contracts(report["programs"], CONTRACTS_DIR)
    launches = {"K1": 0, "K2": 0}
    by_program = {}
    for family, programs in sorted(report["programs"].items()):
        stored = (cpu[family] or {}).get("programs", {})
        for name, fp in sorted(programs.items()):
            k = fp["kernels"]
            calls = {kern: sum(n for v, n in k.items() if v.startswith(kern))
                     for kern in ("K1", "K2")}
            t = fp["transfers"]
            print(f"contract {family}/{name}: K1 {calls['K1']} K2 "
                  f"{calls['K2']} {k}, syncs {t['syncs']}, cross-device "
                  f"copies {t['copies']} ({t['copy_bytes']} B), "
                  f"collectives {fp['collectives']}  [{card}]", flush=True)
            want = stored.get(name, {}).get("kernels")
            if k != want:
                raise AssertionError(f"{family}/{name}: K1/K2 calls on the "
                                     f"card {k} != the CPU contract's {want}")
            for kern in launches:
                launches[kern] += calls[kern]
            by_program[f"{family}/{name}"] = {
                "kernels": k, "syncs": t["syncs"], "copies": t["copies"],
                "copy_bytes": t["copy_bytes"]}
    seconds = time.perf_counter() - t0
    source = " (phase 20's doctor)" if doctor_lines is not None else ""
    print(f"contracts: {len(by_program)} programs honour "
          f"analysis/contracts/gpu/, K1/K2 calls equal to the CPU "
          f"contracts' ({launches['K1']} K1, {launches['K2']} K2 launches); "
          f"doctor {'/'.join(sorted(checks))} OK{source}; {seconds!r} s  "
          f"[{card}]", flush=True)
    return {"programs": len(by_program), "launches": launches,
            "by_program": by_program, "checks": checks,
            "drift": sum(i["severity"] == "drift" for i in report["issues"]),
            "improvements": report["improvements"], "seconds": seconds}


def _contracts_with_checks(card: str, doctor_lines=None):
    """Phase 24, then K1 and K2 against their plain versions at the
    contracts' training shape: the small 2-client table's stacked step."""
    from fed_tgan_torch.obs.ledger import _small_config, _small_init

    contracts = contracts_phase(card, doctor_lines)
    init, _ = _small_init("cuda")
    spec = SegmentSpec.from_output_info(init.output_info)
    size = (("contracts", len(init.client_matrices)
             * _small_config().batch_size),)
    shapes = check_kernel(spec, card, size, extra=False)
    bwd = check_bwd_kernel(spec, card, size, extra=False)
    fwd_ref, bwd_ref = ("fed_tgan_tpu/ops/activate_pallas.py:81",
                        "fed_tgan_tpu/ops/activate_pallas.py:102")
    kernels = []
    for name, kernel, replaces, results in (
            ("fused_gumbel_activation_fwd_contracts", "K1", fwd_ref, shapes),
            ("fused_gumbel_activation_bwd_contracts", "K2", bwd_ref, bwd)):
        main = next(r for r in results if r["case"] == "contracts")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fed_tgan_torch/csrc/activate.cu",
            "replaces": replaces,
            # every variant's calls over the contracted programs, counted
            # in the contracts' process (held to its launch counters)
            "launches": contracts["launches"][kernel],
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "device_ms": main["device_ms"], "host_us": main["host_us"],
            "plan": main["plan"], "library_ms": None,
            "path": "program contracts", "shape": main["shape"],
            "shapes": results})
    return contracts, kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=5000)
    ap.add_argument("--ab", metavar="TREE",
                    help="instead of the phases: time the kernels of the "
                    "fed_tgan_torch package under TREE against this one's")
    ap.add_argument("--onboard", metavar="N", type=int, nargs="+",
                    help="instead of the phases: the onboarding phase at "
                    "these populations only (N = 1024: the JAX sweep's "
                    "largest)")
    ap.add_argument("--multiprocess", action="store_true",
                    help="instead of the phases: the multi-process world "
                    "and its kernel checks only (a killed participant "
                    "ending every process is checked by --pod's "
                    "departure pod)")
    ap.add_argument("--observatory", action="store_true",
                    help="instead of the phases: the observatory phase "
                    "only")
    ap.add_argument("--tooling", action="store_true",
                    help="instead of the phases: the tooling phase (the "
                    "sanitizers, lockwatch, the doctor, the ledger) and "
                    "its kernel checks only")
    ap.add_argument("--backend-probe", action="store_true",
                    help="instead of the phases: the backend probe phase "
                    "only")
    ap.add_argument("--pod", action="store_true",
                    help="instead of the phases: the pod launcher's phase "
                    "(a full-width pod against a world, a departure pod) "
                    "and its kernel checks only")
    ap.add_argument("--soak", action="store_true",
                    help="instead of the phases: the fault soak (seeds "
                    "0-4) and the churn soak, and their kernel checks only")
    ap.add_argument("--offline-eval", action="store_true",
                    help="instead of the phases: the offline evaluation "
                    "phase (report, cross-check, zoo, host-library paths) "
                    "and its kernel checks only")
    ap.add_argument("--contracts", action="store_true",
                    help="instead of the phases: the program contracts on "
                    "the card, the doctor's analysis checks and their "
                    "kernel checks only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # every run journal of this process and of the processes it starts
    # checks each event against the schema
    os.environ["FED_TGAN_TORCH_VALIDATE_JOURNAL"] = "1"
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    wall = {}  # phase -> wall seconds since the previous mark
    last_mark = [time.perf_counter()]

    def mark(phase: str) -> None:
        now = time.perf_counter()
        wall[phase] = now - last_mark[0]
        last_mark[0] = now

    t0 = time.perf_counter()
    lib, log = activate_cuda.build()
    print(f"built {os.path.relpath(lib, REPO)} in "
          f"{time.perf_counter() - t0!r} s  [{card}]", flush=True)
    t0 = time.perf_counter()
    csv_lib = fastcsv.build()
    print(f"built {os.path.relpath(csv_lib, REPO)} (host CSV formatter, cc) "
          f"in {time.perf_counter() - t0!r} s  [{card}]", flush=True)
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")

    build_root = os.path.join(REPO, "fed_tgan_torch", "_build")
    os.makedirs(build_root, exist_ok=True)

    def finish(*lines) -> int:
        """The phase's own JSON lines, the card line, the result line."""
        for line in lines:
            print(json.dumps(line))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.backend_probe:
        return finish({"run_level": {"backend": backend_phase(card,
                                                              build_root)}})
    if args.pod:
        pod, pod_shapes, pod_bwd = _pod_with_checks(build_root, args.seed,
                                                    card)
        return finish({"run_level": {"pod": pod}}, {
            "kernels": _run_level_kernels(pod, pod_shapes, pod_bwd, None,
                                          [], [])})
    if args.offline_eval:
        offline, offline_kernels = _offline_eval_with_checks(
            build_root, args.seed, card)
        return finish({"offline_eval": offline},
                      {"kernels": offline_kernels})
    if args.contracts:
        contracts, contract_kernels = _contracts_with_checks(card)
        return finish({"contracts": contracts}, {"kernels": contract_kernels})
    if args.soak:
        soak, soak_shapes, soak_bwd = _soak_with_checks(build_root, card)
        return finish({"run_level": {"soak": soak}}, {
            "kernels": _run_level_kernels(None, [], [], soak, soak_shapes,
                                          soak_bwd)})

    if args.onboard:
        root = tempfile.mkdtemp(prefix="chip_smoke_onboard_",
                                dir=os.path.join(REPO, "fed_tgan_torch",
                                                 "_build"))
        try:
            onboard = onboard_phase(root, args.seed, card,
                                    tuple(args.onboard))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"onboard": onboard}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.observatory:
        obs_root = tempfile.mkdtemp(prefix="chip_smoke_obs_", dir=os.path.join(
            REPO, "fed_tgan_torch", "_build"))
        try:
            observatory = observatory_phase(obs_root, args.seed, card)
        finally:
            shutil.rmtree(obs_root, ignore_errors=True)
        print(json.dumps({"observatory": observatory}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.tooling:
        tooling, tool_shapes, tool_bwd = _tooling_with_checks(
            os.path.join(REPO, "fed_tgan_torch", "_build"), args.seed, card,
            args.rows)
        print(json.dumps({"tooling": tooling}))
        print(card)
        print(json.dumps({"kernels": _tooling_kernels(
            tooling, tool_shapes, tool_bwd)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.multiprocess:
        build_root = os.path.join(REPO, "fed_tgan_torch", "_build")
        mp, mp_shapes, mp_bwd = _multiprocess_with_checks(build_root,
                                                          args.seed, card)
        mp.pop("world_generator")
        print(json.dumps({"multiprocess": mp, "shapes": mp_shapes,
                          "bwd_shapes": mp_bwd}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.ab:
        kernels_ab = ab_phase(args.ab, main_shapes(args.seed), card)
        serving_ab = serve_ab_phase(args.ab, args.rows, args.seed, card)
        print(json.dumps({"ab": kernels_ab, "ab_serving": serving_ab}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # the backend probe first, while the host is quiet: --wait-healthy
    # defers its probe under load
    backend = backend_phase(card, build_root)
    mark("backend_probe")
    # what the CLI's probe costs this script: its processes' cold probes
    stamps = StampWatch()
    _, _, columns = intrusion_layout(np.random.default_rng(args.seed))
    spec = SegmentSpec.from_output_info(output_info(columns))
    shapes = check_kernel(spec, card)
    bwd_shapes = check_bwd_kernel(spec, card)
    mark("build_and_kernel_checks")

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
        print(f"serving host side: host CSV {serving['stages_ms']['csv']!r} "
              f"ms of a {args.rows}-row request; {serving['rows_per_s']!r} "
              f"rows/s, p50 {serving['p50_ms']!r} ms  [{card}]", flush=True)
    finally:
        shutil.rmtree(art, ignore_errors=True)
    mark("serving")
    with journaled() as fleet_events:
        fleet = fleet_phase(args.seed, args.rows, card, build_root)
    fleet["journal"] = _require_events("fleet", fleet_events,
                                       ("fleet_load", "serve_stages"))
    # K1 at the shape of an 8-lane dispatch: every lane's rows at once
    shapes += check_kernel(fleet.pop("spec"), card,
                           (("fleet", fleet["lane_rows"]),), extra=False)
    mark("fleet")

    synth, meta, encoders, training = train_phase(args.seed, card)
    # both kernels again at the shape training gave them: (batch, the
    # fitted layout's width)
    train_size = (("train", synth.cfg.batch_size),)
    shapes += check_kernel(synth.spec, card, train_size, extra=False)
    bwd_shapes += check_bwd_kernel(synth.spec, card, train_size, extra=False)
    training["card_vs_cpu"] = step_reference_phase(synth, args.seed, card)
    serve_trained_phase(synth, meta, encoders, args.rows, args.seed, card)
    training.update(train_stage_breakdown(synth, args.seed, card))
    mark("training")
    with journaled() as canary_events:
        canary = canary_phase(synth, meta, encoders, args.seed, card,
                              build_root, args.rows)
    canary["journal"] = _require_events(
        "canary", canary_events, ("promotion_promoted", "promotion_rejected",
                                  "serve_stages"))
    # K1 at the shadow sample's shape: one engine chunk
    shapes += check_kernel(synth.spec, card,
                           (("canary", canary["chunk_rows"]),), extra=False)
    mark("canary")
    dated_root = tempfile.mkdtemp(prefix="chip_smoke_dated_", dir=build_root)
    try:
        dated = dated_phase(dated_root, args.seed, card)
    finally:
        shutil.rmtree(dated_root, ignore_errors=True)
    # both kernels at the dated layout: a served chunk, and a stacked step
    # of the dated training (both clients' batches)
    dated_spec = dated.pop("spec")
    dated_train = (("dated_train", dated["train_rows"]),)
    shapes += check_kernel(dated_spec, card, (("dated", dated["chunk_rows"]),
                                              *dated_train), extra=False)
    bwd_shapes += check_bwd_kernel(dated_spec, card, dated_train,
                                   extra=False)
    mark("dated")

    fed_root = tempfile.mkdtemp(prefix="chip_smoke_fed_", dir=build_root)
    cli_run = None
    try:
        write_intrusion_csv(os.path.join(fed_root, "intrusion.csv"),
                            FED_ROWS, args.seed)
        # the durable CLI's first process runs beside the federated CLI's,
        # which is timed only as a whole; nothing else runs beside the
        # timed round, and the resume runs beside the phases after it
        cli_run = DurableCLI(fed_root, args.seed)
        federated = {"cli": fed_cli_phase(fed_root, args.seed, card)}
        cli_run.first_done.wait()
        mark("federated_cli_beside_durable_cli")
        trainer, federated["round"] = fed_round_phase(fed_root, args.seed,
                                                      card)
        mark("federated_round")
        cli_run.resume()
        federated["card_vs_cpu"] = fed_reference_phase(fed_root, args.seed,
                                                       card)
        mark("federated_reference")
        durability = fed_durability_phase(trainer.init, fed_root, args.seed,
                                          card, cli_run)
        mark("durability")
        ragged = ragged_round_phase(fed_root, args.seed, card)
        ragged_tr = ragged.pop("trainer")
        federated["ragged"] = ragged
        mark("ragged_round")
    finally:
        if cli_run is not None:
            cli_run.stop()
        shutil.rmtree(fed_root, ignore_errors=True)
    # both kernels at the shapes the federated round gives them: a stacked
    # step (every client's batch, the federation's layout) and a snapshot
    # chunk; and at the ragged round's (8 clients' batches, Adult layout)
    B, N = trainer.cfg.batch_size, trainer.n_clients
    shapes += check_kernel(trainer.spec, card,
                           (("fed", N * B), ("fed_snapshot", 128 * B)),
                           extra=False)
    bwd_shapes += check_bwd_kernel(trainer.spec, card, (("fed", N * B),),
                                   extra=False)
    ragged_rows = (("ragged", ragged_tr.n_clients * B),)
    shapes += check_kernel(ragged_tr.spec, card, ragged_rows, extra=False)
    bwd_shapes += check_bwd_kernel(ragged_tr.spec, card, ragged_rows,
                                   extra=False)
    # K1 at the similarity monitor's probe: one launch over its rows
    shapes += check_kernel(trainer.spec, card,
                           (("fed_monitor", MONITOR_ROWS),), extra=False)
    fed_launches = federated["round"]["launches"]
    mark("federated_kernel_checks")
    prec_root = tempfile.mkdtemp(prefix="chip_smoke_bf16_", dir=build_root)
    try:
        precision = precision_phase(args.seed, card, prec_root, args.rows,
                                    synth, training, trainer.init,
                                    federated["round"])
    finally:
        shutil.rmtree(prec_root, ignore_errors=True)
    mark("precision")
    churn_root = tempfile.mkdtemp(prefix="chip_smoke_churn_", dir=build_root)
    try:
        onboard = onboard_phase(churn_root, args.seed, card)
        mark("onboard")
        churn = churn_phase(churn_root, args.seed, card)
    finally:
        shutil.rmtree(churn_root, ignore_errors=True)
    # both kernels at the elastic step's shape: every slot's batch
    elastic_rows = (("elastic", churn["train_rows"]),)
    churn_spec = churn.pop("spec")
    shapes += check_kernel(churn_spec, card, elastic_rows, extra=False)
    bwd_shapes += check_bwd_kernel(churn_spec, card, elastic_rows,
                                   extra=False)
    mark("churn")
    rs_root = tempfile.mkdtemp(prefix="chip_smoke_rounds_", dir=build_root)
    try:
        round_scale = round_scale_phases(rs_root, trainer.init, args.seed,
                                         card)
    finally:
        shutil.rmtree(rs_root, ignore_errors=True)
    # both kernels at the cohort step's shape (8 sampled clients' batches)
    # and at the MD-GAN step's (every client's batch)
    for path in ("cohort", "mdgan"):
        rows = ((path, round_scale[path]["train_rows"]),)
        sp = round_scale[path].pop("spec")
        shapes += check_kernel(sp, card, rows, extra=False)
        bwd_shapes += check_bwd_kernel(sp, card, rows, extra=False)
    mark("round_scale")
    multiprocess, mp_shapes, mp_bwd = _multiprocess_with_checks(
        build_root, args.seed, card)
    world_generator = multiprocess.pop("world_generator")
    shapes += mp_shapes
    bwd_shapes += mp_bwd
    mark("multiprocess")
    # one world at a time: the pod after the multi-process phase's worlds
    pod, pod_shapes, pod_bwd = _pod_with_checks(
        build_root, args.seed, card, multiprocess["world_wall_s_per_round"],
        world_generator)
    mark("pod")
    obs_root = tempfile.mkdtemp(prefix="chip_smoke_obs_", dir=build_root)
    try:
        observatory = observatory_phase(obs_root, args.seed, card)
    finally:
        shutil.rmtree(obs_root, ignore_errors=True)
    mark("observatory")
    tooling, tool_shapes, tool_bwd = _tooling_with_checks(
        build_root, args.seed, card, args.rows)
    mark("tooling")
    soak, soak_shapes, soak_bwd = _soak_with_checks(build_root, card)
    mark("soak")
    offline, offline_kernels = _offline_eval_with_checks(
        build_root, args.seed, card, shapes, bwd_shapes)
    mark("offline_eval")
    # the doctor of phase 20 ran the four analysis checks on this card
    contracts, contract_kernels = _contracts_with_checks(
        card, tooling["doctor"]["analysis_lines"])
    mark("contracts")
    backend["script_cold_probes_min"] = stamps.stop()
    print(f"backend: the script's CLI processes made at least "
          f"{backend['script_cold_probes_min']} cold probe(s) of "
          f"~{backend['cold_probe_ms']!r} ms each (a lower bound: stamp "
          f"writes, probes within 0.5 s of each other count once); every "
          f"other CLI process read the stamp (~"
          f"{backend['cached_probe_ms']!r} ms)  [{card}]", flush=True)
    if validation_violations():
        raise AssertionError(f"journal schema violations in this process: "
                             f"{validation_violations()}")
    print(f"wall seconds by phase {json.dumps(wall)}, "
          f"{sum(wall.values())!r} in all  [{card}]", flush=True)

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
        # slice 7's fleet: one launch over every lane's rows a dispatch
        entry("fused_gumbel_activation_fwd_fleet", fwd, "serving fleet",
              shapes, "fleet", fleet["launches"]),
        entry("fused_gumbel_activation_fwd_train", fwd, "training", shapes,
              "train", training["launches"]["K1"]),
        entry("fused_gumbel_activation_bwd", bwd, "training", bwd_shapes,
              "train", training["launches"]["K2"]),
        # slice 3's federated round: every client's steps and the snapshots
        entry("fused_gumbel_activation_fwd_federated", fwd, "federated",
              shapes, "fed", fed_launches["K1"]),
        entry("fused_gumbel_activation_bwd_federated", bwd, "federated",
              bwd_shapes, "fed", fed_launches["K2"]),
        # slice 4's durable round: the similarity monitor's probe
        entry("fused_gumbel_activation_fwd_monitor", fwd, "federated monitor",
              shapes, "fed_monitor", durability["monitor_launches"]),
        # slice 6's ragged round: 8 Dirichlet clients, some with no step
        entry("fused_gumbel_activation_fwd_ragged", fwd, "federated ragged",
              shapes, "ragged", federated["ragged"]["launches"]["K1"]),
        entry("fused_gumbel_activation_bwd_ragged", bwd, "federated ragged",
              bwd_shapes, "ragged", federated["ragged"]["launches"]["K2"]),
        # slice 8's canary: one launch per shadow sample (one chunk); the
        # requests served beside the decisions are in the canary's report
        entry("fused_gumbel_activation_fwd_canary", fwd, "serving canary",
              shapes, "canary", canary["shadow_samples"]),
        # slice 8's date columns: the dated artifact served, and the dated
        # CLI's stacked steps and snapshot
        entry("fused_gumbel_activation_fwd_dated", fwd, "serving dated",
              shapes, "dated", dated["launches"]["serve"]),
        entry("fused_gumbel_activation_fwd_dated_train", fwd,
              "federated dated", shapes, "dated_train",
              dated["launches"]["train"]["K1"]),
        entry("fused_gumbel_activation_bwd_dated", bwd, "federated dated",
              bwd_shapes, "dated_train", dated["launches"]["train"]["K2"]),
    ]
    # slice 10's elastic rounds: every slot's rows at each stacked step
    kernels += [
        entry("fused_gumbel_activation_fwd_elastic", fwd,
              "federated elastic", shapes, "elastic",
              churn["launches"]["K1"]),
        entry("fused_gumbel_activation_bwd_elastic", bwd,
              "federated elastic", bwd_shapes, "elastic",
              churn["launches"]["K2"]),
    ]
    # slice 11: the cohort round's steps (8 sampled clients' rows) and the
    # MD-GAN step (every client's rows)
    kernels += [
        entry("fused_gumbel_activation_fwd_cohort", fwd, "federated cohort",
              shapes, "cohort", round_scale["cohort"]["launches"]["K1"]),
        entry("fused_gumbel_activation_bwd_cohort", bwd, "federated cohort",
              bwd_shapes, "cohort", round_scale["cohort"]["launches"]["K2"]),
        entry("fused_gumbel_activation_fwd_mdgan", fwd, "mdgan", shapes,
              "mdgan", round_scale["mdgan"]["launches"]["K1"]),
        entry("fused_gumbel_activation_bwd_mdgan", bwd, "mdgan", bwd_shapes,
              "mdgan", round_scale["mdgan"]["launches"]["K2"]),
    ]
    # slice 12's multi-process world: one participant's steps (its own
    # batch) and rank 1's snapshot chunks, counted in rank 1
    kernels += [
        entry("fused_gumbel_activation_fwd_multiprocess", fwd,
              "federated multi-process", shapes, "multiprocess",
              multiprocess["launches_rank1"]["K1"]),
        entry("fused_gumbel_activation_bwd_multiprocess", bwd,
              "federated multi-process", bwd_shapes, "multiprocess",
              multiprocess["launches_rank1"]["K2"]),
    ]
    # slice 14's tooling: the sanitized round (its own process) and the
    # gradient-flow summary on the card
    kernels += _tooling_kernels(tooling, tool_shapes, tool_bwd)
    # slice 15: a pod participant's steps (its own counters), the fault
    # soak's and the churn soak's stacked steps
    kernels += _run_level_kernels(pod, pod_shapes, pod_bwd, soak,
                                  soak_shapes, soak_bwd)
    # slice 16: the offline evaluation's fedavg run (stacked steps,
    # snapshot chunks, monitor probes), counted in this process
    kernels += offline_kernels
    # slice 17: the contracted programs' calls, counted in their process
    kernels += contract_kernels
    # slice 9's bf16 variants: their launches on the bf16 paths (training,
    # the federated round, serving), each path counted on its own
    by_path = precision.pop("launches_by_path")
    bf16_shapes = precision.pop("shapes")
    for name, variant, kernel, replaces, main_case in (
            ("fused_gumbel_activation_fwd_bf16", "fwd_bf16", "K1", fwd,
             "served"),
            ("fused_gumbel_activation_fwd_train_bf16", "fwd_train_bf16",
             "K1", fwd, "train"),
            ("fused_gumbel_activation_bwd_bf16", "bwd_bf16", "K2", bwd,
             "train")):
        counts = {path: launches[kernel][
            "bf16_train" if variant == "fwd_train_bf16" else "bf16"]
            for path, launches in by_path.items()}
        kernels.append({
            **entry(name, replaces, "bf16 training, federated and serving",
                    bf16_shapes[variant], main_case, sum(counts.values())),
            "launches_by_path": counts,
            "bytes_per_element": BF16_VARIANTS[variant][1]})
    print(json.dumps({"training": training}))
    print(json.dumps({"federated": federated}))
    print(json.dumps({"durability": durability}))
    print(json.dumps({"canary": canary, "dated": dated}))
    print(json.dumps({"precision": precision}))
    print(json.dumps({"onboard": onboard, "churn": churn}))
    print(json.dumps({"round_scale": round_scale}))
    print(json.dumps({"multiprocess": multiprocess}))
    print(json.dumps({"observatory": observatory}))
    print(json.dumps({"tooling": tooling}))
    print(json.dumps({"run_level": {"backend": backend, "pod": pod,
                                    "soak": soak}}))
    print(json.dumps({"offline_eval": offline}))
    print(json.dumps({"contracts": contracts}))
    print(card)
    print(json.dumps({"kernels": kernels, "serving": serving,
                      "fleet": fleet}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
