"""Run-journal summarizer behind ``python -m fed_tgan_torch.obs report``
(counterpart of ``fed_tgan_tpu/obs/report.py:21-752``: the same folds, so
the two packages summarize a journal alike).

Turns one JSONL journal into the questions an operator actually asks
after a run: how many rounds and how fast, did the watchdog fire, who
got quarantined or dropped, did transport flap, what compiled, where
are the checkpoints.  Text by default, ``--format json`` for tooling
(``tests/test_torch_obs.py`` holds it equal to the JAX package's).
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Sequence, Union

from fed_tgan_torch.obs.journal import read_journal

__all__ = ["summarize", "summarize_many", "render_text"]


def _clients_section(contribs: List[dict], quarantines: List[dict],
                     alarms: List[dict], rollbacks: List[dict],
                     drops: List[dict],
                     joins: Sequence[dict] = (),
                     lefts: Sequence[dict] = (),
                     drift_alarms: Sequence[dict] = ()) -> dict:
    """Fold ``client_contribution`` events into one per-round client table.

    Order-independent across merged rank journals: rows are keyed by
    (round, client) and folded in sorted order, so merging ``[a, b]``
    and ``[b, a]`` produces identical output.  Elastic-membership events
    (``client_joined`` / ``client_left`` / ``drift_alarm``) annotate the
    same per-client entries so one section narrates who joined, left,
    drifted, or got quarantined.
    """
    rows = []
    for ev in contribs:
        rnd = ev.get("round")
        ids = ev.get("clients") or []
        if not isinstance(rnd, int):
            continue

        def col(name, default=None):
            v = ev.get(name)
            return v if isinstance(v, list) and len(v) == len(ids) else None

        weights, ld, lg = col("weights"), col("loss_d"), col("loss_g")
        quar, strikes = col("quarantined"), col("strikes")
        for j, c in enumerate(ids):
            rows.append((
                int(rnd), int(c),
                weights[j] if weights else None,
                ld[j] if ld else None,
                lg[j] if lg else None,
                int(quar[j]) if quar else 0,
                int(strikes[j]) if strikes else 0,
            ))
    rows.sort(key=lambda r: (r[0], r[1], str(r[2:])))
    table: Dict[int, Dict[int, tuple]] = {}
    for r in rows:
        table.setdefault(r[0], {})[r[1]] = r[2:]

    per_client: Dict[str, dict] = {}
    track: Dict[int, dict] = {}
    for rnd in sorted(table):
        for c, (w, ld, lg, q, s) in sorted(table[rnd].items()):
            d = track.setdefault(c, {
                "rounds": 0, "first_round": rnd, "weight_first": w,
                "quarantined_rounds": 0, "strikes": 0,
            })
            d["rounds"] += 1
            d["last_round"] = rnd
            if d["weight_first"] is None:
                d["weight_first"] = w
            if w is not None:
                d["weight_last"] = w
            d["loss_d_last"], d["loss_g_last"] = ld, lg
            d["quarantined_rounds"] += q
            d["strikes"] = max(d["strikes"], s)
    dropped_by = {int(e["client"]): str(e.get("reason", "")) for e in drops
                  if e.get("client") is not None}
    joined_by = {int(e["client"]): e for e in joins
                 if e.get("client") is not None}
    left_by = {int(e["client"]): str(e.get("reason", "")) for e in lefts
               if e.get("client") is not None}
    drift_count: Dict[int, int] = {}
    for e in drift_alarms:
        if e.get("client") is not None:
            drift_count[int(e["client"])] = \
                drift_count.get(int(e["client"]), 0) + 1
    # membership events may name clients the contribution ledger never
    # saw (a newcomer that joined after the last ledger pull): give them
    # a row anyway so the narration is complete
    for c in set(joined_by) | set(left_by) | set(drift_count):
        track.setdefault(c, {
            "rounds": 0, "first_round": None, "weight_first": None,
            "quarantined_rounds": 0, "strikes": 0,
        })
    for c in sorted(track):
        d = track[c]
        wf, wl = d.get("weight_first"), d.get("weight_last")
        d["weight_delta"] = (round(wl - wf, 6)
                             if wf is not None and wl is not None else None)
        if c in dropped_by:
            d["dropped"] = dropped_by[c] or True
        if c in joined_by:
            je = joined_by[c]
            d["joined_round"] = je.get("round")
            if je.get("repacked"):
                d["join_repacked"] = True
        if c in left_by:
            d["left"] = left_by[c] or True
        if c in drift_count:
            d["drift_alarms"] = drift_count[c]
        per_client[str(c)] = d

    movers = sorted(
        ((c, d["weight_delta"]) for c, d in per_client.items()
         if d.get("weight_delta") is not None),
        key=lambda kv: (-abs(kv[1]), kv[0]))
    forensics = []
    wd_events = sorted(
        [("alarm", e) for e in alarms] + [("rollback", e) for e in rollbacks],
        key=lambda kv: kv[1].get("round", 0) if isinstance(
            kv[1].get("round"), int) else 0)
    for ev in quarantines:
        c = ev.get("client")
        if c is None:
            continue
        first = ev.get("first")
        entry = {
            "client": int(c),
            "first": first,
            "last": ev.get("last"),
            "rounds": ev.get("rounds"),
            "test": ev.get("test", "?"),
            "strikes": ev.get("strikes"),
        }
        # what the watchdog did next: the first alarm/rollback at or
        # after the quarantine window opened
        nxt = next((f"{kind}@{we.get('round')}"
                    + (f" ({we.get('reason')})" if we.get("reason") else "")
                    for kind, we in wd_events
                    if isinstance(we.get("round"), int)
                    and isinstance(first, int)
                    and we.get("round") >= first), None)
        if nxt:
            entry["watchdog"] = nxt
        if int(c) in dropped_by:
            entry["dropped"] = dropped_by[int(c)] or True
        forensics.append(entry)
    forensics.sort(key=lambda f: (f.get("first") or 0, f["client"]))

    out = {
        "tracked": len(per_client),
        "rounds": len(table),
        "per_client": per_client,
        "top_movers": movers[:5],
        "forensics": forensics,
    }
    if joins or lefts or drift_alarms:
        out["membership"] = {
            "joins": len(list(joins)),
            "leaves": len(list(lefts)),
            "drift_alarms": len(list(drift_alarms)),
            "join_repacks": sum(1 for e in joins if e.get("repacked")),
        }
    return out


def _similarity_section(sims: List[dict]) -> dict:
    """Drift as a first-class signal: the monitor probe's trajectory."""
    samples = [e for e in sims if isinstance(e.get("avg_jsd"), (int, float))]
    out: dict = {"samples": len(sims)}
    if samples:
        epochs = [e.get("epoch") for e in samples
                  if isinstance(e.get("epoch"), int)]
        out["first_epoch"] = min(epochs) if epochs else None
        out["last_epoch"] = max(epochs) if epochs else None
        last = samples[-1]
        out["avg_jsd_last"] = round(float(last["avg_jsd"]), 6)
        out["avg_jsd_best"] = round(
            min(float(e["avg_jsd"]) for e in samples), 6)
        if isinstance(last.get("avg_wd"), (int, float)):
            out["avg_wd_last"] = round(float(last["avg_wd"]), 6)
        per_col = last.get("per_column_jsd")
        if isinstance(per_col, dict) and per_col:
            worst = sorted(per_col.items(),
                           key=lambda kv: (-float(kv[1]), kv[0]))
            out["per_column_jsd_last"] = {
                k: round(float(v), 6) for k, v in sorted(per_col.items())}
            out["worst_columns"] = [
                [k, round(float(v), 6)] for k, v in worst[:3]]
    return out


def summarize(path: str, on_skip=None) -> dict:
    """Structured summary of one journal file."""
    return summarize_many([path], on_skip=on_skip)


def summarize_many(paths: Sequence[str], on_skip=None) -> dict:
    """One merged federation view over one or more journals.

    A multihost run writes one journal per rank; merging keys everything
    by round.  Per-rank duplicates of the round stream (every rank logs
    its own ``round`` events) are deduplicated deterministically: the
    server stream wins when present, else the lowest rank.  Per-client
    streams (``client_contribution``) union across ranks -- each rank
    contributes its own clients.  ``on_skip`` receives a warning line
    per torn/truncated journal line (crashed writer) instead of raising.
    """
    events: List[dict] = []
    for path in paths:
        events.extend(read_journal(path, on_skip=on_skip))
    # stable ts-sort: merged rank streams interleave in wall order, ties
    # keep per-journal append order (determinism for identical ts)
    events.sort(key=lambda ev: (ev.get("ts") if isinstance(
        ev.get("ts"), (int, float)) else 0.0))
    by_type: Dict[str, int] = {}
    for ev in events:
        t = str(ev.get("type", "?"))
        by_type[t] = by_type.get(t, 0) + 1

    out: dict = {
        "path": ",".join(str(p) for p in paths),
        "paths": [str(p) for p in paths],
        "events": len(events),
        "by_type": dict(sorted(by_type.items())),
        "schema": None,
        "run_id": None,
        "duration_s": None,
    }
    if events:
        first = next((e for e in events if e.get("type") == "run_start"),
                     None)
        if first is not None:
            out["schema"] = first.get("schema")
            out["run_id"] = first.get("run_id")
        ts = [e["ts"] for e in events if isinstance(e.get("ts"), (int, float))]
        if ts:
            out["duration_s"] = round(max(ts) - min(ts), 3)

    rounds = [e for e in events if e.get("type") == "round"]
    # multihost rank streams: every rank emits its own round events; a
    # merged view must count each round once.  The server's stream is
    # canonical when present, else the lowest-ranked client's.
    roles = {str(e.get("role")) for e in rounds if e.get("role")}
    if roles:
        if "server" in roles:
            rounds = [e for e in rounds if e.get("role") == "server"]
        else:
            ranks = sorted(int(e.get("rank", 0)) for e in rounds
                           if e.get("rank") is not None)
            if ranks:
                rounds = [e for e in rounds
                          if int(e.get("rank", 0)) == ranks[0]]
    if rounds:
        per = [e["per_round_s"] for e in rounds
               if isinstance(e.get("per_round_s"), (int, float))]
        # two event shapes coexist: legacy = one event per device program
        # (chunk) carrying `rounds`=size; current = one event per LOGICAL
        # round carrying `round` + `rounds_per_program`, where the chunk
        # head has round == first.  total_rounds and chunks therefore
        # come out invariant to --rounds-per-program for both shapes.
        heads = [e for e in rounds
                 if "round" not in e or e.get("round") == e.get("first")]
        out["rounds"] = {
            "chunks": len(heads),
            "total_rounds": sum(int(e.get("rounds", 1)) for e in rounds),
            "per_round_s_mean": round(sum(per) / len(per), 4) if per else None,
            "per_round_s_max": round(max(per), 4) if per else None,
        }
        rpp = [int(e["rounds_per_program"]) for e in rounds
               if isinstance(e.get("rounds_per_program"), int)]
        if rpp:
            out["rounds"]["rounds_per_program_max"] = max(rpp)

    cohorts = [e for e in events if e.get("type") == "cohort"]
    if cohorts:
        # one cohort event per LOGICAL round (chunk heads have
        # round == first), so every figure here is invariant to
        # --rounds-per-program, like the rounds section above
        pops = [int(e["population"]) for e in cohorts
                if isinstance(e.get("population"), int)]
        sizes = [int(e["cohort"]) for e in cohorts
                 if isinstance(e.get("cohort"), int)]
        sampled: set = set()
        for e in cohorts:
            sampled.update(int(c) for c in e.get("clients", []) or [])
        stale_hist: Dict[str, int] = {}
        for e in cohorts:
            for s_key, n in (e.get("staleness") or {}).items():
                stale_hist[str(s_key)] = max(stale_hist.get(str(s_key), 0),
                                             int(n))
        applied = [int(e["buffered_applied"]) for e in cohorts
                   if isinstance(e.get("buffered_applied"), int)]
        out["federation_scale"] = {
            "rounds": len(cohorts),
            "population": max(pops) if pops else None,
            "cohort_size": max(sizes) if sizes else None,
            "distinct_clients_sampled": len(sampled),
            "buffered_updates_applied": max(applied) if applied else 0,
            "staleness_histogram": dict(sorted(stale_hist.items())),
        }

    alarms = [e for e in events if e.get("type") == "watchdog_alarm"]
    rollbacks = [e for e in events if e.get("type") == "watchdog_rollback"]
    if alarms or rollbacks:
        out["watchdog"] = {
            "alarms": len(alarms),
            "rollbacks": len(rollbacks),
            "reasons": sorted({str(e.get("reason", "?")) for e in alarms}),
        }

    quarantines = [e for e in events if e.get("type") == "quarantine"]
    drops = [e for e in events if e.get("type") == "client_dropped"]
    if quarantines or drops:
        out["robustness"] = {
            "quarantine_events": len(quarantines),
            "clients_dropped": sorted({e.get("client") for e in drops
                                       if e.get("client") is not None}),
        }

    contribs = [e for e in events if e.get("type") == "client_contribution"]
    joins = [e for e in events if e.get("type") == "client_joined"]
    lefts = [e for e in events if e.get("type") == "client_left"]
    drift_als = [e for e in events if e.get("type") == "drift_alarm"]
    if contribs or joins or lefts or drift_als:
        out["clients"] = _clients_section(contribs, quarantines,
                                          alarms, rollbacks, drops,
                                          joins=joins, lefts=lefts,
                                          drift_alarms=drift_als)

    drift_ws = [e for e in events if e.get("type") == "drift_window"]
    if drift_ws:
        rises_j = [float(e["max_jsd_rise"]) for e in drift_ws
                   if isinstance(e.get("max_jsd_rise"), (int, float))]
        rises_w = [float(e["max_wd_rise"]) for e in drift_ws
                   if isinstance(e.get("max_wd_rise"), (int, float))]
        last = drift_ws[-1]
        out["drift"] = {
            "windows": len(drift_ws),
            "alarms_total": sum(int(e.get("alarms", 0) or 0)
                                for e in drift_ws),
            "evicted": sorted({int(c) for e in drift_ws
                               for c in (e.get("evicted") or [])}),
            "max_jsd_rise": round(max(rises_j), 6) if rises_j else None,
            "max_wd_rise": round(max(rises_w), 6) if rises_w else None,
            "final_live": last.get("live"),
            "final_population": last.get("population"),
        }

    sims = [e for e in events if e.get("type") == "similarity"]
    if sims:
        out["similarity"] = _similarity_section(sims)

    flaps = [e for e in events
             if e.get("type") in ("transport_reconnect", "transport_drop",
                                  "heartbeat_lapse")]
    if flaps:
        out["transport"] = {
            "reconnects": by_type.get("transport_reconnect", 0),
            "drops": by_type.get("transport_drop", 0),
            "heartbeat_lapses": by_type.get("heartbeat_lapse", 0),
        }

    compiles = [e for e in events if e.get("type") == "compile"]
    if compiles:
        per_prog: Dict[str, int] = {}
        for e in compiles:
            p = str(e.get("program", "?"))
            per_prog[p] = per_prog.get(p, 0) + 1
        out["compiles"] = dict(sorted(per_prog.items()))

    ckpts = [e for e in events if e.get("type") == "checkpoint"]
    if ckpts:
        out["checkpoints"] = {
            "saved": len(ckpts),
            "last_path": ckpts[-1].get("path"),
            "restores": by_type.get("checkpoint_restore", 0),
        }

    serve_evs = [e for e in events
                 if e.get("type") in ("serve_reload", "fleet_load",
                                      "fleet_evict", "tenant_shed")]
    if serve_evs:
        sheds = [e for e in serve_evs if e.get("type") == "tenant_shed"]
        shed_by_tenant: Dict[str, int] = {}
        for e in sheds:
            t = str(e.get("tenant", "?"))
            shed_by_tenant[t] = shed_by_tenant.get(t, 0) + int(
                e.get("count", 1))
        out["serving"] = {
            "reloads": by_type.get("serve_reload", 0),
            "fleet_loads": by_type.get("fleet_load", 0),
            "fleet_evicts": by_type.get("fleet_evict", 0),
            "tenants_loaded": sorted({str(e.get("tenant")) for e in serve_evs
                                      if e.get("type") == "fleet_load"
                                      and e.get("tenant") is not None}),
            "shed_by_tenant": dict(sorted(shed_by_tenant.items())),
        }

    promos = [e for e in events
              if e.get("type") in ("promotion_promoted",
                                   "promotion_rejected")]
    fails = by_type.get("serve_reload_failed", 0)
    if promos or fails:
        per_tenant: Dict[str, dict] = {}
        for e in promos:
            t = str(e.get("tenant", "?"))
            d = per_tenant.setdefault(t, {"promotions": 0, "rejections": 0})
            if e.get("type") == "promotion_promoted":
                d["promotions"] += 1
            else:
                d["rejections"] += 1
            if isinstance(e.get("avg_jsd"), (int, float)):
                d["avg_jsd_last"] = round(float(e["avg_jsd"]), 6)
            if isinstance(e.get("avg_wd"), (int, float)):
                d["avg_wd_last"] = round(float(e["avg_wd"]), 6)
        rejects = [e for e in promos
                   if e.get("type") == "promotion_rejected"]
        tripped = sorted({str(t) for e in rejects
                          for t in (e.get("tripped") or [])})
        out["quality"] = {
            "promotions": by_type.get("promotion_promoted", 0),
            "rejections": by_type.get("promotion_rejected", 0),
            "reload_failures": fails,
            "per_tenant": dict(sorted(per_tenant.items())),
            "tripped_budgets": tripped,
            "last_rejection": rejects[-1] if rejects else None,
        }

    costs = [e for e in events if e.get("type") == "program_cost"]
    traces = [e for e in events if e.get("type") == "device_trace"]
    if costs or traces:
        # last program_cost event per program wins (re-ledgering a
        # program supersedes the earlier figures)
        per_cost: Dict[str, dict] = {}
        for e in costs:
            name = str(e.get("name", "?"))
            per_cost[name] = {
                "family": e.get("family", ""),
                "flops": e.get("flops", 0),
                "bytes_accessed": e.get("bytes_accessed", 0),
                "peak_bytes": e.get("peak_bytes", 0),
                "donated_bytes": e.get("donated_bytes", 0),
                "compiles": e.get("compiles", 0),
            }
        out["programs"] = {
            "ledgered": len(per_cost),
            "total_flops": sum(float(c["flops"] or 0)
                               for c in per_cost.values()),
            "peak_bytes_max": max(
                (int(c["peak_bytes"] or 0) for c in per_cost.values()),
                default=0),
            "per_program": dict(sorted(per_cost.items())),
            # the profiling satellite: device_trace outcomes belong to
            # the program view -- the trace dir is where the per-program
            # device timelines actually live
            "device_traces": [
                {"dir": e.get("dir"), "ok": bool(e.get("ok", False)),
                 "error": e.get("error")}
                for e in traces
            ],
        }

    inits = [e for e in events if e.get("type") == "init_phase"]
    if inits:
        per_phase: Dict[str, dict] = {}
        for e in inits:
            phase = str(e.get("phase", "?"))
            d = per_phase.setdefault(phase, {"seconds": 0.0, "count": 0,
                                             "clients": 0, "rows": 0})
            d["seconds"] += float(e.get("seconds", 0) or 0)
            d["count"] += 1
            # onboarding throughput: events carry the client/row volume
            # that phase processed (max across events — repeated phases in
            # one journal re-onboard the same population)
            d["clients"] = max(d["clients"], int(e.get("clients", 0) or 0))
            d["rows"] = max(d["rows"], int(e.get("rows", 0) or 0))
        for d in per_phase.values():
            d["seconds"] = round(d["seconds"], 3)
            if d["seconds"] > 0:
                if d["clients"]:
                    d["clients_per_s"] = round(d["clients"] / d["seconds"], 1)
                if d["rows"]:
                    d["rows_per_s"] = round(d["rows"] / d["seconds"])
        out["init"] = {
            "total_seconds": round(sum(d["seconds"]
                                       for d in per_phase.values()), 3),
            "phases": dict(sorted(per_phase.items(),
                                  key=lambda kv: -kv[1]["seconds"])),
        }

    cache_evs = [e for e in events if e.get("type") == "init_cache"]
    if cache_evs:
        by_op: Dict[str, int] = {}
        for e in cache_evs:
            key = f"{e.get('op', '?')}_{e.get('scope', '?')}"
            by_op[key] = by_op.get(key, 0) + int(e.get("count", 1) or 1)
        hits = sum(n for k, n in by_op.items() if k.startswith("hit"))
        misses = sum(n for k, n in by_op.items() if k.startswith("miss"))
        out["init_cache"] = {
            "by_op": dict(sorted(by_op.items())),
            "hits": hits,
            "misses": misses,
            "corrupt": sum(n for k, n in by_op.items()
                           if k.startswith("corrupt")),
            "hit_rate": (round(hits / (hits + misses), 3)
                         if hits + misses else None),
            "roots": sorted({str(e.get("root")) for e in cache_evs
                             if e.get("root")}),
        }

    stage_evs = [e for e in events if e.get("type") == "serve_stages"]
    if stage_evs:
        per_stage: Dict[str, dict] = {}
        for e in stage_evs:
            for stage, st in (e.get("stages") or {}).items():
                if not isinstance(st, dict):
                    continue
                d = per_stage.setdefault(
                    str(stage), {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0})
                d["count"] += int(st.get("count", 0) or 0)
                # worst window observed -- the operator wants the spikes
                d["p50_ms"] = max(d["p50_ms"], float(st.get("p50_ms", 0) or 0))
                d["p99_ms"] = max(d["p99_ms"], float(st.get("p99_ms", 0) or 0))
        out["serve_stages"] = dict(sorted(per_stage.items()))

    probes = [e for e in events if e.get("type") == "backend_probe"]
    if probes:
        out["backend_probes"] = {
            "total": len(probes),
            "failed": sum(1 for e in probes if not e.get("ok", False)),
        }
    return out


def render_text(summary: dict) -> str:
    lines: List[str] = [
        f"journal: {summary['path']}",
        f"  run_id={summary.get('run_id')} schema={summary.get('schema')} "
        f"events={summary['events']} duration_s={summary.get('duration_s')}",
        "  events by type:",
    ]
    for t, n in summary.get("by_type", {}).items():
        lines.append(f"    {n:6d}  {t}")
    r = summary.get("rounds")
    if r:
        rpp = r.get("rounds_per_program_max")
        lines.append(f"  rounds: {r['total_rounds']} in {r['chunks']} "
                     f"chunk(s), per-round mean {r['per_round_s_mean']}s "
                     f"max {r['per_round_s_max']}s"
                     + (f", up to {rpp} round(s)/program" if rpp else ""))
    fs = summary.get("federation_scale")
    if fs:
        lines.append(f"  federation scale: population {fs['population']}, "
                     f"cohort {fs['cohort_size']}/round over {fs['rounds']} "
                     f"round(s), {fs['distinct_clients_sampled']} distinct "
                     f"client(s) sampled, "
                     f"{fs['buffered_updates_applied']} buffered update(s) "
                     f"applied"
                     + (f", staleness {fs['staleness_histogram']}"
                        if fs["staleness_histogram"] else ""))
    w = summary.get("watchdog")
    if w:
        lines.append(f"  watchdog: {w['alarms']} alarm(s), "
                     f"{w['rollbacks']} rollback(s) "
                     f"reasons={w['reasons']}")
    rb = summary.get("robustness")
    if rb:
        lines.append(f"  robustness: {rb['quarantine_events']} quarantine "
                     f"event(s), dropped clients {rb['clients_dropped']}")
    cl = summary.get("clients")
    if cl:
        mem = cl.get("membership")
        churn = ""
        if mem:
            churn = (f"; membership: {mem['joins']} join(s) "
                     f"({mem['join_repacks']} repack(s)), "
                     f"{mem['leaves']} departure(s), "
                     f"{mem['drift_alarms']} drift alarm(s)")
        lines.append(f"  clients: {cl['tracked']} tracked over "
                     f"{cl['rounds']} round(s){churn}")
        for c, d in cl.get("per_client", {}).items():
            wf, wl = d.get("weight_first"), d.get("weight_last")
            traj = (f"weight {wf:.4f}->{wl:.4f}"
                    if wf is not None and wl is not None else "weight n/a")
            extra = ""
            if d.get("joined_round") is not None:
                extra += (f", joined@{d['joined_round']}"
                          + (" (repack)" if d.get("join_repacked") else ""))
            if d.get("drift_alarms"):
                extra += f", {d['drift_alarms']} drift alarm(s)"
            if d.get("quarantined_rounds"):
                extra += (f", {d['quarantined_rounds']} quarantined "
                          f"round(s), {d['strikes']} strike(s)")
            if d.get("left"):
                left = d["left"]
                extra += (f" [LEFT ({left})]" if isinstance(left, str)
                          else " [LEFT]")
            elif d.get("dropped"):
                extra += " [DROPPED]"
            lines.append(f"    client {c}: {traj}, "
                         f"{d['rounds']} round(s){extra}")
        if cl.get("top_movers"):
            movers = ", ".join(f"client {c} {delta:+.4f}"
                               for c, delta in cl["top_movers"])
            lines.append(f"    top movers: {movers}")
        for f in cl.get("forensics", []):
            tail = ""
            if f.get("watchdog"):
                tail += f" -> watchdog {f['watchdog']}"
            if f.get("dropped"):
                tail += f" -> dropped ({f['dropped']})"
            lines.append(
                f"    forensics: client {f['client']} quarantined rounds "
                f"{f.get('first')}..{f.get('last')} "
                f"(test={f.get('test')}, strikes={f.get('strikes')}){tail}")
    dr = summary.get("drift")
    if dr:
        lines.append(f"  drift: {dr['alarms_total']} alarm(s) over "
                     f"{dr['windows']} window(s), max jsd rise "
                     f"{dr.get('max_jsd_rise')}, max wd rise "
                     f"{dr.get('max_wd_rise')}, "
                     f"{dr['final_live']}/{dr['final_population']} live at "
                     f"the last window"
                     + (f", evicted {dr['evicted']}" if dr["evicted"]
                        else ""))
    sim = summary.get("similarity")
    if sim and sim.get("avg_jsd_last") is not None:
        wd = (f" avg_wd {sim['avg_wd_last']}"
              if sim.get("avg_wd_last") is not None else "")
        lines.append(f"  similarity: {sim['samples']} sample(s), epochs "
                     f"{sim.get('first_epoch')}..{sim.get('last_epoch')}, "
                     f"avg_jsd last {sim['avg_jsd_last']} "
                     f"(best {sim['avg_jsd_best']}){wd}")
        if sim.get("worst_columns"):
            worst = ", ".join(f"{k}={v}" for k, v in sim["worst_columns"])
            lines.append(f"    worst columns (jsd): {worst}")
    tr = summary.get("transport")
    if tr:
        lines.append(f"  transport: {tr['reconnects']} reconnect(s), "
                     f"{tr['drops']} drop(s), "
                     f"{tr['heartbeat_lapses']} heartbeat lapse(s)")
    c = summary.get("compiles")
    if c:
        lines.append(f"  compiles: {sum(c.values())} event(s) across "
                     f"{len(c)} program(s)")
    ck = summary.get("checkpoints")
    if ck:
        lines.append(f"  checkpoints: {ck['saved']} saved, "
                     f"{ck['restores']} restore(s), last {ck['last_path']}")
    sv = summary.get("serving")
    if sv:
        lines.append(f"  serving: {sv['reloads']} hot reload(s), "
                     f"{sv['fleet_loads']} tenant load(s), "
                     f"{sv['fleet_evicts']} evict(s)"
                     + (f", shed by tenant {sv['shed_by_tenant']}"
                        if sv["shed_by_tenant"] else ""))
    q = summary.get("quality")
    if q:
        lines.append(f"  quality: {q['promotions']} promotion(s), "
                     f"{q['rejections']} rejection(s), "
                     f"{q['reload_failures']} reload failure(s)"
                     + (f", tripped {q['tripped_budgets']}"
                        if q["tripped_budgets"] else ""))
        for t, d in q.get("per_tenant", {}).items():
            scores = ""
            if d.get("avg_jsd_last") is not None:
                scores = (f"  avg_jsd {d['avg_jsd_last']} "
                          f"avg_wd {d.get('avg_wd_last')}")
            lines.append(f"    tenant {t}: {d['promotions']} promoted, "
                         f"{d['rejections']} rejected{scores}")
        lr = q.get("last_rejection")
        if lr:
            worst = sorted(
                ((c, v) for c, v in (lr.get("per_column") or {}).items()
                 if isinstance(v, dict)
                 and isinstance(v.get("delta"), (int, float))),
                key=lambda kv: (-abs(kv[1]["delta"]), kv[0]))[:3]
            cols = ", ".join(f"{c} {v['delta']:+.4f}" for c, v in worst)
            lines.append(f"    last rejection: candidate "
                         f"{lr.get('candidate')} tripped "
                         f"{lr.get('tripped')}"
                         + (f"; worst columns: {cols}" if cols else ""))
    pg = summary.get("programs")
    if pg:
        lines.append(f"  programs: {pg['ledgered']} ledgered, "
                     f"{pg['total_flops'] / 1e6:.2f} Mflops total, "
                     f"peak {pg['peak_bytes_max'] / 1e6:.2f} MB")
        for name, c in pg.get("per_program", {}).items():
            lines.append(
                f"    {name:<38} {float(c['flops'] or 0) / 1e6:>9.2f} Mflop "
                f"{float(c['bytes_accessed'] or 0) / 1e6:>9.2f} MB acc "
                f"{int(c['peak_bytes'] or 0) / 1e6:>7.2f} MB peak "
                f"x{c['compiles']}")
        for t in pg.get("device_traces", []):
            status = "ok" if t["ok"] else f"FAILED ({t.get('error')})"
            lines.append(f"    device trace: {t.get('dir')} [{status}]")
    ini = summary.get("init")
    if ini:
        lines.append(f"  init: {ini['total_seconds']}s across "
                     f"{len(ini['phases'])} phase(s)")
        for phase, d in ini["phases"].items():
            rate = ""
            if d.get("clients_per_s") is not None:
                rate += f" {d['clients_per_s']:>8.1f} clients/s"
            if d.get("rows_per_s") is not None:
                rate += f" {d['rows_per_s']:>8d} rows/s"
            lines.append(f"    {phase:<32} {d['seconds']:>9.3f}s "
                         f"x{d['count']}{rate}")
    ic = summary.get("init_cache")
    if ic:
        rate = (f", hit rate {ic['hit_rate']:.1%}"
                if ic.get("hit_rate") is not None else "")
        corrupt = (f", {ic['corrupt']} CORRUPT entry(ies) refit"
                   if ic.get("corrupt") else "")
        lines.append(f"  init cache: {ic['hits']} hit(s), "
                     f"{ic['misses']} miss(es){rate}{corrupt}")
        for k, n in ic.get("by_op", {}).items():
            lines.append(f"    {k:<32} {n:>9d}")
    ss = summary.get("serve_stages")
    if ss:
        lines.append("  serving stages (worst window):")
        for stage, d in ss.items():
            lines.append(f"    {stage:<12} p50 {d['p50_ms']:>8.2f} ms  "
                         f"p99 {d['p99_ms']:>8.2f} ms  n={d['count']}")
    bp = summary.get("backend_probes")
    if bp:
        lines.append(f"  backend probes: {bp['total']} "
                     f"({bp['failed']} failed)")
    return "\n".join(lines)


def report_main(path: Union[str, Sequence[str]], fmt: str = "text") -> int:
    paths = [path] if isinstance(path, str) else list(path)

    def warn(msg: str) -> None:
        print(f"obs report: warning: {msg}", file=sys.stderr)

    try:
        summary = summarize_many(paths, on_skip=warn)
    except OSError as exc:
        print(f"obs report: cannot read {paths}: {exc}")
        return 2
    if fmt == "json":
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(render_text(summary))
    return 0
