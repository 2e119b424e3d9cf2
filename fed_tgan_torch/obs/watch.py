"""Live federation view: ``python -m fed_tgan_torch.obs watch``
(counterpart of ``fed_tgan_tpu/obs/watch.py:40-290``).

Tails one or more run journals (files) or polls a training process's
telemetry exporter (``http://host:port``) and renders a rolling status
line -- rounds/s, losses, similarity, quarantine/rollback events -- plus
an in-run SLO alarm: every ``--slo-every`` newly observed rounds the
budget rules are re-evaluated over the events seen so far
(:func:`fed_tgan_torch.obs.slo.check_figures`), and a regression both
prints an ALERT line and lands a ``slo_breach`` event in the journal,
turning the post-hoc gate into something that fires while the run can
still be stopped.

Multiple journals merge into one federation view keyed by round (the
per-rank streams of a multihost run); a URL source reads the exporter's
``/journal?offset=N`` incremental endpoint.  Pure stdlib -- never
imports torch or numpy.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request
from typing import List, Optional

from fed_tgan_torch.obs.slo import (
    check_figures,
    default_budgets_path,
    journal_figures,
    load_budgets,
)

__all__ = ["watch_main"]

_NOTABLE = ("quarantine", "client_dropped", "watchdog_alarm",
            "watchdog_rollback", "slo_breach", "checkpoint_restore")


def _warn(msg: str) -> None:
    print(f"obs watch: warning: {msg}", file=sys.stderr)


class _FileSource:
    """Incremental reader over one journal file; crash-tolerant.

    Only complete (newline-terminated) lines are parsed; a torn tail is
    carried until the writer finishes it -- or warned about once the
    stream ends with it still torn.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._offset = 0
        self._buf = ""

    def poll(self) -> List[dict]:
        events: List[dict] = []
        try:
            with open(self.path, "r") as fh:
                fh.seek(self._offset)
                chunk = fh.read()
                self._offset = fh.tell()
        except OSError as exc:
            _warn(f"cannot read {self.path}: {exc}")
            return events
        self._buf += chunk
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                _warn(f"{self.path}: skipping truncated journal line "
                      f"({len(line)} bytes)")
                continue
            if isinstance(ev, dict):
                events.append(ev)
        return events

    def finish(self) -> None:
        """End of watching: a still-buffered torn tail gets its warning
        (a crashed writer never terminates the line; follow mode would
        otherwise swallow it silently)."""
        if self._buf.strip():
            _warn(f"{self.path}: skipping truncated journal line "
                  f"({len(self._buf.strip())} bytes)")
            self._buf = ""


class _UrlSource:
    """Incremental reader over an exporter's ``/journal?offset=N``."""

    def __init__(self, url: str, timeout: float = 5.0) -> None:
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._offset = 0
        self._buf = ""

    def poll(self) -> List[dict]:
        events: List[dict] = []
        req = f"{self.url}/journal?offset={self._offset}"
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = resp.read().decode("utf-8", errors="replace")
                nxt = resp.headers.get("X-Journal-Offset")
                self._offset = (int(nxt) if nxt is not None
                                else self._offset + len(body))
        except (OSError, ValueError) as exc:
            _warn(f"cannot poll {req}: {exc}")
            return events
        self._buf += body
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                _warn(f"{req}: skipping truncated journal line")
                continue
            if isinstance(ev, dict):
                events.append(ev)
        return events

    def finish(self) -> None:
        if self._buf.strip():
            _warn(f"{self.url}/journal: skipping truncated journal line "
                  f"({len(self._buf.strip())} bytes)")
            self._buf = ""


class _WatchState:
    """Rolling fold of the merged event stream into one status line."""

    def __init__(self) -> None:
        self.events: List[dict] = []
        self.rounds_seen: set = set()
        self.last_round: Optional[int] = None
        self.per_round_s: Optional[float] = None
        self.loss_d: Optional[float] = None
        self.loss_g: Optional[float] = None
        self.avg_jsd: Optional[float] = None
        self.quarantines = 0
        self.drops = 0
        self.alarms = 0
        self.rollbacks = 0
        self.breaches = 0

    def fold(self, ev: dict) -> Optional[str]:
        """Update state; returns a printable line for notable events."""
        self.events.append(ev)
        kind = ev.get("type")
        if kind == "round":
            rnd = ev.get("round", ev.get("last", ev.get("first")))
            if isinstance(rnd, int):
                self.rounds_seen.add((ev.get("rank"), rnd))
                self.last_round = max(self.last_round or 0, rnd)
            if isinstance(ev.get("per_round_s"), (int, float)):
                self.per_round_s = float(ev["per_round_s"])
        elif kind == "client_contribution":
            for key, attr in (("loss_d", "loss_d"), ("loss_g", "loss_g")):
                vals = [v for v in (ev.get(key) or [])
                        if isinstance(v, (int, float))]
                if vals:
                    setattr(self, attr, sum(vals) / len(vals))
        elif kind == "similarity":
            if isinstance(ev.get("avg_jsd"), (int, float)):
                self.avg_jsd = float(ev["avg_jsd"])
        elif kind == "quarantine":
            self.quarantines += 1
        elif kind == "client_dropped":
            self.drops += 1
        elif kind == "watchdog_alarm":
            self.alarms += 1
        elif kind == "watchdog_rollback":
            self.rollbacks += 1
        elif kind == "slo_breach":
            self.breaches += 1
        if kind in _NOTABLE:
            detail = {k: v for k, v in ev.items()
                      if k not in ("ts", "type")}
            return f"[event] {kind} {json.dumps(detail, default=str)}"
        return None

    @property
    def n_rounds(self) -> int:
        return len({r for _, r in self.rounds_seen})

    def status(self) -> str:
        rps = (f"{1.0 / self.per_round_s:.2f} r/s"
               if self.per_round_s else "- r/s")

        def num(v, fmt="{:.4f}"):
            return fmt.format(v) if v is not None else "-"

        slo = "BREACH" if self.breaches else "ok"
        return (f"[watch] round {num(self.last_round, '{}')} "
                f"({self.n_rounds} seen) | {rps} | "
                f"loss_d {num(self.loss_d)} loss_g {num(self.loss_g)} | "
                f"jsd {num(self.avg_jsd)} | "
                f"quar {self.quarantines} drop {self.drops} "
                f"alarm {self.alarms} rollback {self.rollbacks} | "
                f"slo {slo}")


def _emit_breach(path: Optional[str], **fields) -> None:
    """Append a ``slo_breach`` event to the watched journal (file mode).

    Whole-line appends to the same JSONL the trainer writes; readers are
    torn-line tolerant, so a racing append can at worst cost one warning.
    """
    if path is None:
        return
    event = {"ts": round(time.time(), 6), "type": "slo_breach"}
    event.update(fields)
    try:
        with open(path, "a") as fh:
            fh.write(json.dumps(event, default=str) + "\n")
    except OSError as exc:
        _warn(f"cannot append slo_breach to {path}: {exc}")


def watch_main(args) -> int:
    """Entry for ``obs watch`` (argparse namespace: ``source`` list,
    ``follow``, ``interval``, ``slo_every``, ``budgets``,
    ``max_seconds``).  Exit 0 clean, 1 if any SLO breach was observed,
    2 on unusable budgets."""
    sources: List[object] = []
    breach_sink: Optional[str] = None
    for src in args.source:
        if src.startswith("http://") or src.startswith("https://"):
            sources.append(_UrlSource(src))
        else:
            sources.append(_FileSource(src))
            if breach_sink is None:
                breach_sink = src
    try:
        rules = load_budgets(args.budgets or default_budgets_path())
    except Exception as exc:  # noqa: BLE001 -- malformed budgets: exit 2
        print(f"obs watch: {exc}")
        return 2

    state = _WatchState()
    deadline = (time.time() + args.max_seconds
                if args.max_seconds else None)
    slo_every = max(1, int(args.slo_every))
    next_slo_at = slo_every
    last_status = ""
    while True:
        fresh: List[dict] = []
        for s in sources:
            fresh.extend(s.poll())
        for ev in fresh:
            line = state.fold(ev)
            if line:
                print(line)
        if state.n_rounds >= next_slo_at:
            next_slo_at = state.n_rounds + slo_every
            figures = journal_figures(state.events)
            regressions, _stale, matched, lines = check_figures(
                figures, rules, where=f"live@round{state.last_round}")
            if regressions:
                state.breaches += 1
                breaching = [ln for ln in lines
                             if ln.startswith("REGRESSION")]
                for ln in breaching:
                    print(f"ALERT {ln}")
                _emit_breach(breach_sink, round=state.last_round,
                             regressions=regressions, matched=matched,
                             rules=[ln.split()[1].rstrip(":")
                                    for ln in breaching])
        if fresh:
            status = state.status()
            if status != last_status:
                print(status)
                last_status = status
        if not args.follow:
            break
        if deadline is not None and time.time() >= deadline:
            break
        time.sleep(max(0.05, float(args.interval)))
    for s in sources:
        s.finish()
    if not last_status:
        print(state.status())
    return 1 if state.breaches else 0
