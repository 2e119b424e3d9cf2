"""Durable run journal: one JSONL event stream per run
(counterpart of ``fed_tgan_tpu/obs/journal.py:129-330``).

Every line is one event::

    {"ts": <unix seconds>, "type": "<event type>", ...fields}

The first line of a journal is always a ``run_start`` event carrying
``schema`` (the journal schema version) and ``run_id``.  Consumers --
``python -m fed_tgan_torch.obs report``, soak analysis, dashboards --
key off ``type``; unknown types must be ignored, unknown fields
preserved (the schema is append-only: fields are added, never renamed).

``EVENT_TYPES`` is derived from ``schema.json`` beside this module, a
copy of the JAX package's telemetry contract registry (per-event
required/optional/external fields and producers, which name the JAX
modules); ``tests/test_torch_obs.py`` holds the two copies equal, but
for ``backend_probe`` and ``backend_plugin_registered``, whose fields
the port's copy lists as ``external``: the port emits neither (PJRT has
no counterpart here).  It emits every other event at its counterparts
of those producers; ``compile`` comes from the sanitizers' build counter
(``--sanitize``).

Event catalogue (``EVENT_TYPES``):

========================  ====================================================
type                      emitted by / meaning
========================  ====================================================
run_start / run_end       journal lifecycle (run_end carries ``seconds``)
round                     trainer round-chunk summary (first/last/seconds/...)
aggregate                 aggregation summary for a chunk (aggregator, clients)
cohort                    per-round partial-participation summary (population,
                          sampled client ids, staleness histogram, buffered
                          update counts)
quarantine                in-round update screen quarantined a client
                          (``test="drift"`` when charged by the elastic
                          drift detector instead of the in-graph gate)
client_dropped            dead/evicted client removed from federation
client_joined             elastic federation admitted a newcomer between
                          rounds (round, population, capacity, weight,
                          rows, whether admission forced a bucket repack)
client_left               elastic federation departure (scripted or
                          drift-evicted) before the dropout-path
                          ``client_dropped`` that executes it
drift_alarm               per-window drift probe flagged a client (raw
                          JSD/WD rises vs its onboarding baseline)
drift_window              one detection-window summary: population, scored
                          clients, alarm count, sustained/evicted lists,
                          max score rises, refit lag -- the drift
                          trajectory artifact row
watchdog_alarm            training-health watchdog tripped
watchdog_rollback         watchdog restored params from a checkpoint
checkpoint                crash-safe checkpoint published
checkpoint_restore        checkpoint loaded for resume/rollback
transport_reconnect       transport peer re-established after a drop
transport_drop            server marked a peer dead
heartbeat_lapse           liveness deadline exceeded for a peer
compile                   a cached build (kernel library, device tables,
                          launch plan, lane group), from the sanitizers'
                          build counter
backend_probe             subprocess backend-responsiveness probe outcome
backend_plugin_registered PJRT plugin backend registered with the runtime
                          (plugin name, shared-library path)
device_trace              runtime/profiling device trace start/stop/failure
serve_reload              serving hot-reloaded a model artifact
serve_reload_failed       a new checkpoint generation failed to load (torn
                          write / bad decode artifacts); the previous model
                          keeps serving and the generation is not retried
promotion_promoted        canary gate promoted a candidate model (scores,
                          deltas vs the incumbent baseline, model ids)
promotion_rejected        canary gate auto-rejected a candidate: forensics
                          event carrying per-column deltas, the tripped
                          quality budgets, and both model ids
fleet_load                fleet admin loaded a tenant model
fleet_evict               fleet admin evicted a tenant model
tenant_shed               per-tenant admission shed requests (rate-limited
                          summary event carrying counts, never per-request)
program_cost              compiled-program cost ledger entry (flops, bytes
                          accessed, peak/argument/output/temp bytes)
init_phase                federated onboarding phase finished (phase name,
                          seconds, client count, rows)
init_cache                encoded-shard cache outcome summary (op = hit |
                          miss | store | corrupt, scope = client | global,
                          count)
serve_stages              per-stage serving latency summary (rate-limited:
                          stage means/counts since the last event)
client_contribution       per-round per-client ledger (parallel arrays keyed
                          by global client id: weights, losses, quarantine
                          mask, strikes) from the one gated metrics pull
similarity                monitor probe sample (epoch, avg_jsd, avg_wd and,
                          when available, per-column values)
slo_breach                live SLO re-evaluation flagged a budget regression
                          (rule name, figure, bound) -- emitted by obs watch
schema_violation          the runtime schema sanitizer (``validate=True``)
                          saw an emit that breaks the registry contract
                          (offending event type, problem, field); emitted
                          once per distinct violation, never raised
========================  ====================================================

Writers go through a process-wide current journal: ``set_journal``
installs one, module-level :func:`emit` is a cheap no-op while none is
installed, so library code can emit unconditionally.  ``RunJournal``
itself is thread-safe and flushes every line (durability over
throughput -- journals are low-rate by design; the hot path emits at
round granularity, never per-step).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Dict, Iterator, List, Optional

__all__ = [
    "SCHEMA_VERSION",
    "EVENT_TYPES",
    "RunJournal",
    "emit",
    "get_journal",
    "read_journal",
    "set_journal",
    "validation_violations",
]

SCHEMA_VERSION = 1

SCHEMA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "schema.json")

# journals must keep working from a tree without the registry (sdist
# subsets, very old checkouts): a missing/corrupt schema.json leaves
# EVENT_TYPES empty and the runtime sanitizer disarmed.
def _load_event_schemas() -> Dict[str, dict]:
    try:
        with open(SCHEMA_PATH) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return {}
    events = doc.get("events") if isinstance(doc, dict) else None
    if not isinstance(events, dict):
        return {}
    return {name: spec for name, spec in events.items()
            if isinstance(spec, dict)}


_EVENT_SCHEMAS = _load_event_schemas()
EVENT_TYPES = frozenset(_EVENT_SCHEMAS)

_VALIDATE_ENV = "FED_TGAN_TORCH_VALIDATE_JOURNAL"
_BASE_FIELDS = frozenset({"ts", "type"})

# violations seen by env-armed journals (the tier-1 arming path);
# the test session gate asserts this stays empty across the suite
_VALIDATION_VIOLATIONS: List[dict] = []


def validation_violations() -> List[dict]:
    """Schema violations recorded by env-armed journals this process."""
    return list(_VALIDATION_VIOLATIONS)


class RunJournal:
    """Append-only JSONL event writer for one run.

    ``emit()`` never raises into the instrumented caller: a journal
    that loses its disk must not take the training run down with it.

    ``validate`` arms the runtime schema sanitizer: every emit is
    checked against the ``obs/schema.json`` contract (unknown type,
    missing required field, unlisted field on a closed event) and each
    distinct violation journals one ``schema_violation`` event, bumps
    ``self.schema_violations`` and the
    ``fed_tgan_journal_schema_violations_total`` counter -- it never
    raises.  ``validate=None`` (the default) arms from the
    ``FED_TGAN_TORCH_VALIDATE_JOURNAL`` env var (how ``chip_smoke.py``
    and the CPU tests run) and additionally tallies into the process-wide
    :func:`validation_violations` list the test session gate asserts
    empty.
    """

    def __init__(self, path: str, run_id: Optional[str] = None,
                 validate: Optional[bool] = None) -> None:
        self.path = str(path)
        self.run_id = run_id or uuid.uuid4().hex[:12]
        directory = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(directory, exist_ok=True)
        if validate is None:
            env = os.environ.get(_VALIDATE_ENV, "")
            validate = env.lower() not in ("", "0", "false", "no")
            self._tally_global = validate
        else:
            self._tally_global = False
        self.validate = bool(validate) and bool(_EVENT_SCHEMAS)
        self.schema_violations = 0
        self._violation_keys: set = set()
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._closed = False
        self.emit("run_start", schema=SCHEMA_VERSION, run_id=self.run_id,
                  pid=os.getpid())

    def _check_schema(self, type: str, fields: dict) -> List[tuple]:
        """``(problem, field)`` pairs for one emit; [] when clean."""
        spec = _EVENT_SCHEMAS.get(type)
        if spec is None:
            return [("unknown_type", None)]
        problems = []
        for req in spec.get("required", ()):
            if req not in fields:
                problems.append(("missing_field", req))
        if not spec.get("open", False):
            known = (set(spec.get("required", ()))
                     | set(spec.get("optional", ()))
                     | set(spec.get("external", ())) | _BASE_FIELDS)
            problems.extend(("unknown_field", f)
                            for f in sorted(fields) if f not in known)
        return problems

    def _record_violation(self, type: str, problem: str,
                          field: Optional[str]) -> None:
        key = (type, problem, field)
        with self._lock:
            if key in self._violation_keys:
                return
            self._violation_keys.add(key)
            self.schema_violations += 1
        if self._tally_global:
            _VALIDATION_VIOLATIONS.append(
                {"event": type, "problem": problem, "field": field,
                 "path": self.path})
        try:
            # lazy: the registry must not be an import-time dependency
            from fed_tgan_torch.obs.registry import counter as _schema_counter

            _schema_counter(
                "fed_tgan_journal_schema_violations_total").inc()
        except Exception:  # noqa: BLE001 -- sanitizer never raises
            pass
        extra = {"field": field} if field is not None else {}
        self.emit("schema_violation", event=type, problem=problem, **extra)

    def emit(self, type: str, **fields) -> Optional[dict]:
        """Append one event; returns the event dict (None if closed)."""
        type = str(type)
        if self.validate and type != "schema_violation":
            for problem, field in self._check_schema(type, fields):
                self._record_violation(type, problem, field)
        event: Dict[str, object] = {"ts": round(time.time(), 6),
                                    "type": type}
        event.update(fields)
        try:
            line = json.dumps(event, default=str)
        except (TypeError, ValueError):
            event = {"ts": event["ts"], "type": event["type"],
                     "error": "unserializable fields dropped"}
            line = json.dumps(event)
        with self._lock:
            if self._closed:
                return None
            try:
                self._fh.write(line + "\n")
                self._fh.flush()
            except OSError:
                return None
        return event

    def close(self) -> None:
        self.emit("run_end", seconds=round(time.time() - self._t0, 3))
        with self._lock:
            if not self._closed:
                self._closed = True
                try:
                    self._fh.close()
                except OSError:
                    pass

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_INSTALL_LOCK = threading.Lock()
_JOURNAL: Optional[RunJournal] = None


def set_journal(journal: Optional[RunJournal]) -> Optional[RunJournal]:
    """Install ``journal`` as the process journal; returns the previous."""
    global _JOURNAL
    with _INSTALL_LOCK:
        prev, _JOURNAL = _JOURNAL, journal
        return prev


def get_journal() -> Optional[RunJournal]:
    return _JOURNAL


def emit(type: str, **fields) -> Optional[dict]:
    """Emit into the process journal; free no-op while none installed."""
    j = _JOURNAL
    if j is None:
        return None
    return j.emit(type, **fields)


def read_journal(path: str, on_skip=None) -> Iterator[dict]:
    """Yield parsed events; tolerates blank and truncated tail lines.

    ``on_skip``, when given, is called with a one-line description for
    every undecodable line (a crashed writer leaves a torn final line);
    CLI readers route it to stderr, library readers stay silent.
    """
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError:
                # torn tail write on crash -- skip, don't die
                if on_skip is not None:
                    on_skip(f"{path}:{lineno}: skipping truncated journal "
                            f"line ({len(line)} bytes)")
                continue
            if isinstance(event, dict):
                yield event


def load_journal(path: str) -> List[dict]:
    return list(read_journal(path))
