"""Canary promotion: a new generation is scored in shadow before it may
serve (counterpart of ``fed_tgan_tpu/serve/canary.py:61-561``, on column
dicts instead of DataFrames).

Under ``--promote canary`` a :class:`CanaryGate` takes the reload poll's
place: when the registry sees a loadable new generation, the gate samples
``shadow_rows`` rows from it through the serving engine's own chunk loop
(one activation kernel launch per chunk), scores them against the
tenant's reference statistics and promotes the candidate only when the
``quality/*`` budgets of ``obs/budgets.json`` hold.

Scoring:

- **Avg_JSD**: per categorical column, the Jensen-Shannon distance (base
  2, ``scipy``) between the reference frequencies and the sample's, over
  the reference's categories;
- **Avg_WD**: per continuous column, the min-max-scaled 1-Wasserstein
  distance through :func:`fed_tgan_torch.federation.sketch.wd_scores`:
  reference and sample become two mixtures of tiny-sigma Gaussians, the
  pool weight omega = [1, 0] pins the pooled CDF to the reference, and
  row 1 of one scorer call is every column's W1 at once, on the engine's
  device;
- optionally an **ML-efficacy probe**: a logistic regression trained on
  the sample, tested on real rows kept in the statistics (sklearn,
  imported where the probe runs; None where it is absent).

The budgets bound regressions: the candidate's scores are compared with
the serving model's over the same reference and shadow seed (cached per
serving model id).  A rejected candidate's fingerprint is quarantined, so
the same bytes are never scored again, and the serving model is left as
it was.  Each decision is journaled (``promotion_promoted``,
``promotion_rejected``, with the decision dict's fields), and a candidate
that fails to load is a ``serve_reload_failed`` event.

The reference statistics are a JSON file written beside the model at
``--save-model`` time (``reference_stats_<name>.json``); without one the
gate derives them from a shadow sample of the serving model
(``source: "derived_incumbent"``) and then bounds drift from it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from fed_tgan_torch.data.csvio import cell_strings
from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.obs.journal import emit as _emit_event
from fed_tgan_torch.federation.sketch import (
    GRID_POINTS,
    column_grids,
    wd_scores,
)

REFERENCE_STATS_SCHEMA = 1

#: shadow-sample size: score noise well inside the 0.15 budgets, and one
#: chunk of the serving engine
DEFAULT_SHADOW_ROWS = 512

#: per-column value subsample kept in the statistics (order statistics,
#: a deterministic quantile sketch)
DEFAULT_MAX_VALUES = 256

#: sigma of the empirical-value Gaussians, in min-max-scaled units
_EMPIRICAL_STD = 1e-3


# ------------------------------------------------------------ frames

def frame_rows(frame: dict) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def _strings(values) -> np.ndarray:
    """``Series.astype(str)`` of a column: strings, None where missing."""
    values = np.asarray(values)
    if values.dtype.kind in "US":
        return values.astype(object)
    return cell_strings(values)


def value_freqs(values) -> tuple:
    """``astype(str).value_counts(normalize=True)``: (categories, freqs),
    by count, ties in order of first appearance, missing cells left out."""
    counts: dict = {}
    for s in _strings(values).tolist():
        if s is not None:
            counts[s] = counts.get(s, 0) + 1
    ordered = sorted(counts.items(), key=lambda kv: -kv[1])
    total = sum(counts.values())
    return [k for k, _ in ordered], [n / total for _, n in ordered]


def _floats(values) -> np.ndarray:
    return np.asarray(values, dtype=np.float64)


# ------------------------------------------------------- reference stats

def reference_stats_path(models_dir: str, name: str) -> str:
    """The statistics live beside the meta JSON; the registry never takes
    them for a meta (a meta counts only with its encoder file)."""
    return os.path.join(models_dir, f"reference_stats_{name}.json")


def _subsample(values: np.ndarray, max_values: int) -> np.ndarray:
    """Deterministic quantile sketch: evenly spaced order statistics."""
    values = np.sort(np.asarray(values, dtype=np.float64))
    values = values[np.isfinite(values)]
    if len(values) <= max_values:
        return values
    idx = np.linspace(0, len(values) - 1, max_values).round().astype(int)
    return values[idx]


def _probe_cell(v, categorical: bool):
    if not categorical:
        return float(v)
    if v is None or (isinstance(v, float) and v != v):
        return "nan"
    return str(v)


def compute_reference_stats(frame: dict, categorical_columns,
                            max_values: int = DEFAULT_MAX_VALUES,
                            probe_rows: int = 0, name: str = "",
                            source: str = "training_data") -> dict:
    """Distill ``frame`` ({column: values}) into the JSON scoring
    reference; ``probe_rows`` > 0 also keeps that many head rows for the
    ML-efficacy probe."""
    cats = [c for c in categorical_columns if c in frame]
    stats: dict = {
        "schema": REFERENCE_STATS_SCHEMA,
        "name": str(name),
        "rows": frame_rows(frame),
        "source": str(source),
        "categorical": {},
        "continuous": {},
    }
    for col, values in frame.items():
        if col in cats:
            categories, freqs = value_freqs(values)
            stats["categorical"][str(col)] = {
                "categories": categories, "freqs": freqs}
        else:
            vals = _floats(values)
            vals = vals[np.isfinite(vals)]
            stats["continuous"][str(col)] = {
                "min": float(vals.min()) if len(vals) else 0.0,
                "max": float(vals.max()) if len(vals) else 1.0,
                "values": [float(v) for v in _subsample(vals, max_values)],
            }
    if probe_rows > 0:
        n = min(int(probe_rows), frame_rows(frame))
        names = list(frame)
        columns = [np.asarray(frame[c], dtype=object)[:n].tolist()
                   for c in names]
        stats["probe"] = {
            "columns": [str(c) for c in names],
            "rows": [[_probe_cell(v, c in cats) for c, v in zip(names, row)]
                     for row in zip(*columns)],
        }
    return stats


def write_reference_stats(stats: dict, path: str) -> str:
    """Atomic write (temp file, then rename)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(stats, f)
    os.replace(tmp, path)
    return path


def load_reference_stats(path: str) -> dict:
    with open(path) as f:
        stats = json.load(f)
    if not isinstance(stats, dict) or "categorical" not in stats \
            or "continuous" not in stats:
        raise ValueError(f"{path}: not a reference-stats artifact")
    return stats


# ---------------------------------------------------------------- scoring

def wd_inputs(stats: dict, frame: dict,
              max_values: int = DEFAULT_MAX_VALUES) -> tuple:
    """``(columns, means, stds, weights, empty)``: the (2, C, K) mixtures
    of the reference (row 0) and the sample (row 1), every continuous
    column of ``stats``; ``empty[j]`` marks a column the sample lacks."""
    cols, pairs = [], []
    for col, info in stats["continuous"].items():
        lo, hi = float(info["min"]), float(info["max"])
        span = (hi - lo) if hi > lo else 1.0
        ref = (np.asarray(info["values"], dtype=np.float64) - lo) / span
        if col in frame:
            cand = _floats(frame[col])
            cand = _subsample((cand[np.isfinite(cand)] - lo) / span,
                              max_values)
        else:
            cand = np.asarray([], dtype=np.float64)
        cols.append(col)
        pairs.append((ref, cand))
    k = max(max(len(r), len(c), 1) for r, c in pairs)
    shape = (2, len(cols), k)
    means = np.zeros(shape)
    stds = np.ones(shape)  # zero-weight padding keeps the CDF finite
    weights = np.zeros(shape)
    for j, (ref, cand) in enumerate(pairs):
        for row, vals in ((0, ref), (1, cand)):
            if not len(vals):
                continue
            means[row, j, :len(vals)] = vals
            stds[row, j, :len(vals)] = _EMPIRICAL_STD
            weights[row, j, :len(vals)] = 1.0 / len(vals)
    return cols, means, stds, weights, [not len(c) for _, c in pairs]


def wd_call(means, stds, weights, grid_points: int, device) -> tuple:
    """The scorer's float32 operands on ``device`` (omega = [1, 0])."""
    grid = column_grids(means, stds, weights, grid_points)
    return tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                 device=device)
                 for a in (means, stds, weights, [1.0, 0.0], grid))


def _wd_columns(stats: dict, frame: dict, grid_points: int, device,
                max_values: int = DEFAULT_MAX_VALUES) -> dict:
    """Per-column min-max-scaled W1(sample, reference), every column in
    one scorer call on ``device``; a column the sample lacks scores 1."""
    if not stats["continuous"]:
        return {}
    cols, means, stds, weights, empty = wd_inputs(stats, frame, max_values)
    wd = wd_scores(*wd_call(means, stds, weights, grid_points, device))
    wd = wd.cpu().numpy().astype(np.float64)
    return {col: 1.0 if gone else float(wd[1, j])
            for j, (col, gone) in enumerate(zip(cols, empty))}


def score_frame(stats: dict, frame: dict, grid_points: Optional[int] = None,
                device="cuda") -> dict:
    """Score ``frame`` against ``stats`` (JSD base 2, WD on values scaled
    by the reference's min and max), the WD on ``device`` (the card
    unless the caller names the CPU).  Returns
    ``{"avg_jsd", "avg_wd", "per_column": {col: {kind, value}}}``."""
    from scipy.spatial.distance import jensenshannon

    device = resolve_device(device)

    per_column: dict = {}
    jsd_vals = []
    for col, info in stats["categorical"].items():
        p = np.asarray(info["freqs"], dtype=np.float64)
        if col in frame and frame_rows(frame):
            freqs = dict(zip(*value_freqs(frame[col])))
            q = np.asarray([float(freqs.get(c, 0.0))
                            for c in info["categories"]])
        else:
            q = np.zeros_like(p)
        val = float(jensenshannon(p, q, 2.0))
        if not np.isfinite(val):
            val = 0.0  # identical degenerate distributions
        per_column[col] = {"kind": "jsd", "value": val}
        jsd_vals.append(val)
    wd_by_col = _wd_columns(stats, frame, grid_points or GRID_POINTS, device)
    for col, val in wd_by_col.items():
        per_column[col] = {"kind": "wd", "value": val}
    wd_vals = list(wd_by_col.values())
    return {
        "avg_jsd": float(np.mean(jsd_vals)) if jsd_vals else 0.0,
        "avg_wd": float(np.mean(wd_vals)) if wd_vals else 0.0,
        "per_column": per_column,
    }


def ml_efficacy_probe(stats: dict, frame: dict) -> Optional[float]:
    """Train-on-synthetic / test-on-real accuracy for the first
    categorical column against the probe rows in ``stats``.  None when
    the probe does not apply (no probe rows, no categorical target,
    sklearn absent, one training label)."""
    probe = stats.get("probe")
    if not probe or not stats["categorical"]:
        return None
    target = next(iter(stats["categorical"]))
    try:
        from sklearn.linear_model import LogisticRegression

        real = {c: np.array(v, dtype=object)
                for c, v in zip(probe["columns"], zip(*probe["rows"]))}

        def features(df):
            blocks = []
            for col, info in stats["categorical"].items():
                if col == target:
                    continue
                s = _strings(df[col])
                blocks.append(np.stack(
                    [(s == c).astype(float) for c in info["categories"]],
                    axis=1))
            for col, info in stats["continuous"].items():
                lo, hi = float(info["min"]), float(info["max"])
                span = (hi - lo) if hi > lo else 1.0
                v = (_floats(df[col]) - lo) / span
                blocks.append(np.nan_to_num(v)[:, None])
            return np.concatenate(blocks, axis=1)

        y_train = _strings(frame[target]).astype(str)
        if len(np.unique(y_train)) < 2:
            return None
        clf = LogisticRegression(max_iter=200)
        clf.fit(features(frame), y_train)
        y_real = _strings(real[target]).astype(str)
        return float(np.mean(clf.predict(features(real)) == y_real))
    except Exception:
        return None


# ------------------------------------------------------------------- gate

@dataclass
class CanaryConfig:
    """Knobs of one tenant's promotion gate."""

    shadow_rows: int = DEFAULT_SHADOW_ROWS
    shadow_seed: int = 0
    grid_points: int = 0            # 0 = the scorer's default (512)
    max_values: int = DEFAULT_MAX_VALUES
    ml_probe: bool = False          # score quality/ml_acc_delta too
    budgets_path: Optional[str] = None   # None = obs/budgets.json


@dataclass
class _StatsCache:
    key: tuple = ()
    stats: Optional[dict] = field(default=None)


class CanaryGate:
    """Per-tenant promotion state machine over one registry and engine.

    :meth:`consider` replaces the reload poll's ``maybe_reload``: it polls
    for a candidate generation, scores it in shadow, and either promotes
    it into the registry (the caller then adopts it, as after an
    immediate reload) or quarantines its fingerprint and leaves the
    serving model untouched.  It never raises."""

    def __init__(self, registry, engine, tenant: str = "",
                 config: Optional[CanaryConfig] = None, log=print):
        self.registry = registry
        self.engine = engine
        self.tenant = tenant or registry.get().artifact.name
        self.config = config or CanaryConfig()
        self._log = log
        # consider() runs on the reload thread, status() on HTTP threads
        self._lock = threading.Lock()
        self._quarantine: dict = {}   # fingerprint -> rejection decision
        self._baselines: dict = {}    # serving model_id -> scores
        self._stats_cache = _StatsCache()
        self.last_decision: Optional[dict] = None
        self.promotions = 0
        self.rejections = 0
        self.scored_total = 0
        self.shadow_samples = 0       # every sample the gate drew

    # --------------------------------------------------------- reference

    def _sample(self, snap) -> dict:
        with self._lock:
            self.shadow_samples += 1
        return self.engine.sample_frame(self.config.shadow_rows,
                                        seed=self.config.shadow_seed,
                                        snap=snap)

    def _reference_stats(self, incumbent) -> dict:
        """The artifact's statistics when present (cached by stat), else
        statistics of a shadow sample of the serving model."""
        art = incumbent.artifact
        path = reference_stats_path(os.path.dirname(art.meta_path), art.name)
        try:
            st = os.stat(path)
            key = ("file", path, st.st_mtime_ns, st.st_size)
        except OSError:
            key = ("derived", incumbent.model_id)
        if self._stats_cache.key == key and self._stats_cache.stats:
            return self._stats_cache.stats
        stats = None
        if key[0] == "file":
            try:
                stats = load_reference_stats(path)
            except (OSError, ValueError) as exc:
                self._log(f"canary[{self.tenant}]: unreadable reference "
                          f"stats {path} ({exc}); deriving from incumbent")
                key = ("derived", incumbent.model_id)
        if stats is None:
            frame = self._sample(self.engine.snapshot())
            stats = compute_reference_stats(
                frame, list(incumbent.meta.categorical_columns),
                max_values=self.config.max_values, name=art.name,
                source="derived_incumbent")
        self._stats_cache = _StatsCache(key=key, stats=stats)
        return stats

    def _score(self, stats: dict, snap) -> dict:
        frame = self._sample(snap)
        with self._lock:
            self.scored_total += 1
        scores = score_frame(stats, frame,
                             grid_points=self.config.grid_points or None,
                             device=self.engine.device)
        if self.config.ml_probe and stats.get("probe"):
            scores["ml_acc"] = ml_efficacy_probe(stats, frame)
        return scores

    def _baseline(self, incumbent, stats: dict) -> dict:
        cached = self._baselines.get(incumbent.model_id)
        if cached is None:
            cached = self._score(stats, self.engine.snapshot())
            # one serving model at a time bounds the cache
            self._baselines = {incumbent.model_id: cached}
        return cached

    # ------------------------------------------------------------ budgets

    def _quality_rules(self) -> list:
        from fed_tgan_torch.obs import slo

        path = self.config.budgets_path or slo.default_budgets_path()
        try:
            rules = slo.load_budgets(path)
        except slo.SLOError as exc:
            self._log(f"canary[{self.tenant}]: budgets unreadable ({exc}); "
                      "promoting unguarded")
            return []
        out = []
        for rule in rules:
            if not str(rule.get("metric", "")).startswith("quality/"):
                continue
            sel = (rule.get("select") or {}).get("tenant")
            if sel and sel not in ("*", self.tenant):
                continue
            out.append(rule)
        return out

    @staticmethod
    def _tripped(figures: dict, rules: list) -> list:
        tripped = []
        for rule in rules:
            value = figures.get(rule["metric"])
            if value is None:
                continue
            name = rule.get("name", rule["metric"])
            if "max" in rule and value > float(rule["max"]):
                tripped.append(name)
            elif "min" in rule and value < float(rule["min"]):
                tripped.append(name)
        return tripped

    # ----------------------------------------------------------- decision

    def consider(self) -> Optional[dict]:
        """One promotion poll.  None when there is nothing new to decide
        (no candidate, or a quarantined or unloadable one), else the
        decision dict; ``decision["promoted"]`` tells the caller whether
        to adopt the registry's new model."""
        cand = self.registry.poll_candidate()
        if cand is None:
            return None
        if cand.fingerprint in self._quarantine:
            # the same rejected bytes published again or re-statted: no
            # second score
            self.registry.dismiss(cand)
            return None
        t0 = time.time()
        incumbent = self.registry.get()
        try:
            model = self.registry.load_candidate(cand)
        except Exception as exc:  # noqa: BLE001 — a torn candidate
            self._log(f"canary[{self.tenant}]: candidate "
                      f"{cand.fingerprint} failed to load ({exc!r})")
            _emit_event("serve_reload_failed", tenant=self.tenant,
                        model_id=incumbent.model_id, error=repr(exc))
            self.registry.dismiss(cand)
            return None
        try:
            stats = self._reference_stats(incumbent)
            base = self._baseline(incumbent, stats)
            scores = self._score(stats, self.engine.shadow_snapshot(model))
        except Exception as exc:  # noqa: BLE001 — a candidate that cannot
            # be shadow-sampled is rejected, never promoted on faith
            return self._reject(cand, incumbent, None, None,
                                ["shadow_error"], t0, error=repr(exc))
        figures = {
            "quality/avg_jsd": scores["avg_jsd"],
            "quality/avg_wd": scores["avg_wd"],
            "quality/jsd_delta": scores["avg_jsd"] - base["avg_jsd"],
            "quality/wd_delta": scores["avg_wd"] - base["avg_wd"],
        }
        if scores.get("ml_acc") is not None \
                and base.get("ml_acc") is not None:
            figures["quality/ml_acc_delta"] = base["ml_acc"] - scores["ml_acc"]
        tripped = self._tripped(figures, self._quality_rules())
        if tripped:
            return self._reject(cand, incumbent, scores, base, tripped, t0,
                                figures=figures)
        self.registry.promote(model, cand)
        # the candidate serves now; its scores are the next baseline (same
        # statistics, same shadow seed)
        self._baselines = {model.model_id: scores}
        with self._lock:
            self.promotions += 1
        decision = self._decision(True, cand, incumbent, scores, base,
                                  [], t0, figures=figures)
        _emit_event("promotion_promoted", **decision)
        self._log(f"canary[{self.tenant}]: promoted {cand.fingerprint} "
                  f"(jsd_delta={figures['quality/jsd_delta']:+.4f} "
                  f"wd_delta={figures['quality/wd_delta']:+.4f})")
        self.last_decision = decision
        return decision

    def poll(self, quality) -> bool:
        """One reload poll under the canary: :meth:`consider`, with its
        scores and decision recorded into ``quality`` (a
        :class:`~.metrics.QualityStore`) under this tenant.  True when the
        caller should adopt the registry's newly promoted model."""
        decision = self.consider()
        if decision is None:
            return False
        quality.record_scores(self.tenant, decision.get("avg_jsd"),
                              decision.get("avg_wd"))
        quality.record_decision(self.tenant, decision["promoted"])
        return decision["promoted"]

    def _decision(self, promoted: bool, cand, incumbent, scores, base,
                  tripped: list, t0: float, figures: Optional[dict] = None,
                  error: Optional[str] = None) -> dict:
        per_column = {}
        if scores is not None and base is not None:
            for col, cur in scores["per_column"].items():
                b = base["per_column"].get(col, {}).get("value", 0.0)
                per_column[col] = {
                    "kind": cur["kind"],
                    "candidate": round(cur["value"], 6),
                    "baseline": round(b, 6),
                    "delta": round(cur["value"] - b, 6),
                }
        decision = {
            "promoted": promoted,
            "tenant": self.tenant,
            "candidate": cand.fingerprint,
            "model_id": incumbent.model_id,
            "tripped": list(tripped),
            "per_column": per_column,
            "seconds": round(time.time() - t0, 3),
        }
        if scores is not None:
            decision["avg_jsd"] = round(scores["avg_jsd"], 6)
            decision["avg_wd"] = round(scores["avg_wd"], 6)
        for key, val in (figures or {}).items():
            decision[key.split("/", 1)[1]] = round(val, 6)
        if error is not None:
            decision["error"] = error
        return decision

    def _reject(self, cand, incumbent, scores, base, tripped: list,
                t0: float, figures: Optional[dict] = None,
                error: Optional[str] = None) -> dict:
        decision = self._decision(False, cand, incumbent, scores, base,
                                  tripped, t0, figures=figures, error=error)
        with self._lock:
            self._quarantine[cand.fingerprint] = decision
            self.rejections += 1
        self.registry.dismiss(cand)
        _emit_event("promotion_rejected", **decision)
        self._log(f"canary[{self.tenant}]: REJECTED candidate "
                  f"{cand.fingerprint} (tripped: {', '.join(tripped)}); "
                  f"keeping {incumbent.model_id}")
        self.last_decision = decision
        return decision

    # ------------------------------------------------------------- status

    def status(self) -> dict:
        """Candidate and promotion state for ``/healthz`` and ``/fleet``."""
        with self._lock:
            return {
                "mode": "canary",
                "promotions": self.promotions,
                "rejections": self.rejections,
                "quarantined": sorted(self._quarantine),
                "last_decision": self.last_decision,
            }
