"""Training-time similarity monitoring on the device
(counterpart of ``fed_tgan_tpu/train/monitor.py:47-231``).

:meth:`SimilarityMonitor.evaluate` generates ``n_rows`` rows with the
federation's aggregated generator through the port's sampling path (the
generator, kernel K1, the exact layout decode), scores them against
constants of the real table on the device, and brings back Avg_JSD,
Avg_WD and the per-column values in one host copy.  A bf16 trainer's
probe samples in bf16 and scores float32 rows (the decode and the scores
are float32 islands).

The metrics are the offline ones (``eval/similarity``):

- categorical: Jensen-Shannon distance (base 2) between the real column's
  category frequencies over the encoder's vocabulary and the sample's;
- continuous: Wasserstein distance after min-max scaling fitted on the
  real column, against a fixed equal-size random sample of the real
  column (W1 between equal-size samples is the mean absolute difference
  of the sorted values).  Non-negative log columns are compared in raw
  space (``exp(x) - 1``), and scaled values are clamped to [-1, 2] so a
  missing-value mode at the -999999 sentinel cannot swamp the mean.

The real-side constants are the JAX package's bit for bit: the same
``np.random.default_rng(seed)`` calls in the same order.  :class:`MonitorLog`
writes the JAX package's CSV byte for byte.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Sequence

import numpy as np
import torch

from fed_tgan_torch.data.csvio import cell_strings
from fed_tgan_torch.data.encoders import CategoryEncoder
from fed_tgan_torch.data.ingest import _fill_missing
from fed_tgan_torch.data.schema import TableMeta
from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.obs.journal import emit as _emit_event

# the JAX monitor samples stream key(seed + 31); the trainer's snapshots
# use seed + 29 (``train/federated.py::KEY_OFFSET``)
MONITOR_KEY_OFFSET = 31


def _js_distance_base2(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    m = 0.5 * (p + q)

    def kl(a, b):
        return torch.where(a > 0, a * torch.log(a / torch.clamp(b, min=1e-300)),
                           0.0).sum()

    js_nats = 0.5 * (kl(p, m) + kl(q, m))
    return torch.sqrt(torch.clamp(js_nats, min=0.0) / math.log(2.0))


def _numeric(values: np.ndarray) -> np.ndarray:
    """``pd.to_numeric(values, errors="coerce")`` as float64."""
    if values.dtype.kind in "iufb":
        return values.astype(np.float64)
    out = np.empty(len(values))
    for k, v in enumerate(values.tolist()):
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = np.nan
    return out


class SimilarityMonitor:
    """The real table's constants on ``device`` and the metric function.

    ``real`` is the training table as ``{name: column}`` (the port's
    :func:`~fed_tgan_torch.data.csvio.read_csv` form, raw values)."""

    def __init__(self, meta: TableMeta, encoders: Sequence[CategoryEncoder],
                 real: dict, n_rows: int = 10000, seed: int = 0,
                 device="cuda"):
        self.meta = meta
        self.n_rows = int(n_rows)
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        cat_names = list(meta.categorical_columns)
        if len(cat_names) != len(encoders):
            raise ValueError(f"{len(encoders)} encoders for "
                             f"{len(cat_names)} categorical columns")
        enc_by_name = dict(zip(cat_names, encoders))
        nonneg = set(meta.non_negative_columns)
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                         device=self.device)
        self._cats = []   # (column index, p_real (K,))
        self._conts = []  # (column index, lo, span, sorted real, is_log)
        self._cat_names, self._cont_names = [], []
        for i, col in enumerate(meta.columns):
            # ingest's missing-value normalisation: " " and blanks -> 'empty'
            vals = _fill_missing(np.asarray(real[col.name]))
            if not col.is_continuous:
                enc = enc_by_name[col.name]
                codes = enc.transform(cell_strings(vals).tolist())
                p = np.bincount(codes, minlength=len(enc.classes_)).astype(
                    np.float64)
                self._cats.append((i, as_t(p / p.sum())))
                self._cat_names.append(col.name)
            else:
                r = _numeric(vals)
                r = r[np.isfinite(r)]  # 'empty' and blank cells
                lo, hi = float(r.min()), float(r.max())
                span = hi - lo if hi > lo else 1.0
                idx = rng.choice(len(r), size=self.n_rows,
                                 replace=len(r) < self.n_rows)
                sample = np.sort((r[idx] - lo) / span)
                self._conts.append((i, lo, span, as_t(sample),
                                    col.name in nonneg))
                self._cont_names.append(col.name)

    def metrics_fn(self, decoded: torch.Tensor) -> dict:
        """Metrics of ``decoded`` (n_rows, n_columns), the numeric layout
        (codes for categorical columns, log-space values for non-negative
        ones), on its device: ``avg_jsd``, ``avg_wd`` and the per-column
        ``jsd_cols`` / ``wd_cols`` tensors."""
        n = decoded.shape[0]
        if n != self.n_rows:
            raise ValueError(f"{n} rows, the monitor scores {self.n_rows}")
        jsds, wds = [], []
        for i, p_real in self._cats:
            k = p_real.shape[0]
            codes = decoded[:, i].to(torch.int64)
            q = torch.bincount(codes, minlength=k)[:k] / n
            jsds.append(_js_distance_base2(p_real, q))
        for i, lo, span, sorted_real, is_log in self._conts:
            v = decoded[:, i]
            if is_log:
                raw = torch.exp(v) - 1.0
                v = torch.where(raw < 0, torch.ceil(raw), raw)
            v = torch.clamp((v - lo) / span, -1.0, 2.0)
            wds.append((torch.sort(v).values - sorted_real).abs().mean())
        nan = torch.tensor(float("nan"), device=decoded.device)
        out = {"avg_jsd": torch.stack(jsds).mean() if jsds else nan,
               "avg_wd": torch.stack(wds).mean() if wds else nan}
        if jsds:
            out["jsd_cols"] = torch.stack(jsds)
        if wds:
            out["wd_cols"] = torch.stack(wds)
        return out

    def decoded(self, trainer, seed: int = 0) -> torch.Tensor:
        """``n_rows`` rows of the trainer's aggregated generator (stream
        ``seed + 31``), decoded exactly, on the trainer's device."""
        engine = trainer._sampler()
        return engine.decoded_on_device(self.n_rows, seed=seed,
                                        key_offset=MONITOR_KEY_OFFSET)

    def evaluate(self, trainer, seed: int = 0) -> dict:
        """``{"avg_jsd", "avg_wd", "per_column_jsd", "per_column_wd"}``
        for the trainer's current aggregated generator: one copy of the
        scalars to the host."""
        out = self.metrics_fn(self.decoded(trainer, seed))
        none = out["avg_jsd"].new_empty(0)
        vals = torch.cat([out["avg_jsd"][None], out["avg_wd"][None],
                          out.get("jsd_cols", none),
                          out.get("wd_cols", none)]).cpu().tolist()
        nj = len(self._cat_names)
        res = {"avg_jsd": vals[0], "avg_wd": vals[1]}
        if nj:
            res["per_column_jsd"] = dict(zip(self._cat_names, vals[2:2 + nj]))
        if self._cont_names:
            res["per_column_wd"] = dict(zip(self._cont_names, vals[2 + nj:]))
        return res


class MonitorLog:
    """Crash-durable CSV of the monitor's rows (``Epoch_No.,Avg_JSD,
    Avg_WD``): each row is appended and flushed as it comes, a resumed
    run extends the file, and the file is opened on the first row, so a
    run whose monitor never fires creates nothing.  Each row is also a
    ``similarity`` journal event, with ``extra`` (the per-column values)
    in the journal only: the CSV is the same with or without a journal."""

    HEADER = ["Epoch_No.", "Avg_JSD", "Avg_WD"]

    def __init__(self, path: str):
        self.path = path
        self._file = None
        self._writer = None

    def append(self, epoch: int, avg_jsd: float, avg_wd: float,
               extra: dict | None = None) -> None:
        if self._file is None:
            new_file = not os.path.exists(self.path)
            self._file = open(self.path, "a", newline="")
            self._writer = csv.writer(self._file)
            if new_file:
                self._writer.writerow(self.HEADER)
        self._writer.writerow([epoch, avg_jsd, avg_wd])
        self._file.flush()
        _emit_event("similarity", epoch=int(epoch), avg_jsd=float(avg_jsd),
                    avg_wd=float(avg_wd), **(extra or {}))

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._writer = None

    def __enter__(self) -> "MonitorLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
