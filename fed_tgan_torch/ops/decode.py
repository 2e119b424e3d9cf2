"""Encoded layout -> numeric column values, on the device
(counterpart of ``fed_tgan_tpu/ops/decode.py:76-144`` for the exact f32
layout and ``:147-399`` for the snapshot decodes).

Continuous column: ``clip(u, -1, 1) * 4 sigma_k + mu_k`` for the argmax
active mode k.  Discrete column: the code of the argmax slot.
:class:`SnapshotDecode` adds the quantised packed16 / packed8 layouts the
federated trainer's snapshots ship to the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fed_tgan_torch.features.transformer import (
    SCALE,
    ContinuousColumn,
    DiscreteColumn,
)


def decode_layout(columns: Sequence) -> tuple:
    """The shape of the decode plan: ``("cont", n_active_modes)`` or
    ``("disc", n_options)`` per column."""
    out = []
    for col in columns:
        if isinstance(col, ContinuousColumn):
            out.append(("cont", col.n_active))
        else:
            assert isinstance(col, DiscreteColumn)
            out.append(("disc", col.size))
    return tuple(out)


def decode_tables(columns: Sequence) -> tuple:
    """Per column ``(means, stds)`` float32 over the active modes, or
    ``(codes,)`` int32 — host numpy, in column order."""
    tabs = []
    for col in columns:
        if isinstance(col, ContinuousColumn):
            tabs.append((np.asarray(col.means, dtype=np.float32),
                         np.asarray(col.stds, dtype=np.float32)))
        else:
            tabs.append((np.asarray(col.codes, dtype=np.int32),))
    return tuple(tabs)


def tables_to(tables: tuple, device) -> tuple:
    return tuple(tuple(torch.as_tensor(a, device=device) for a in tab)
                 for tab in tables)


def stack_tables(tables: Sequence[tuple]) -> tuple:
    """L models' :func:`tables_to` tables of one decode layout -> one
    table set whose arrays gain a leading lane axis."""
    return tuple(tuple(torch.stack(arrays) for arrays in zip(*cols))
                 for cols in zip(*tables))


def layout_decode(encoded: torch.Tensor, tables: tuple) -> torch.Tensor:
    """``(n, dim)`` activated rows -> ``(n, n_columns)`` float32 values,
    or L lanes at once: ``(L, n, dim)`` rows and :func:`stack_tables`
    tables -> ``(L, n, n_columns)``, each lane through its own tables.

    ``tables`` is :func:`decode_tables` output (moved to ``encoded``'s
    device by :func:`tables_to`); a 2-tuple is a continuous column, a
    1-tuple a discrete one.  Ties in the argmax go to the first slot, as
    in JAX.  One model's rows run as a single lane, so a lane's values
    equal the same rows decoded alone bit for bit."""
    if encoded.dim() == 2:
        one = tuple(tuple(a[None] for a in tab) for tab in tables)
        return layout_decode(encoded[None], one)[0]
    width = sum(1 + t[0].shape[1] if len(t) == 2 else t[0].shape[1]
                for t in tables)
    if width != encoded.shape[2]:
        raise ValueError(f"tables cover {width} dims, encoded has "
                         f"{encoded.shape[2]}")
    outs, start = [], 0
    for tab in tables:
        if len(tab) == 2:
            means, stds = tab
            size = means.shape[1]
            u = torch.clamp(encoded[:, :, start], -1.0, 1.0)
            k = torch.argmax(encoded[:, :, start + 1:start + 1 + size], dim=2)
            outs.append(u * SCALE * stds.gather(1, k) + means.gather(1, k))
            start += 1 + size
        else:
            (codes,) = tab
            size = codes.shape[1]
            k = torch.argmax(encoded[:, :, start:start + size], dim=2)
            outs.append(codes.gather(1, k).to(torch.float32))
            start += size
    return torch.stack(outs, dim=2)


# ------------------------------------------------------ snapshot decodes

U_SCALE = {"packed8": 127, "packed16": 32767}
_U_DTYPE = {"packed8": torch.int8, "packed16": torch.int16}
MODES = ("exact", "packed16", "packed8")


def _disc_int_dtype(columns: Sequence) -> torch.dtype:
    """The narrowest signed integer type holding every discrete code."""
    codes = [np.asarray(c.codes) for c in columns
             if isinstance(c, DiscreteColumn) and c.size]
    lo = min([0] + [int(c.min()) for c in codes])
    hi = max([0] + [int(c.max()) for c in codes])
    for dt, info in ((torch.int8, np.iinfo(np.int8)),
                     (torch.int16, np.iinfo(np.int16))):
        if info.min <= lo and hi <= info.max:
            return dt
    return torch.int32


class SnapshotDecode:
    """A snapshot's device decode and its host assembly
    (``fed_tgan_tpu/ops/decode.py:147-332``).

    - ``exact``: the f32 values of :func:`layout_decode`;
    - ``packed16`` / ``packed8``: a continuous column ships as its clipped
      ``u`` rounded (half to even) to an int16 (scale 32767) or int8
      (scale 127) and its active mode's index as an int8; a discrete
      column as its code in the narrowest integer type.  The host then
      computes ``u / scale * 4 sigma_k + mu_k`` in float64.

    ``decode(encoded)`` maps (n, dim) activated rows on any device to a
    dict of (n, ·) tensors; ``assemble(parts)`` maps the same dict of
    host arrays to the (n, n_columns) float64 values.  Argmax ties go to
    the first index."""

    def __init__(self, columns: Sequence, mode: str = "packed8"):
        if mode not in MODES:
            raise ValueError(f"snapshot decode {mode!r}: expected exact, "
                             "packed16 or packed8")
        self.mode = mode
        self.columns = list(columns)
        self.n_cols = len(self.columns)
        self.cont_idx = np.asarray([i for i, c in enumerate(self.columns)
                                    if isinstance(c, ContinuousColumn)],
                                   dtype=np.int64)
        self.disc_idx = np.asarray([i for i, c in enumerate(self.columns)
                                    if not isinstance(c, ContinuousColumn)],
                                   dtype=np.int64)
        self.plan = decode_layout(self.columns)
        self.int_dtype = _disc_int_dtype(self.columns)
        cont = [c for c in self.columns if isinstance(c, ContinuousColumn)]
        max_modes = max([1] + [c.n_active for c in cont])
        if mode != "exact" and max_modes > 127:
            raise ValueError(f"int8 mode index supports <= 127 active modes, "
                             f"got {max_modes}")
        # host denormalization tables (n_cont, max_modes), float64
        self.mu = np.zeros((len(cont), max_modes))
        self.sg = np.zeros((len(cont), max_modes))
        for j, c in enumerate(cont):
            self.mu[j, :c.n_active] = c.means
            self.sg[j, :c.n_active] = c.stds
        self._tables = tables_to(decode_tables(self.columns), "cpu")
        self._device = torch.device("cpu")

    def _tables_on(self, device) -> tuple:
        if torch.device(device) != self._device:
            self._tables = tables_to(decode_tables(self.columns), device)
            self._device = torch.device(device)
        return self._tables

    def decode(self, encoded: torch.Tensor) -> dict:
        tables = self._tables_on(encoded.device)
        if self.mode == "exact":
            return {"values": layout_decode(encoded, tables)}
        scale, u_dtype = U_SCALE[self.mode], _U_DTYPE[self.mode]
        n, dev = encoded.shape[0], encoded.device
        us, ks, ds, start = [], [], [], 0
        for (kind, size), tab in zip(self.plan, tables):
            if kind == "cont":
                u = torch.clamp(encoded[:, start], -1.0, 1.0)
                us.append(torch.round(u * scale).to(u_dtype))
                ks.append(torch.argmax(encoded[:, start + 1:start + 1 + size],
                                       dim=1).to(torch.int8))
                start += 1 + size
            else:
                k = torch.argmax(encoded[:, start:start + size], dim=1)
                ds.append(tab[0][k].to(self.int_dtype))
                start += size
        stack = lambda xs, dt: (torch.stack(xs, dim=1) if xs else
                                torch.zeros((n, 0), dtype=dt, device=dev))
        return {"u": stack(us, u_dtype), "k": stack(ks, torch.int8),
                "disc": stack(ds, self.int_dtype)}

    def assemble(self, parts: dict) -> np.ndarray:
        if self.mode == "exact":
            return np.asarray(parts["values"], dtype=np.float64)
        u = np.asarray(parts["u"], dtype=np.float64) / U_SCALE[self.mode]
        k = np.asarray(parts["k"], dtype=np.int64)
        disc = np.asarray(parts["disc"])
        n = u.shape[0] if len(self.cont_idx) else disc.shape[0]
        out = np.empty((n, self.n_cols), dtype=np.float64)
        if len(self.cont_idx):
            sig = np.take_along_axis(self.sg[None], k[:, :, None], 2)[..., 0]
            mu = np.take_along_axis(self.mu[None], k[:, :, None], 2)[..., 0]
            out[:, self.cont_idx] = u * SCALE * sig + mu
        if len(self.disc_idx):
            out[:, self.disc_idx] = disc
        return out


def select_snapshot_decode(columns: Sequence, mode: str = "packed8"
                           ) -> SnapshotDecode:
    """The trainers' snapshot decode: packed8 unless ``mode`` names
    ``exact`` or ``packed16`` (JAX ``select_snapshot_decode``,
    ``ops/decode.py:368``, which reads the mode from the environment)."""
    return SnapshotDecode(columns, mode or "packed8")
