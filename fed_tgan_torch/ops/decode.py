"""Encoded layout -> numeric column values, on the device
(counterpart of ``fed_tgan_tpu/ops/decode.py:76-144``, exact f32 layout).

Continuous column: ``clip(u, -1, 1) * 4 sigma_k + mu_k`` for the argmax
active mode k.  Discrete column: the code of the argmax slot.  The packed
(quantised) layouts of the JAX package are not ported yet.
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


def layout_decode(encoded: torch.Tensor, tables: tuple) -> torch.Tensor:
    """``(n, dim)`` activated rows -> ``(n, n_columns)`` float32 values.

    ``tables`` is :func:`decode_tables` output (moved to ``encoded``'s
    device by :func:`tables_to`); a 2-tuple is a continuous column, a
    1-tuple a discrete one.  Ties in the argmax go to the first slot, as
    in JAX."""
    width = sum(1 + t[0].shape[0] if len(t) == 2 else t[0].shape[0]
                for t in tables)
    if width != encoded.shape[1]:
        raise ValueError(f"tables cover {width} dims, encoded has "
                         f"{encoded.shape[1]}")
    outs, start = [], 0
    for tab in tables:
        if len(tab) == 2:
            means, stds = tab
            size = means.shape[0]
            u = torch.clamp(encoded[:, start], -1.0, 1.0)
            k = torch.argmax(encoded[:, start + 1:start + 1 + size], dim=1)
            outs.append(u * SCALE * stds[k] + means[k])
            start += 1 + size
        else:
            (codes,) = tab
            size = codes.shape[0]
            k = torch.argmax(encoded[:, start:start + size], dim=1)
            outs.append(codes[k].to(torch.float32))
            start += size
    return torch.stack(outs, dim=1)
