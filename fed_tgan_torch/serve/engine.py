"""Offset-addressable deterministic sampling over one loaded model
(counterpart of ``fed_tgan_tpu/serve/engine.py:133-502``).

Determinism contract: rows form a virtual stream addressed by
``(seed, row_offset)``.  Step ``s`` (``batch_size`` rows) of stream
``seed`` draws its noise, conditional vectors and Gumbel uniforms from a
``torch.Generator`` on the model's device seeded from
``(seed + key_offset, s)`` alone, so N rows fetched in K chunks are
byte-identical to one N-row request.  The draws differ from the JAX
package's (torch's generators are not JAX's), so the two streams agree
in law, not in value; the tests inject the JAX draws through ``draws=``
to compare values.

A request is cut into chunks of ``max_chunk_steps`` steps plus a
power-of-two tail (``_chunk_plan``, as in JAX).  A chunk runs the
generator over fixed ``batch_size``-row blocks (one matrix-product shape
whatever the chunk size, so a row never depends on its neighbours), then
the activation kernel once over all the chunk's rows, then the layout
decode, and copies the (rows, n_columns) result to the host.  A bf16
model (``cfg.precision``) runs the generator and K1 in bf16; its encoded
rows are cast to float32 before the decode (``fed_tgan_tpu/serve/
engine.py:115-118``).

Hot reload: :meth:`SamplingEngine.snapshot` captures one consistent
serving state (:class:`EngineSnapshot`) under the engine's lock, and a
request (or a fleet batch) formed against it keeps sampling that model
even when :meth:`SamplingEngine.adopt` swaps in a new one mid-flight.
:meth:`SamplingEngine.layout_key` is the encoded layout's full signature:
models with equal keys can share the fleet's lanes.
:meth:`SamplingEngine.shadow_snapshot` is a snapshot over a model the
engine does not serve (the canary's candidate), sampled through the same
chunk loop; :meth:`SamplingEngine.sample_frame` gives its rows as the
decoded columns.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from fed_tgan_torch.analysis.sanitizers import hot_region, sanctioned_sync
from fed_tgan_torch.data.decode import decode_cells, decode_columns
from fed_tgan_torch.data.fastcsv import ColumnPlan
from fed_tgan_torch.features.transformer import DiscreteColumn
from fed_tgan_torch.ops.decode import (
    decode_layout,
    decode_tables,
    layout_decode,
    tables_to,
)
from fed_tgan_torch.serve.registry import LoadedModel
from fed_tgan_torch.train.steps import sample_step

# draws(step) -> (z, cond_vec, u) numpy arrays for that step's rows
Draws = Callable[[int], tuple]


class ConditionError(ValueError):
    """Unknown column / value for a conditional sampling request."""


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def step_seed(stream: int, step: int) -> int:
    """The 64-bit generator seed of one step of one stream."""
    seq = np.random.SeedSequence([stream % 2**64, step])
    return int(seq.generate_state(1, np.uint64)[0])


def _add_stage(stages: Optional[dict], name: str, t0: float) -> float:
    """Add the host seconds since ``t0`` to ``stages[name]``; returns
    now."""
    now = time.perf_counter()
    if stages is not None:
        stages[name] = stages.get(name, 0.0) + now - t0
    return now


class EngineSnapshot(NamedTuple):
    """One consistent view of an engine's serving state, captured under
    its lock: everything a multi-chunk request (or a fleet batch formed
    for this model) needs, immune to a hot reload swapping fields out
    from under it."""

    model: LoadedModel
    spec: object
    cfg: object
    tables: tuple          # decode tables on the model's device
    sig: tuple             # layout_key(model)
    csv_plan: Optional[ColumnPlan]


class SamplingEngine:
    """Deterministic sampling over one :class:`LoadedModel`, on the
    device the model was loaded onto."""

    def __init__(self, model: LoadedModel, max_chunk_steps: int = 128):
        self.max_chunk_steps = max_chunk_steps
        # one generator reseeded per step; the lock keeps two callers from
        # interleaving reseeds, and makes adoption atomic for readers
        self._lock = threading.RLock()
        self._adopt_fields(model)
        self.device = model.synth.device
        self._gen = torch.Generator(device=self.device)
        # the row counts of the chunks dispatched (the sanitizers' serving
        # budget: one launch plan each)
        self.chunk_rows: set = set()

    def _adopt_fields(self, model: LoadedModel) -> None:
        synth = model.synth
        self.model = model
        self.spec, self.cfg = synth.spec, synth.cfg
        self._tables = tables_to(decode_tables(synth.columns), synth.device)
        self._sig = self.layout_key(model)
        # how a request's columns are written (a model without a meta,
        # as the standalone trainer's, serves no CSV)
        self.csv_plan = (None if model.meta is None
                         else ColumnPlan(model.meta, model.encoders))

    @staticmethod
    def layout_key(model: LoadedModel) -> tuple:
        """Everything the shape of a sampling pass depends on, and
        nothing a model's values feed: equal keys mean the models' rows
        can run side by side as lanes of one pass.  The precision is part
        of it, so a bf16 and an f32 model never share a lane dispatch."""
        synth = model.synth
        cfg = synth.cfg
        return (tuple(synth.spec.output_info), decode_layout(synth.columns),
                int(cfg.batch_size), int(cfg.embedding_dim),
                tuple(cfg.gen_dims), cfg.precision, str(synth.device))

    def adopt(self, model: LoadedModel) -> bool:
        """Swap in a hot-reloaded model (on this engine's device); returns
        whether its layout key equals the old one's."""
        if model.synth.device != self.device:
            raise ValueError(f"model on {model.synth.device}, engine on "
                             f"{self.device}")
        with self._lock:
            same = self.layout_key(model) == self._sig
            self._adopt_fields(model)
            return same

    def snapshot(self) -> EngineSnapshot:
        """The current serving state, captured under the lock."""
        with self._lock:
            return EngineSnapshot(self.model, self.spec, self.cfg,
                                  self._tables, self._sig, self.csv_plan)

    def shadow_snapshot(self, model: LoadedModel) -> EngineSnapshot:
        """A snapshot over a candidate ``model`` (on this engine's
        device), without adopting it: the canary samples shadow rows
        through the serving path while every serving field stays as it
        is."""
        if model.synth.device != self.device:
            raise ValueError(f"model on {model.synth.device}, engine on "
                             f"{self.device}")
        synth = model.synth
        return EngineSnapshot(
            model, synth.spec, synth.cfg,
            tables_to(decode_tables(synth.columns), synth.device),
            self.layout_key(model),
            None if model.meta is None
            else ColumnPlan(model.meta, model.encoders))

    def _chunk_plan(self, first_step: int, total_steps: int,
                    pow2_tail: bool = True):
        """(start_step, n_steps) chunks covering ``total_steps`` from
        ``first_step``: full ``max_chunk_steps`` blocks, then a power-of-two
        tail, or without ``pow2_tail`` exactly the steps still due."""
        plan, start = [], first_step
        end = first_step + total_steps
        while start < end:
            remaining = end - start
            steps = (self.max_chunk_steps if remaining >= self.max_chunk_steps
                     else min(_pow2(remaining) if pow2_tail else remaining,
                              self.max_chunk_steps))
            plan.append((start, steps))
            start += steps
        return plan

    # -------------------------------------------------------------- draws

    def draw(self, snap: EngineSnapshot, stream: int, start: int, steps: int,
             condition: Optional[int], draws: Optional[Draws] = None):
        """(z, cond_vec, u) of ``snap``'s model for ``steps`` steps from
        ``start`` of stream ``stream`` (``seed + key_offset``)."""
        B, emb, spec = snap.cfg.batch_size, snap.cfg.embedding_dim, snap.spec
        cond = snap.model.synth.cond
        zs, cs, us = [], [], []
        with self._lock:
            for s in range(start, start + steps):
                if draws is not None:
                    z, c, u = (None if a is None else torch.tensor(
                        np.asarray(a), dtype=torch.float32,
                        device=self.device) for a in draws(s))
                else:
                    g = self._gen.manual_seed(step_seed(stream, s))
                    z = torch.randn((B, emb), generator=g, device=self.device)
                    c = None
                    if spec.n_discrete and condition is None:
                        c = cond.sample_empirical(B, g)
                    u = torch.rand((B, spec.dim), generator=g,
                                   device=self.device)
                if spec.n_discrete and condition is not None:
                    c = cond.onehot(torch.full((B,), condition,
                                               dtype=torch.long,
                                               device=self.device))
                zs.append(z)
                cs.append(c)
                us.append(u)
        cond_vec = torch.cat(cs) if spec.n_discrete else None
        return torch.cat(zs), cond_vec, torch.cat(us)

    # ----------------------------------------------------------- sampling

    def resolve_condition(self, column: str, value) -> int:
        """(column name, raw category value) -> conditional-vector
        position, read from one model under the lock."""
        with self._lock:
            return self._resolve_condition_locked(column, value)

    def _resolve_condition_locked(self, column: str, value) -> int:
        meta = self.model.meta
        columns = self.model.synth.columns
        names = list(meta.column_names)
        if len(names) != len(columns):
            raise ConditionError(
                f"conditional sampling unsupported: encoded layout has "
                f"{len(columns)} columns but the meta {len(names)}")
        if column not in names:
            raise ConditionError(f"unknown column {column!r} (have {names})")
        idx = names.index(column)
        tcol = columns[idx]
        if not isinstance(tcol, DiscreteColumn):
            raise ConditionError(
                f"column {column!r} is continuous; conditional sampling "
                "fixes a DISCRETE column to one of its options")
        cats = list(meta.categorical_columns)
        if column not in cats:
            raise ConditionError(f"column {column!r} has no encoder")
        enc = self.model.encoders[cats.index(column)]
        try:
            code = int(enc.transform([value])[0])
        except ValueError:
            try:  # HTTP query params arrive as strings; retry coerced
                code = int(enc.transform([str(value)])[0])
            except ValueError as exc:
                raise ConditionError(str(exc)) from None
        slots = np.flatnonzero(np.asarray(tcol.codes) == code)
        if not len(slots):
            raise ConditionError(
                f"value {value!r} of column {column!r} never occurred in "
                "training data (no generator slot)")
        # every softmax segment is one transformer column, in column order
        return int(self.spec.cond_offsets[idx]) + int(slots[0])

    def _chunks(self, n: int, seed: int, offset: int,
                condition: Optional[int], draws: Optional[Draws], post,
                key_offset: Optional[int] = None, to_host: bool = True,
                snap: Optional[EngineSnapshot] = None,
                stages: Optional[dict] = None):
        """Rows [offset, offset + n) of stream ``seed + key_offset`` (the
        model's offset by default), each chunk's activated rows passed
        through ``post(enc, snap)`` (a tensor, or a dict of tensors) and
        copied to the host; returns the rows' array (or dict of arrays).
        With ``to_host=False`` the rows stay on the device, and the last
        chunk is exactly the steps still due: nothing is copied, so no
        power-of-two tail pads it (a row does not depend on its chunk).
        ``stages`` gains the host seconds of the whole loop as
        ``dispatch``."""
        if n <= 0:
            raise ValueError(f"n={n}: need at least one row")
        if offset < 0:
            raise ValueError(f"offset={offset}: must be >= 0")
        if snap is None:
            snap = self.snapshot()
        t0 = time.perf_counter()
        B = snap.cfg.batch_size
        first_step, skip = divmod(offset, B)
        total_steps = -(-(skip + n) // B)
        if key_offset is None:
            key_offset = snap.model.synth.key_offset
        out = []
        for start, steps in self._chunk_plan(first_step, total_steps,
                                             pow2_tail=to_host):
            with self._lock:
                self.chunk_rows.add(steps * B)
            # the chunk's dispatch is a sanitizer hot region; its one copy
            # to the host is the sanctioned sync
            with hot_region(f"serve.engine[{steps}"
                            f"{'c' if condition is not None else ''}]"):
                z, c, u = self.draw(snap, seed + key_offset, start, steps,
                                    condition, draws)
                synth = snap.model.synth
                res = post(sample_step(synth.generator, snap.spec, z, c, u,
                                       block_rows=B,
                                       dtype=synth.compute_dtype), snap)
                if to_host:
                    with sanctioned_sync():
                        res = ({k: v.cpu().numpy() for k, v in res.items()}
                               if isinstance(res, dict)
                               else res.cpu().numpy())
            out.append(res)
        cat = np.concatenate if to_host else torch.cat
        if isinstance(out[0], dict):
            result = {k: cat([o[k] for o in out])[skip:skip + n]
                      for k in out[0]}
        else:
            result = cat(out)[skip:skip + n]
        _add_stage(stages, "dispatch", t0)
        return result

    def sample_encoded(self, n: int, seed: int = 0, offset: int = 0,
                       condition: Optional[int] = None,
                       draws: Optional[Draws] = None) -> np.ndarray:
        """Rows [offset, offset + n) of stream ``seed`` as activated
        encoded rows (n, spec.dim) float32.  ``draws`` (tests only)
        replaces the generator draws of each step."""
        return self._chunks(n, seed, offset, condition, draws,
                            lambda enc, snap: enc)

    def sample_decoded(self, n: int, seed: int = 0, offset: int = 0,
                       condition: Optional[int] = None,
                       draws: Optional[Draws] = None,
                       snap: Optional[EngineSnapshot] = None,
                       stages: Optional[dict] = None) -> np.ndarray:
        """The same rows as the numeric (n, n_columns) float32 matrix."""
        return self._chunks(
            n, seed, offset, condition, draws,
            lambda enc, s: layout_decode(enc, s.tables), snap=snap,
            stages=stages)

    def sample_parts(self, n: int, decode, seed: int = 0, offset: int = 0,
                     draws: Optional[Draws] = None,
                     to_host: bool = True) -> dict:
        """The same rows through a snapshot decode
        (``ops.decode.SnapshotDecode``): its dict of host arrays, which
        ``decode.assemble`` turns into column values, or with
        ``to_host=False`` of tensors left on the device."""
        return self._chunks(n, seed, offset, None, draws,
                            lambda enc, snap: decode.decode(enc),
                            to_host=to_host)

    def decoded_on_device(self, n: int, seed: int,
                          key_offset: int) -> torch.Tensor:
        """Rows [0, n) of stream ``seed + key_offset`` as
        :meth:`sample_decoded`'s numeric layout, left on the device."""
        return self._chunks(n, seed, 0, None, None,
                            lambda enc, snap: layout_decode(enc, snap.tables),
                            key_offset=key_offset, to_host=False)

    def _cells(self, n, seed, offset, condition, draws, snap, stages):
        if snap is None:
            snap = self.snapshot()
        mat = self.sample_decoded(n, seed, offset, condition, draws,
                                  snap=snap, stages=stages)
        t0 = time.perf_counter()
        cells = decode_cells(mat, snap.model.meta, snap.model.encoders)
        return snap, cells, _add_stage(stages, "decode", t0)

    def sample_frame(self, n: int, seed: int = 0, offset: int = 0,
                     condition: Optional[int] = None,
                     snap: Optional[EngineSnapshot] = None,
                     stages: Optional[dict] = None) -> dict:
        """The same rows as ``{column: values}``, dates rejoined: the
        columns the one-shot CSV writes."""
        if snap is None:
            snap = self.snapshot()
        mat = self.sample_decoded(n, seed, offset, condition, snap=snap,
                                  stages=stages)
        t0 = time.perf_counter()
        frame = decode_columns(mat, snap.model.meta, snap.model.encoders)
        _add_stage(stages, "decode", t0)
        return frame

    def sample_csv_bytes(self, n: int, seed: int = 0, offset: int = 0,
                         condition: Optional[int] = None, header: bool = True,
                         draws: Optional[Draws] = None,
                         snap: Optional[EngineSnapshot] = None,
                         stages: Optional[dict] = None) -> bytes:
        """The same rows as CSV bytes (header line optional).  ``snap``
        pins the model (default: a fresh snapshot); ``stages`` ({stage:
        seconds}) gains the host seconds of ``dispatch`` (draws,
        generator, K1, decode on the device, copy), ``decode`` (column
        values) and ``serialize`` (CSV), never a device sync of its own."""
        snap, cells, t0 = self._cells(n, seed, offset, condition, draws,
                                      snap, stages)
        out = snap.csv_plan.csv_bytes(cells, header=header)
        _add_stage(stages, "serialize", t0)
        return out

    def sample_csv_segments(self, n: int, seed: int = 0, offset: int = 0,
                            condition: Optional[int] = None,
                            snap: Optional[EngineSnapshot] = None,
                            stages: Optional[dict] = None):
        """``(header_line, [row_line, ...])`` for rows [offset, offset+n):
        ``header + b"".join(rows)`` is :meth:`sample_csv_bytes`'s output,
        ``b"".join(rows)`` its ``header=False`` one.  A row's bytes depend
        on its position in the stream alone, so the row pool stitches any
        contiguous slice of cached segments into a response equal to a
        cold dispatch.  Raises ``ValueError`` when a cell holds a line
        break (the rows are then not line-sliceable)."""
        snap, cells, t0 = self._cells(n, seed, offset, condition, None,
                                      snap, stages)
        out = snap.csv_plan.csv_segments(cells)
        _add_stage(stages, "serialize", t0)
        return out
