"""Conditional-vector and real-row samplers
(counterpart of ``fed_tgan_tpu/train/sampler.py:32-166``).

- ``CondSampler``: per-discrete-column probability tables padded to
  (n_discrete, max_size).  ``p_train`` is the log-frequency distribution
  training conditions on, ``p_empirical`` the raw frequency that
  generation draws from (the reference's ``sample_zero``).  A draw picks a
  column uniformly, then an option by inverse CDF, and sets that position
  of the conditional vector.
- ``RowSampler``: the real rows bucketed per (column, option) into one
  flat ``row_pool`` with CSR ``offsets``/``counts``, so "a random row whose
  column c holds option o" is one gather.

Every draw can be made from injected random numbers (``*_from_draws``),
which is how the tests feed both packages the same draws.

The federated round draws for every client at once from
:class:`StackedCondSampler` and :class:`StackedRowSampler`, the clients'
tables stacked on a leading axis (the counterpart of
``fed_tgan_tpu/train/federated.py:87-99``, ``_stack_samplers``).  A
client's row draw indexes only its own rows of the stacked data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fed_tgan_torch.device import resolve_device
from fed_tgan_torch.ops.segments import SegmentSpec, cond_tables


@dataclass(frozen=True, eq=False)
class CondSampler:
    p_train: torch.Tensor      # (n_discrete, max_size) float32
    p_empirical: torch.Tensor  # (n_discrete, max_size) float32
    spec: SegmentSpec

    @staticmethod
    def count_matrix(data: np.ndarray, spec: SegmentSpec) -> np.ndarray:
        """Per-discrete-column one-hot counts of the encoded ``data``,
        (n_discrete, max_size) zero-padded."""
        max_size = int(spec.cond_sizes.max()) if spec.n_discrete else 1
        counts = np.zeros((max(spec.n_discrete, 1), max_size))
        for c in range(spec.n_discrete):
            start = spec.cond_offsets[c]
            dims = spec.discrete_dims[start:start + spec.cond_sizes[c]]
            counts[c, :len(dims)] = data[:, dims].sum(axis=0)
        return counts

    @classmethod
    def from_data(cls, data: np.ndarray, spec: SegmentSpec,
                  device="cuda") -> "CondSampler":
        """From the encoded matrix (rows, spec.dim)."""
        return cls.from_counts(cls.count_matrix(data, spec), spec, device)

    @classmethod
    def from_counts(cls, counts: np.ndarray, spec: SegmentSpec,
                    device="cuda") -> "CondSampler":
        """Build from per-column option counts (n_discrete, max_size)."""
        counts = np.asarray(counts, dtype=np.float64)
        p_train = np.zeros_like(counts)
        p_emp = np.zeros_like(counts)
        for c in range(spec.n_discrete):
            size = int(spec.cond_sizes[c])
            freq = counts[c, :size]
            if freq.sum() <= 0:
                # all-zero counts: log(1)=0 everywhere would divide 0/0
                p_train[c, :size] = 1.0 / size
                p_emp[c, :size] = 1.0 / size
                continue
            logf = np.log(freq + 1.0)
            p_train[c, :size] = logf / logf.sum()
            p_emp[c, :size] = freq / freq.sum()
        return cls.from_tables(p_train, p_emp, spec, device)

    @classmethod
    def from_tables(cls, p_train, p_empirical, spec: SegmentSpec,
                    device="cuda") -> "CondSampler":
        device = resolve_device(device)
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                         device=device)
        return cls(p_train=as_t(p_train), p_empirical=as_t(p_empirical),
                   spec=spec)

    def onehot(self, pos: torch.Tensor) -> torch.Tensor:
        """Conditional vectors (len(pos), n_opt) with a 1 at each ``pos``."""
        out = torch.zeros((pos.shape[0], self.spec.n_opt),
                          device=self.p_empirical.device)
        return out.scatter_(1, pos[:, None], 1.0)

    def _pick(self, probs: torch.Tensor, col: torch.Tensor,
              r: torch.Tensor):
        """``(option, cond-vector position)`` per row: inverse CDF of row
        ``col`` of ``probs`` at the uniform ``r`` (batch, 1); the first
        option whose cumulative probability exceeds ``r``."""
        opt = (torch.cumsum(probs[col], dim=1) > r).to(torch.int8).argmax(dim=1)
        offsets = cond_tables(self.spec, col.device)["cond_offsets"]
        return opt, offsets[col] + opt

    def empirical_from_draws(self, col: torch.Tensor,
                             r: torch.Tensor) -> torch.Tensor:
        """The conditional vectors for drawn columns ``col`` (batch,) int64
        and uniforms ``r`` (batch, 1): inverse CDF over ``p_empirical``."""
        return self.onehot(self._pick(self.p_empirical, col, r)[1])

    def train_from_draws(self, col: torch.Tensor, r: torch.Tensor):
        """``(cond (batch, n_opt), mask (batch, n_discrete), col, opt)``
        for drawn columns ``col`` and uniforms ``r`` (batch, 1): inverse
        CDF over ``p_train`` (``sampler.py:95``)."""
        opt, pos = self._pick(self.p_train, col, r)
        mask = torch.zeros((col.shape[0], self.spec.n_discrete),
                           device=col.device)
        return self.onehot(pos), mask.scatter_(1, col[:, None], 1.0), col, opt

    def draw(self, batch: int, generator: torch.Generator):
        """``(col (batch,), r (batch, 1))``: a uniform column and the
        uniform behind its option."""
        device = self.p_train.device
        col = torch.randint(0, self.spec.n_discrete, (batch,),
                            generator=generator, device=device)
        r = torch.rand((batch, 1), generator=generator, device=device)
        return col, r

    def sample_empirical(self, batch: int,
                         generator: torch.Generator) -> torch.Tensor:
        """Generation-time conditional vectors (batch, n_opt)."""
        return self.empirical_from_draws(*self.draw(batch, generator))


@dataclass(frozen=True, eq=False)
class RowSampler:
    """Class-conditional real-row sampling (reference ``Sampler``).

    ``row_pool`` (n_discrete * n_rows,) holds row indices grouped by
    (column, option), each group in row order (stable argsort);
    ``offsets``/``counts`` (n_opt,) point into it."""

    row_pool: torch.Tensor  # int64
    offsets: torch.Tensor   # int64
    counts: torch.Tensor    # int32
    n_rows: int
    spec: SegmentSpec

    @classmethod
    def from_data(cls, data: np.ndarray, spec: SegmentSpec,
                  device="cuda") -> "RowSampler":
        pools, offsets, counts = [], [], []
        cursor = 0
        for c in range(spec.n_discrete):
            start = spec.cond_offsets[c]
            dims = spec.discrete_dims[start:start + spec.cond_sizes[c]]
            slots = data[:, dims].argmax(axis=1)
            cnt = np.bincount(slots, minlength=len(dims))
            pools.append(np.argsort(slots, kind="stable"))
            offsets += (cursor + np.concatenate([[0], np.cumsum(cnt)[:-1]])).tolist()
            counts += cnt.tolist()
            cursor += len(data)
        pool = np.concatenate(pools) if pools else np.zeros(1, np.int64)
        device = resolve_device(device)
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                             device=device)
        return cls(row_pool=as_t(pool, torch.long),
                   offsets=as_t(offsets, torch.long),
                   counts=as_t(counts, torch.int32),
                   n_rows=len(data), spec=spec)

    def sample_rows(self, col: torch.Tensor, opt: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
        """Row indices holding option ``opt`` of column ``col``, picked by
        the uniforms ``u`` (batch,): ``offsets[o] + floor(u * count[o])``.
        An option never observed cannot be drawn (its ``p_train`` is 0)."""
        o = cond_tables(self.spec, col.device)["cond_offsets"][col] + opt
        cnt = torch.clamp(self.counts[o], min=1)
        return self.row_pool[self.offsets[o] + (u * cnt).to(torch.long)]

    def sample_uniform(self, u: torch.Tensor) -> torch.Tensor:
        """Uniformly drawn row indices ``floor(u * n_rows)`` (batch,)."""
        return (u * self.n_rows).to(torch.long)


@dataclass(frozen=True, eq=False)
class StackedCondSampler:
    """N clients' training tables: ``p_train`` (N * n_discrete, max_size),
    client-major; ``base`` (N,) = each client's first row of it."""

    p_train: torch.Tensor
    base: torch.Tensor
    spec: SegmentSpec

    @classmethod
    def stack(cls, samplers: list) -> "StackedCondSampler":
        p = torch.cat([c.p_train for c in samplers])
        nd = samplers[0].p_train.shape[0]
        base = torch.arange(len(samplers), device=p.device) * nd
        return cls(p_train=p, base=base, spec=samplers[0].spec)

    def take(self, idx: torch.Tensor) -> "StackedCondSampler":
        """The clients ``idx`` (C,) as a stack of their own, sharing this
        one's tables."""
        return StackedCondSampler(p_train=self.p_train, base=self.base[idx],
                                  spec=self.spec)

    def train_from_draws(self, col: torch.Tensor, r: torch.Tensor):
        """:meth:`CondSampler.train_from_draws` for every client: ``col``
        (N, batch) int64, ``r`` (N, batch, 1), each client's row of
        ``p_train``; returns ``(cond (N * batch, n_opt), mask (N * batch,
        n_discrete), col (N, batch), opt (N, batch))``, client-major."""
        n, batch = col.shape
        rows = (col + self.base[:, None]).reshape(-1)
        opt = (torch.cumsum(self.p_train[rows], dim=1) > r.reshape(-1, 1)
               ).to(torch.int8).argmax(dim=1)
        flat = col.reshape(-1)
        pos = cond_tables(self.spec, col.device)["cond_offsets"][flat] + opt
        cond = torch.zeros((n * batch, self.spec.n_opt), device=col.device)
        mask = torch.zeros((n * batch, self.spec.n_discrete),
                           device=col.device)
        return (cond.scatter_(1, pos[:, None], 1.0),
                mask.scatter_(1, flat[:, None], 1.0), col, opt.view(n, batch))


@dataclass(frozen=True, eq=False)
class StackedRowSampler:
    """N clients' real-row tables over the stacked data, whose client ``i``
    holds rows ``[i * stride, i * stride + n_rows[i])``.

    ``row_pool`` (N * L,) holds stacked-data row indices, client ``i``'s
    pool at ``[i * L, i * L + len)``, padded with its first row;
    ``offsets`` (N, n_opt) point into it and ``counts`` (N, n_opt) count
    each group, so a draw never leaves its client's rows."""

    row_pool: torch.Tensor  # int64
    offsets: torch.Tensor   # int64
    counts: torch.Tensor    # int32
    n_rows: torch.Tensor    # (N,) float32
    row_base: torch.Tensor  # (N,) int64
    spec: SegmentSpec

    @classmethod
    def stack(cls, samplers: list, stride: int) -> "StackedRowSampler":
        device = samplers[0].row_pool.device
        length = max(int(s.row_pool.shape[0]) for s in samplers)
        pools, offsets = [], []
        for i, s in enumerate(samplers):
            pool = s.row_pool + i * stride
            pad = torch.full((length - pool.shape[0],), i * stride,
                             dtype=pool.dtype, device=device)
            pools.append(torch.cat([pool, pad]))
            offsets.append(s.offsets + i * length)
        return cls(row_pool=torch.cat(pools), offsets=torch.stack(offsets),
                   counts=torch.stack([s.counts for s in samplers]),
                   n_rows=torch.tensor([float(s.n_rows) for s in samplers],
                                       device=device),
                   row_base=torch.arange(len(samplers), device=device)
                   * stride, spec=samplers[0].spec)

    def take(self, idx: torch.Tensor) -> "StackedRowSampler":
        """The clients ``idx`` (C,) as a stack of their own over the same
        stacked data: their groups' offsets and counts, their row counts
        and bases, this one's row pool (its indices already point at each
        client's own rows of the data)."""
        return StackedRowSampler(
            row_pool=self.row_pool, offsets=self.offsets[idx],
            counts=self.counts[idx], n_rows=self.n_rows[idx],
            row_base=self.row_base[idx], spec=self.spec)

    def sample_rows(self, col: torch.Tensor, opt: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
        """:meth:`RowSampler.sample_rows` for every client: ``col``,
        ``opt``, ``u`` (N, batch); returns (N * batch,) stacked-data row
        indices."""
        o = cond_tables(self.spec, col.device)["cond_offsets"][col] + opt
        cnt = torch.clamp(self.counts.gather(1, o), min=1)
        start = self.offsets.gather(1, o)
        return self.row_pool[start + (u * cnt).to(torch.long)].reshape(-1)

    def sample_uniform(self, u: torch.Tensor) -> torch.Tensor:
        """Each client's uniformly drawn rows (N * batch,)."""
        idx = (u * self.n_rows[:, None]).to(torch.long)
        return (idx + self.row_base[:, None]).reshape(-1)
