"""Conditional-vector sampler (counterpart of ``fed_tgan_tpu/train/sampler.py:32-108``).

Per-discrete-column probability tables padded to (n_discrete, max_size):
``p_train`` is the log-frequency distribution training conditions on,
``p_empirical`` the raw frequency that generation draws from (the
reference's ``sample_zero``).  A draw picks a column uniformly, then an
option by inverse CDF, and sets that position of the conditional vector.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fed_tgan_torch.ops.segments import SegmentSpec


@dataclass(frozen=True, eq=False)
class CondSampler:
    p_train: torch.Tensor      # (n_discrete, max_size) float32
    p_empirical: torch.Tensor  # (n_discrete, max_size) float32
    spec: SegmentSpec

    @classmethod
    def from_counts(cls, counts: np.ndarray,
                    spec: SegmentSpec) -> "CondSampler":
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
        return cls.from_tables(p_train, p_emp, spec)

    @classmethod
    def from_tables(cls, p_train, p_empirical, spec: SegmentSpec,
                    device="cpu") -> "CondSampler":
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32),
                                         device=device)
        return cls(p_train=as_t(p_train), p_empirical=as_t(p_empirical),
                   spec=spec)

    def onehot(self, pos: torch.Tensor) -> torch.Tensor:
        """Conditional vectors (len(pos), n_opt) with a 1 at each ``pos``."""
        out = torch.zeros((pos.shape[0], self.spec.n_opt),
                          device=self.p_empirical.device)
        return out.scatter_(1, pos[:, None], 1.0)

    def empirical_from_draws(self, col: torch.Tensor,
                             r: torch.Tensor) -> torch.Tensor:
        """The conditional vectors for drawn columns ``col`` (batch,) int64
        and uniforms ``r`` (batch, 1): inverse CDF over ``p_empirical``."""
        p = self.p_empirical[col]
        opt = (torch.cumsum(p, dim=1) > r).to(torch.int8).argmax(dim=1)
        offsets = torch.as_tensor(self.spec.cond_offsets, dtype=torch.long,
                                  device=col.device)
        return self.onehot(offsets[col] + opt)

    def sample_empirical(self, batch: int,
                         generator: torch.Generator) -> torch.Tensor:
        """Generation-time conditional vectors (batch, n_opt)."""
        device = self.p_empirical.device
        col = torch.randint(0, self.spec.n_discrete, (batch,),
                            generator=generator, device=device)
        r = torch.rand((batch, 1), generator=generator, device=device)
        return self.empirical_from_draws(col, r)
