"""Static segment layout of the CTGAN output vector + segment-wise ops.

Counterpart of ``fed_tgan_tpu/ops/segments.py``.  A continuous column
contributes a 1-wide ``tanh`` segment and an ``n_active``-wide ``softmax``
segment; a discrete column one ``softmax`` segment.  The conditional
vector is the concatenation of every softmax segment.

``apply_activate`` and ``apply_activate_bwd`` are the plain PyTorch
versions of the activation and its gradient: the CPU route of
:mod:`fed_tgan_torch.ops.activate_cuda` and the references its CUDA
kernels are held against on the card.  ``cond_loss`` is the training
side.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

GUMBEL_TAU = 0.2  # reference ctgan.py:77


@dataclass(frozen=True, eq=False)
class SegmentSpec:
    """Static index arrays describing one table's encoded layout (host
    numpy).  Every array is a pure function of ``output_info``, which is
    therefore the identity (equality and hash)."""

    output_info: tuple  # ((size, kind), ...)
    dim: int  # total encoded width
    n_segments: int
    segment_ids: np.ndarray  # (dim,) segment index per feature position
    is_tanh_dim: np.ndarray  # (dim,) bool
    # conditional view: every softmax segment, in layout order
    n_discrete: int  # number of softmax segments (conditional "columns")
    n_opt: int  # total width of all softmax segments
    discrete_dims: np.ndarray  # (n_opt,) positions of softmax dims in the data layout
    cond_column_ids: np.ndarray  # (n_opt,) conditional-column index per cond position
    cond_offsets: np.ndarray  # (n_discrete,) start of each cond column in cond layout
    cond_sizes: np.ndarray  # (n_discrete,) width of each cond column

    def __eq__(self, other) -> bool:
        return isinstance(other, SegmentSpec) and self.output_info == other.output_info

    def __hash__(self) -> int:
        return hash(self.output_info)

    @classmethod
    def from_output_info(cls, output_info) -> "SegmentSpec":
        output_info = tuple((int(s), str(k)) for s, k in output_info)
        seg_ids, tanh_mask = [], []
        disc_dims, cond_col_ids, cond_offsets, cond_sizes = [], [], [], []
        pos = 0
        n_disc = 0
        for seg, (size, kind) in enumerate(output_info):
            seg_ids += [seg] * size
            tanh_mask += [kind == "tanh"] * size
            if kind == "softmax":
                cond_offsets.append(len(disc_dims))
                cond_sizes.append(size)
                disc_dims += list(range(pos, pos + size))
                cond_col_ids += [n_disc] * size
                n_disc += 1
            elif kind != "tanh":
                raise ValueError(f"unknown segment kind {kind!r}")
            pos += size
        return cls(
            output_info=output_info,
            dim=pos,
            n_segments=len(output_info),
            segment_ids=np.asarray(seg_ids, dtype=np.int32),
            is_tanh_dim=np.asarray(tanh_mask, dtype=bool),
            n_discrete=n_disc,
            n_opt=len(disc_dims),
            discrete_dims=np.asarray(disc_dims, dtype=np.int32),
            cond_column_ids=np.asarray(cond_col_ids, dtype=np.int32),
            cond_offsets=np.asarray(cond_offsets, dtype=np.int32),
            cond_sizes=np.asarray(cond_sizes, dtype=np.int32),
        )


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from explicit uniforms, the JAX package's formula
    (``activate_pallas.py:195``)."""
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def apply_activate(x: torch.Tensor, spec: SegmentSpec,
                   u: torch.Tensor) -> torch.Tensor:
    """tanh on scalar dims, Gumbel-softmax (tau=0.2) within every softmax
    segment, in float32 (float64 for a float64 ``x``); ``u`` holds the
    uniforms behind the Gumbel noise.

    Each segment is stabilised by its OWN max: a row-global max would let
    a far-away large logit push a whole segment's ``exp`` into float32
    underflow.  A zero denominator is guarded as the TPU kernel does."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dtype)
    n = x.shape[0]
    noisy = (x + gumbel(u.to(dtype))) / GUMBEL_TAU
    ids = torch.as_tensor(spec.segment_ids, dtype=torch.long,
                          device=x.device).expand(n, -1)
    seg_max = torch.full((n, spec.n_segments), -torch.inf, dtype=dtype,
                         device=x.device)
    seg_max = seg_max.scatter_reduce(1, ids, noisy, "amax")
    e = torch.exp(noisy - seg_max.gather(1, ids))
    seg_sum = torch.zeros((n, spec.n_segments), dtype=dtype, device=x.device)
    denom = seg_sum.scatter_add(1, ids, e).gather(1, ids)
    soft = e / (denom + (denom == 0))
    is_tanh = torch.as_tensor(spec.is_tanh_dim, device=x.device)
    return torch.where(is_tanh, torch.tanh(x), soft)


def apply_activate_bwd(dy: torch.Tensor, out: torch.Tensor,
                       spec: SegmentSpec) -> torch.Tensor:
    """The analytic VJP of :func:`apply_activate` with respect to ``x``,
    from the forward output alone (the plain version of kernel K2,
    ``fed_tgan_tpu/ops/activate_pallas.py:102``): on softmax dims
    ``out * (dy - segsum(dy * out)) / tau``, on tanh dims
    ``(1 - out^2) * dy``."""
    n = dy.shape[0]
    ids = torch.as_tensor(spec.segment_ids, dtype=torch.long,
                          device=dy.device).expand(n, -1)
    inner = torch.zeros((n, spec.n_segments), dtype=dy.dtype,
                        device=dy.device).scatter_add(1, ids, dy * out)
    dx_soft = out * (dy - inner.gather(1, ids)) / GUMBEL_TAU
    is_tanh = torch.as_tensor(spec.is_tanh_dim, device=dy.device)
    return torch.where(is_tanh, (1.0 - out * out) * dy, dx_soft)


@functools.lru_cache(maxsize=64)
def cond_tables(spec: SegmentSpec, device: torch.device) -> dict:
    """The conditional view's index arrays as int64 tensors on ``device``
    (``discrete_dims``, ``cond_column_ids``, ``cond_offsets``), copied to
    the device once per (spec, device), not on every training step."""
    return {name: torch.as_tensor(getattr(spec, name), dtype=torch.long,
                                  device=device)
            for name in ("discrete_dims", "cond_column_ids", "cond_offsets")}


def _column_max(logits: torch.Tensor, col_ids: torch.Tensor,
                n_columns: int) -> torch.Tensor:
    """(batch, n_columns) max of ``logits`` over each column's positions."""
    ids = col_ids.expand(logits.shape[0], -1)
    init = torch.full((logits.shape[0], n_columns), -torch.inf,
                      dtype=logits.dtype, device=logits.device)
    return init.scatter_reduce(1, ids, logits, "amax")


def cond_loss(data: torch.Tensor, spec: SegmentSpec, cond_vec: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Masked cross-entropy between the generated discrete logits and the
    conditioning one-hot (``fed_tgan_tpu/ops/segments.py:144``).

    ``data`` (batch, dim) raw generator output, ``cond_vec`` (batch,
    n_opt), ``mask`` (batch, n_discrete) with a 1 at each row's
    conditioned column.  The float32 logsumexp is stabilised by a detached
    per-column max."""
    data = data.float()
    tables = cond_tables(spec, data.device)
    dims, col_ids = tables["discrete_dims"], tables["cond_column_ids"]
    logits = data[:, dims]  # (batch, n_opt)
    m = _column_max(logits.detach(), col_ids, spec.n_discrete)
    shifted = logits - m[:, col_ids]
    zeros = torch.zeros((data.shape[0], spec.n_discrete), device=data.device)
    lse = torch.log(zeros.index_add(1, col_ids, torch.exp(shifted))) + m
    target = zeros.index_add(1, col_ids, logits * cond_vec)
    return ((lse - target) * mask).sum() / data.shape[0]
