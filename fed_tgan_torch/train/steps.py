"""Training configuration and the sampling step
(counterpart of ``fed_tgan_tpu/train/steps.py:40-47, 406-426``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from fed_tgan_torch.models.ctgan import Generator
from fed_tgan_torch.ops.activate_cuda import fused_apply_activate
from fed_tgan_torch.ops.segments import SegmentSpec


@dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters, with the JAX package's field names and defaults
    (the reference's, Server/dtds/synthesizers/ctgan.py:309-334).  Only
    the sampling fields are read by this package so far; the rest ride
    along so a JAX artifact's config converts without loss."""

    embedding_dim: int = 128
    gen_dims: tuple = (256, 256)
    dis_dims: tuple = (256, 256)
    batch_size: int = 500
    pac: int = 10
    l2scale: float = 1e-6
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.9
    ema_decay: float = 0.0
    lr_schedule: str = "constant"
    lr_decay_steps: int = 0
    lr_end_frac: float = 0.0
    d_steps: int = 1
    allow_zero_step_clients: bool = False
    aggregator: str = "weighted"
    update_gate: bool = True
    gate_norm_factor: float = 10.0
    update_clip: float = 3.0
    trim_ratio: float = 0.2
    precision: str = "f32"
    cohort: int = 0
    aggregation: str = "sync"
    staleness_discount: float = 0.5


def require_f32(cfg: TrainConfig) -> None:
    """Sampling runs in float32 only; bf16 serving is not ported yet."""
    if cfg.precision != "f32":
        raise NotImplementedError(
            f"precision={cfg.precision!r}: only f32 sampling is ported")


def sample_step(generator: Generator, spec: SegmentSpec, z: torch.Tensor,
                cond_vec: Optional[torch.Tensor], u: torch.Tensor,
                block_rows: int) -> torch.Tensor:
    """Activated generator output for explicit draws: noise ``z``
    (rows, embedding_dim), conditional vectors ``cond_vec`` (rows, n_opt;
    None when the table has no softmax segment) and Gumbel uniforms ``u``
    (rows, spec.dim).  ``generator`` must be in eval mode.

    The generator runs over fixed blocks of ``block_rows`` rows (``rows``
    must be a multiple): every block is then the same matrix-product shape
    whatever ``rows`` is, so a row's value never depends on how many rows
    were computed beside it.  The activation is row-wise and runs once
    over all rows."""
    x = z if cond_vec is None else torch.cat([z, cond_vec], dim=1)
    with torch.no_grad():
        raw = torch.cat([generator(b) for b in x.split(block_rows)])
        return fused_apply_activate(raw, spec, u.contiguous())
