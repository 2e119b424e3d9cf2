"""Mixed-precision policy: bf16 compute with f32 islands
(counterpart of ``fed_tgan_tpu/runtime/precision.py``).

One small frozen policy, resolved from ``TrainConfig.precision``
(``"f32"`` | ``"bf16"``), is read by every layer that does arithmetic:

- the models run their linear layers on parameters cast to the COMPUTE
  dtype of their input (``models/ctgan.py``); the master parameters, the
  BatchNorm running statistics and the Adam moments stay float32, and
  autograd returns float32 gradients through the casts, as ``jax.grad``
  does through ``convert_element_type``;
- numerically fragile parts stay float32 ISLANDS in either mode:
  BatchNorm's statistics (``models/ctgan.py``), the gradient penalty's
  slerp and norm (``models/losses.py``), the loss means
  (``train/steps.py``), the Gumbel logits inside K1 and ``cond_loss``
  (``ops/segments.py``, ``ops/activate_cuda.py``), decode (the sampled rows
  are float32 before it) and the FedAvg accumulation
  (``parallel/fedavg.py``);
- the aggregation payload is re-encoded to bf16 (``payload_dtype``):
  each round's weighted step is rounded once, then added to the float32
  previous weights.

In f32 mode :meth:`Precision.cast` returns the very tensor it was given,
not a copy, and every island's ``.float()`` of a float32 tensor is that
tensor too: the f32 path runs the same operations as before the policy
existed, bit for bit.

Resolving ``"bf16"`` sets ``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction`` to False, for the whole process:
cuBLAS may otherwise reduce a bf16 GEMM's partial sums in bf16, where the
TPU's matrix unit accumulates bf16 products in float32.  TF32 stays off
for float32 products (``fed_tgan_torch/__init__.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

PRECISIONS = ("f32", "bf16")


@dataclass(frozen=True)
class Precision:
    """A resolved precision policy; get one from :func:`resolve_precision`."""

    name: str  # "f32" | "bf16"

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype of the linear layers and activations."""
        return torch.bfloat16 if self.name == "bf16" else torch.float32

    @property
    def param_dtype(self) -> torch.dtype:
        """Master parameters and optimizer moments: always float32."""
        return torch.float32

    @property
    def payload_dtype(self) -> Optional[torch.dtype]:
        """The aggregation payload's dtype (None: leave it float32)."""
        return torch.bfloat16 if self.name == "bf16" else None

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the compute dtype when it is floating, else ``x``.  In
        f32 mode ``x`` itself, never a copy."""
        if self.name == "f32" or not x.is_floating_point():
            return x
        return as_dtype(x, self.compute_dtype)


_POLICIES = {name: Precision(name) for name in PRECISIONS}


def resolve_precision(name: str) -> Precision:
    """The policy of ``name``; raises ``ValueError`` for anything but
    :data:`PRECISIONS`."""
    if name not in _POLICIES:
        raise ValueError(
            f"unknown precision {name!r}; expected one of {PRECISIONS}")
    if name == "bf16":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
    return _POLICIES[name]


def as_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``: ``x`` itself when it has it, with no call into
    PyTorch, so the f32 path's casts cost the host nothing."""
    return x if x.dtype == dtype else x.to(dtype)


def f32_island(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 for a fragile region (``x`` itself when it is
    float32 already)."""
    return as_dtype(x, torch.float32)
