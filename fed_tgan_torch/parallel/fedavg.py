"""Weighted federated averaging and the Byzantine-robust aggregators over a
stacked client axis on one device
(counterpart of ``fed_tgan_tpu/parallel/fedavg.py:39-56, 129-312``).

Where the JAX package reduces over a ``clients`` mesh axis with ``psum``
and ``all_gather``, here every leaf carries the clients on its leading
axis, ``(n_clients, ...)``, and the reductions run over that axis on the
device.  ``prev`` is the global pre-round state, one tensor per leaf
without the client axis.

- :func:`weighted_average`: ``sum_i w_i * leaf_i`` in float32.
- :func:`weighted_delta_average`: the bf16 mode's aggregation
  (``fed_tgan_tpu/parallel/fedavg.py:59-113``): the float32 weighted delta
  against the previous weights, rounded once to the payload dtype, cast
  back and added to the float32 previous weights.  On one card nothing
  crosses a wire, so the rounding saves no bytes here: it is kept because
  it changes the averaged weights, which must be what JAX computes.
- :func:`robust_aggregate`: the update gate (non-finite deltas and a
  two-sided median-based norm outlier test), the survivors' renormalized
  weights, then one of ``weighted | clipped | trimmed | median``.  When
  every live client passes the gate, the effective weights are the
  original ones, so ``weighted`` equals :func:`weighted_average` bit for
  bit on a clean round.  ``payload_dtype`` rounds what each aggregator
  gathers or sums (``fedavg.py:242-296``); the gate's norms stay
  float32.

Medians average the two middle values and skip NaN, as ``jnp.nanmedian``
does (``torch.median`` would return the lower one).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from fed_tgan_torch.analysis.sanitizers import nan_sentinels

EPS = 1e-12
AGGREGATORS = ("weighted", "clipped", "trimmed", "median")


def agg_leaves(stack) -> list[torch.Tensor]:
    """The stacked tensors the clients contribute to the aggregate, each
    ``(n_clients, ...)`` and a view into ``stack`` (a
    :class:`~fed_tgan_torch.train.steps.StackedModels`), in the JAX
    package's leaf order of ``(params_g, params_d, state_g)``: per
    generator block its BatchNorm bias and scale, then its Linear bias and
    weight; the generator's output Linear; the discriminator's layers and
    output (bias, weight); per generator block its BatchNorm running mean
    and variance.  ``num_batches_tracked`` is not part of it."""
    G, D = stack.generator, stack.discriminator
    g, d = G.leaves(), D.leaves()
    out = []
    for j in range(len(G.widths)):
        out += [g[f"blocks.{j}.{k}"] for k in ("bn.bias", "bn.weight",
                                                "fc.bias", "fc.weight")]
    out += [g["out.bias"], g["out.weight"]]
    for j in range(len(D.widths)):
        out += [d[f"layers.{j}.bias"], d[f"layers.{j}.weight"]]
    out += [d["out.bias"], d["out.weight"]]
    for j, h in enumerate(G.widths):
        out += [x.view(G.n, h) for x in G.running(j)]
    return out


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def nanmedian(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The median over ``dim`` of the non-NaN entries, the mean of the two
    middle ones for an even count; NaN where every entry is NaN."""
    nan = torch.isnan(x)
    m = (~nan).sum(dim, keepdim=True)
    srt = torch.sort(torch.where(nan, torch.inf, x), dim=dim).values
    lo = srt.gather(dim, torch.clamp((m - 1) // 2, min=0))
    hi = srt.gather(dim, torch.clamp(m // 2, max=x.shape[dim] - 1))
    med = (lo + hi) * 0.5
    return torch.where(m > 0, med, torch.nan).squeeze(dim)


def weighted_average(stacks: Sequence[torch.Tensor],
                     weights: torch.Tensor) -> list[torch.Tensor]:
    """``sum_i w_i * leaf_i`` over the leading client axis of each leaf,
    in float32."""
    w = weights.to(torch.float32)
    return [torch.tensordot(w, s.to(torch.float32), dims=1).to(s.dtype)
            for s in stacks]


def weighted_delta_average(prev: Sequence[torch.Tensor],
                           new: Sequence[torch.Tensor], weights: torch.Tensor,
                           payload_dtype: torch.dtype = torch.bfloat16,
                           renormalize: bool = False) -> list[torch.Tensor]:
    """``prev + round(sum_i w_i * (new_i - prev))`` per leaf: the float32
    weighted delta rounded once to ``payload_dtype``, then added to the
    float32 previous weights ``prev`` (one tensor per leaf, no client
    axis), so the rounding is confined to one round's step.  Equal to
    :func:`weighted_average` when the weights sum to 1, up to that
    rounding; ``renormalize`` divides the step by the weights' sum."""
    w = weights.to(torch.float32)
    wsum = torch.clamp(w.sum(), min=EPS) if renormalize else None
    out = []
    for p, n in zip(prev, new):
        p32 = p.to(torch.float32)
        d = n.to(torch.float32) - p32[None]
        step = torch.tensordot(w, d, dims=1).to(payload_dtype).to(
            torch.float32)
        if wsum is not None:
            step = step / wsum
        out.append((p32 + step).to(n.dtype))
    return out


def _payload(x: torch.Tensor, payload_dtype: Optional[torch.dtype]
             ) -> torch.Tensor:
    """``x`` as the aggregator receives it: rounded to ``payload_dtype``
    (None: as is), in float32."""
    if payload_dtype is not None:
        x = x.to(payload_dtype)
    return x.to(torch.float32)


def delta_norms(prev: Sequence[torch.Tensor], new: Sequence[torch.Tensor]):
    """``(finite, norm)`` per client over all leaves: whether its delta is
    finite everywhere, and the L2 norm of its finite entries, summed leaf
    by leaf in float32."""
    n = new[0].shape[0]
    finite = torch.ones(n, dtype=torch.bool, device=new[0].device)
    sumsq = torch.zeros(n, dtype=torch.float32, device=new[0].device)
    for p, x in zip(prev, new):
        d = (x.to(torch.float32) - p.to(torch.float32)[None]).reshape(n, -1)
        ok = torch.isfinite(d)
        finite = finite & ok.all(dim=1)
        sumsq = sumsq + torch.where(ok, d, 0.0).square().sum(dim=1)
    return finite, torch.sqrt(sumsq)


def robust_aggregate(prev: Sequence[torch.Tensor],
                     new: Sequence[torch.Tensor], weights: torch.Tensor,
                     steps: torch.Tensor, aggregator: str = "weighted",
                     update_gate: bool = True, gate_norm_factor: float = 10.0,
                     update_clip: float = 3.0, trim_ratio: float = 0.2,
                     payload_dtype: Optional[torch.dtype] = None):
    """Gate and aggregate stacked client leaves; returns ``(agg,
    quarantined)``: the global leaves and the (n_clients,) bool mask of
    live clients the gate rejected.  ``weights`` (n_clients,) is 0 for a
    dropped client; ``steps`` (n_clients,) counts each client's local
    steps this round (a zero-step client ships a zero delta and is never
    a norm outlier).  All of it stays on the device.

    ``payload_dtype`` (bf16 mode) rounds the aggregated payload: the
    weighted and clipped steps (re-anchored on the float32 ``prev``), and
    the leaves the trimmed mean and the median read.  The gate's norms
    stay float32: a poisoned update must not hide behind the rounding."""
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; "
                         "expected weighted|clipped|trimmed|median")
    finite, norm = delta_norms(prev, new)
    w = weights.to(device=norm.device, dtype=torch.float32)
    steps = steps.to(norm.device)
    alive, trained = w > 0, steps > 0
    if update_gate:
        consider = alive & finite & trained
        with nan_sentinels():  # NaN marks a client the median skips
            med = nanmedian(torch.where(consider, norm, torch.nan))
        med_ok = torch.isfinite(med) & (med > 0)
        bad = med_ok & trained & ((norm > gate_norm_factor * med)
                                  | (norm * gate_norm_factor < med))
        valid = alive & finite & ~bad
    else:
        with nan_sentinels():
            med = nanmedian(torch.where(alive & finite, norm, torch.nan))
        valid = alive & finite
    all_valid = (valid == alive).all()
    wz = torch.where(valid, w, 0.0)
    s = wz.sum()
    any_valid = s > 0
    w_eff = torch.where(all_valid, w, wz / torch.clamp(s, min=EPS))
    # invalid clients contribute the (finite) previous values: NaN * 0 is
    # NaN, so they are replaced before any weighted arithmetic
    san = [torch.where(_expand(valid, x), x, p[None]) for p, x in
           zip(prev, new)]

    if aggregator == "weighted":
        agg = (weighted_average(san, w_eff) if payload_dtype is None else
               weighted_delta_average(prev, san, w_eff, payload_dtype))
    elif aggregator == "clipped":
        safe_med = torch.where(torch.isfinite(med) & (med > 0), med, 1.0)
        scale = torch.clamp(update_clip * safe_med / torch.clamp(norm, min=EPS),
                            max=1.0)
        cw = w_eff * scale
        agg = [(p.to(torch.float32) + _payload(torch.tensordot(
            cw, x.to(torch.float32) - p.to(torch.float32)[None], dims=1),
            payload_dtype)).to(x.dtype) for p, x in zip(prev, san)]
    elif aggregator == "trimmed":
        m = valid.sum()
        t = torch.minimum(torch.floor(trim_ratio * m.to(torch.float32))
                          .to(m.dtype), torch.clamp((m - 1) // 2, min=0))
        agg = []
        for x in san:
            g = torch.where(_expand(valid, x), _payload(x, payload_dtype),
                            torch.inf)
            g = torch.sort(g, dim=0).values
            idx = _expand(torch.arange(x.shape[0], device=x.device), x)
            keep = (idx >= t) & (idx < m - t)
            total = torch.where(keep, g, 0.0).sum(dim=0)
            agg.append((total / torch.clamp(m - 2 * t, min=1)).to(x.dtype))
    else:
        with nan_sentinels():
            agg = [nanmedian(torch.where(_expand(valid, x),
                                         _payload(x, payload_dtype),
                                         torch.nan)).to(x.dtype) for x in san]
    # a gate that rejected everyone keeps the previous global state
    agg = [torch.where(any_valid, a, p.to(a.dtype)) for a, p in zip(agg, prev)]
    return agg, alive & ~valid
