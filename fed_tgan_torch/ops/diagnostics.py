"""Gradient-flow diagnostics (counterpart of ``fed_tgan_tpu/ops/diagnostics.py``).

The reference ships (commented-out) matplotlib gradient-flow plotting
inside its training loop for debugging vanishing or exploding gradients
(reference ``Server/dtds/synthesizers/ctgan.py:261-306``).  Here it is a
function over one D step's and one G step's gradients, taken through the
same batch path as :mod:`fed_tgan_torch.train.steps` (on the card: K1
forward, and K2 in the generator's backward) and summarized per layer,
plus an optional matplotlib rendering.  It never touches the hot loop and
changes no state of the models (their BatchNorm running statistics are
restored, no ``.grad`` is written): call it ad hoc when a run misbehaves.
matplotlib is imported only by :func:`plot_gradient_flow`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fed_tgan_torch.models.losses import gradient_penalty
from fed_tgan_torch.ops.activate_cuda import fused_apply_activate
from fed_tgan_torch.ops.segments import cond_loss
from fed_tgan_torch.runtime.precision import f32_island, resolve_precision
from fed_tgan_torch.train.sampler import CondSampler, RowSampler
from fed_tgan_torch.train.steps import Models, StepDraws, _grads, draw_step

__all__ = ["gradient_flow", "plot_gradient_flow", "summarize_grads"]


def summarize_grads(named_grads) -> dict:
    """``{name: {"avg_abs": float, "max_abs": float}}`` over ``(name,
    gradient)`` pairs: the per-layer statistics the reference's plot
    collects (``ave_grads`` / ``max_grads``)."""
    out = {}
    for name, g in named_grads:
        a = g.detach().float().abs()
        out[name] = {"avg_abs": float(a.mean()), "max_abs": float(a.max())}
    return out


def gradient_flow(models: Models, data: torch.Tensor, cond: CondSampler,
                  rows: RowSampler, draws: Optional[StepDraws] = None,
                  gen: Optional[torch.Generator] = None) -> dict:
    """Per-layer gradient statistics of one D step and one G step at the
    models' current weights (``fed_tgan_tpu/ops/diagnostics.py:43-101``).

    ``draws`` are one train step's draws in JAX's ``split(key, 13)``
    layout (:func:`~fed_tgan_torch.train.steps.draw_step` from ``gen``
    when omitted): the critic's block (keys 0-8) builds the batch and the
    penalty, and, as in JAX, the generator step reuses the critic's
    generator input with its own Gumbel uniforms and dropout masks (keys
    11 and 12).  ``data`` is the encoded matrix on the models' device."""
    spec, cfg = models.spec, models.cfg
    pol = resolve_precision(cfg.precision)
    G, D = models.generator, models.discriminator
    if draws is None:
        draws = draw_step(gen, models)
    d, g = draws.d[0], draws.g
    saved = [b.detach().clone() for b in G.buffers()]
    try:
        if spec.n_discrete:
            c1, m1, col, opt = cond.train_from_draws(d.col, d.r)
            row_idx = rows.sample_rows(col[d.perm], opt[d.perm], d.row_u)
            gen_in = torch.cat([d.z, c1], dim=1)
        else:
            row_idx = rows.sample_uniform(d.row_u)
            gen_in = d.z
        real = data[row_idx]
        with torch.no_grad():
            fake = fused_apply_activate(G(pol.cast(gen_in)), spec, d.u)
        if spec.n_discrete:
            fake_cat = torch.cat([fake, pol.cast(c1)], dim=1)
            real_cat = pol.cast(torch.cat([real, c1[d.perm]], dim=1))
        else:
            fake_cat, real_cat = fake, pol.cast(real)
        d_params = list(D.named_parameters())
        y_fake = D(fake_cat, keep=d.keep_fake)
        y_real = D(real_cat, keep=d.keep_real)
        loss_d = f32_island(y_fake).mean() - f32_island(y_real).mean()
        pen = gradient_penalty(lambda x: D(x, keep=d.keep_gp), real_cat,
                               fake_cat, d.alpha, pac=cfg.pac)
        # one backward pass per term, as the train step takes them
        grads_d = _grads([p for _, p in d_params], loss_d, pen)

        g_params = list(G.named_parameters())
        raw = G(pol.cast(gen_in))
        act = fused_apply_activate(raw, spec, g.u)  # K1; K2 in backward
        d_in = (torch.cat([act, pol.cast(c1)], dim=1) if spec.n_discrete
                else act)
        loss_g = -f32_island(D(d_in, keep=g.keep)).mean()
        if spec.n_discrete:
            loss_g = loss_g + cond_loss(raw, spec, c1, m1)
        grads_g = _grads([p for _, p in g_params], loss_g)
    finally:
        with torch.no_grad():
            for b, s in zip(G.buffers(), saved):
                b.copy_(s)
    return {
        "discriminator": summarize_grads(
            (name, gr) for (name, _), gr in zip(d_params, grads_d)),
        "generator": summarize_grads(
            (name, gr) for (name, _), gr in zip(g_params, grads_g)),
    }


def plot_gradient_flow(stats: dict, path: Optional[str] = None):
    """Render the reference's gradient-flow bar chart (avg and max abs per
    layer).  Requires matplotlib; returns the figure (saved to ``path``
    if given)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(stats), figsize=(7 * len(stats), 4))
    if len(stats) == 1:
        axes = [axes]
    for ax, (net, layers) in zip(axes, stats.items()):
        names = list(layers)
        avg = [layers[n]["avg_abs"] for n in names]
        mx = [layers[n]["max_abs"] for n in names]
        x = np.arange(len(names))
        ax.bar(x, mx, alpha=0.4, label="max |grad|")
        ax.bar(x, avg, alpha=0.8, label="avg |grad|")
        ax.set_xticks(x)
        ax.set_xticklabels(names, rotation=90, fontsize=6)
        ax.set_yscale("log")
        ax.set_title(f"gradient flow: {net}")
        ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig
