"""The reference's snapshot: rows sampled from the aggregated generator
and decoded as the packed8 snapshot layout defines them.

Step s (500 rows) of stream ``seed + round + 29`` draws from a generator
seeded with ``seed_of(stream, s)``: noise, a column and its option
uniform (the option by inverse CDF of the pooled empirical frequencies),
then the Gumbel uniforms.  The generator runs in eval mode over 500-row
blocks, then the activation.  A continuous value is its clipped scalar
rounded half to even to a multiple of 1/127, times ``4 sigma_k`` plus
``mu_k`` of the argmax mode k (``exp(x) - 1`` for a non-negative column,
rounded up when negative); a categorical value is the argmax slot's
category.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ctgan import Layout, activate, seed_of

KEY_OFFSET = 29
U_SCALE = 127


@torch.no_grad()
def sample(G, ref_init, cfg: dict, rows: int, stream: int, device) -> dict:
    """``({column: values}, {column: (steps, non-negative)})`` for rows
    [0, rows) of ``stream``: float64 values or category strings, and for
    a continuous column each row's packed8 step ``4 sigma_k / 127``."""
    layout = Layout(ref_init.segments)
    B, emb = cfg["batch_size"], cfg["embedding_dim"]
    data = np.concatenate(ref_init.matrices)
    width = max(w for _, w in layout.soft)
    p = np.zeros((len(layout.soft), width))
    for c, (start, w) in enumerate(layout.soft):
        freq = data[:, start:start + w].sum(axis=0).astype(np.float64)
        p[c, :w] = freq / freq.sum()
    cdf = torch.cumsum(torch.as_tensor(p.astype(np.float32), device=device),
                       dim=1)
    cond_start = torch.as_tensor(layout.cond_start, device=device)
    G.eval()
    gen = torch.Generator(device=device)
    outs = []
    for s in range(-(-rows // B)):
        gen.manual_seed(seed_of(stream, s))
        z = torch.randn((B, emb), generator=gen, device=device)
        col = torch.randint(0, len(layout.soft), (B,), generator=gen,
                            device=device)
        r = torch.rand((B, 1), generator=gen, device=device)
        u = torch.rand((B, layout.dim), generator=gen, device=device)
        opt = (cdf[col] > r).to(torch.int8).argmax(dim=1)
        vec = torch.zeros((B, layout.n_opt), device=device)
        vec[torch.arange(B, device=device), cond_start[col] + opt] = 1.0
        outs.append(activate(G(torch.cat([z, vec], dim=1)), layout, u))
    G.train()
    enc = torch.cat(outs)[:rows].double().cpu().numpy()
    out, quanta, pos = {}, {}, 0
    for c in ref_init.columns:
        if c.kind == "cont":
            g = c.mixture
            mu, sg = g.means[g.active], g.stds[g.active]
            uq = np.round(np.clip(enc[:, pos].astype(np.float32), -1.0, 1.0)
                          * U_SCALE).astype(np.float64)
            k = enc[:, pos + 1:pos + c.width].argmax(axis=1)
            x = uq / U_SCALE * 4.0 * sg[k] + mu[k]
            quanta[c.name] = (4.0 * sg[k] / U_SCALE, c.non_negative)
            if c.non_negative:
                x = np.exp(x) - 1.0
                x = np.where(x < 0, np.ceil(x), x)
            out[c.name] = x
        else:
            k = enc[:, pos:pos + c.width].argmax(axis=1)
            out[c.name] = np.asarray(c.vocab, dtype=object)[k]
        pos += c.width
    return out, quanta
