"""The reference's federated CTGAN rounds, client by client.

Per client, per local step (the reference server's loop,
``Server/dtds/distributed.py:328-417``, in the program's documented
order): a critic update (a conditional vector and a class-conditional
real batch, the fake batch from the generator in train mode without a
gradient, the WGAN loss plus the slerp gradient penalty, each gradient
from its own backward pass, Adam) and a generator update
(``-mean(D(fake)) + cond_loss``, Adam with L2).  After every client's
local steps the round gates the updates (a client whose update norm is
over 10x or under 1/10 of the median is left out) and writes the
similarity-weighted average of the generators, critics and BatchNorm
running statistics into every client; Adam's state stays per client.

The random draws of client i come from a ``torch.Generator`` on the
device seeded with ``seed_of(seed, i)``, in the program's documented
order (critic: noise, column, option uniform, permutation, row
uniforms, Gumbel uniforms, three sets of dropout keeps, slerp
positions; generator: noise, column, option uniform, Gumbel uniforms,
keeps).  The activation and its gradient are plain PyTorch under
autograd.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

TAU = 0.2
GP_LAMBDA = 10.0
LEAKY = 0.2
DROPOUT = 0.5


def seed_of(stream: int, step: int) -> int:
    """The 64-bit seed of step ``step`` of stream ``stream``."""
    seq = np.random.SeedSequence([stream % 2**64, step])
    return int(seq.generate_state(1, np.uint64)[0])


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 matrix products on or off inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Residual(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.fc = nn.Linear(i, o)
        self.bn = nn.BatchNorm1d(o)

    def forward(self, x):
        return torch.cat([torch.relu(self.bn(self.fc(x))), x], dim=1)


class Generator(nn.Module):
    def __init__(self, in_dim, dims, out_dim):
        super().__init__()
        blocks, d = [], in_dim
        for h in dims:
            blocks.append(Residual(d, h))
            d += h
        self.blocks = nn.ModuleList(blocks)
        self.out = nn.Linear(d, out_dim)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return self.out(x)


class Discriminator(nn.Module):
    def __init__(self, in_dim, dims, pac):
        super().__init__()
        self.pac = pac
        layers, d = [], in_dim * pac
        for h in dims:
            layers.append(nn.Linear(d, h))
            d = h
        self.layers = nn.ModuleList(layers)
        self.out = nn.Linear(d, 1)

    def forward(self, x, keep):
        h = x.reshape(x.shape[0] // self.pac, -1)
        for layer, k in zip(self.layers, keep):
            h = F.leaky_relu(layer(h), LEAKY)
            h = torch.where(k, h / (1.0 - DROPOUT), 0.0)
        return self.out(h)


class Layout:
    """Index views of the encoded layout: every softmax segment is a
    conditional column."""

    def __init__(self, segments):
        self.segments = segments
        self.dim = sum(w for _, w, _ in segments)
        self.soft = [(s, w) for s, w, k in segments if k == "softmax"]
        self.n_opt = sum(w for _, w in self.soft)
        self.cond_start = np.concatenate(
            [[0], np.cumsum([w for _, w in self.soft])[:-1]]).astype(np.int64)
        width = max(w for _, w in self.soft)
        self._idx = np.asarray([[s + min(k, w - 1) for k in range(width)]
                                for s, w in self.soft])
        self._valid = np.asarray([[k < w for k in range(width)]
                                  for _, w in self.soft])
        self._on = {}

    def padded(self, device):
        """``(idx, valid)``: each softmax segment's dims as a row, padded
        to the widest (n_segments, width)."""
        key = str(device)
        if key not in self._on:
            self._on[key] = (torch.as_tensor(self._idx, device=device),
                             torch.as_tensor(self._valid, device=device))
        return self._on[key]


def activate(x, layout: Layout, u):
    """tanh on tanh dims, Gumbel-softmax (tau 0.2) within each softmax
    segment, the Gumbel noise from the uniforms ``u``: every segment
    gathered into a row of a padded table, a softmax over it, and the
    results put back in place."""
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    idx, valid = layout.padded(x.device)
    noisy = ((x + g) / TAU)[:, idx]
    soft = torch.softmax(noisy.masked_fill(~valid, -torch.inf), dim=2)
    out = torch.tanh(x)
    return out.index_put((torch.arange(x.shape[0], device=x.device)[:, None],
                          idx[valid][None]), soft[:, valid])


def cond_loss(raw, layout: Layout, col, opt):
    """Cross-entropy of each row's conditioned column, summed over rows
    and divided by the batch."""
    idx, valid = layout.padded(raw.device)
    logits = raw[:, idx].gather(1, col[:, None, None].expand(
        -1, 1, idx.shape[1]))[:, 0]
    logits = logits.masked_fill(~valid[col], -torch.inf)
    return F.cross_entropy(logits, opt, reduction="sum") / raw.shape[0]


def slerp(val, low, high):
    low_n = low / torch.linalg.vector_norm(low, dim=1, keepdim=True)
    high_n = high / torch.linalg.vector_norm(high, dim=1, keepdim=True)
    omega = torch.arccos(torch.clamp((low_n * high_n).sum(1, keepdim=True),
                                     -1.0, 1.0))
    so = torch.sin(omega)
    par = so.abs() < 1e-7
    safe = torch.where(par, 1.0, so)
    sl = (torch.sin((1.0 - val) * omega) / safe * low
          + torch.sin(val * omega) / safe * high)
    return torch.where(par, (1.0 - val) * low + val * high, sl)


def penalty(D, real, fake, alpha, keep, pac):
    x = slerp(alpha, real.detach(), fake.detach()).requires_grad_(True)
    (g,) = torch.autograd.grad(D(x, keep).sum(), x, create_graph=True)
    norms = torch.linalg.vector_norm(g.reshape(-1, pac * real.shape[1]), dim=1)
    return ((norms - 1.0) ** 2).mean() * GP_LAMBDA


class Client:
    """One data holder: its encoded rows, samplers, models, Adam states
    and draw stream."""

    def __init__(self, data, layout, cfg, G, D, stream, device):
        self.layout, self.cfg, self.device = layout, cfg, device
        self.data = torch.as_tensor(data, device=device)
        self.G, self.D = G, D
        self.opt_g = torch.optim.Adam(G.parameters(), lr=cfg["lr"],
                                      betas=(cfg["beta1"], cfg["beta2"]),
                                      weight_decay=cfg["l2scale"])
        self.opt_d = torch.optim.Adam(D.parameters(), lr=cfg["lr"],
                                      betas=(cfg["beta1"], cfg["beta2"]))
        self.gen = torch.Generator(device=device).manual_seed(stream)
        # per conditional column: the log-frequency table (zero-padded)
        # and the rows holding each option, grouped by option in row order
        width = max(w for _, w in layout.soft)
        p_train = np.zeros((len(layout.soft), width))
        self.pool, self.offsets, self.counts = [], [], []
        for c, (start, w) in enumerate(layout.soft):
            slots = data[:, start:start + w].argmax(axis=1)
            freq = np.bincount(slots, minlength=w).astype(np.float64)
            logf = np.log(freq + 1.0)
            p_train[c, :w] = logf / logf.sum()
            self.pool.append(np.argsort(slots, kind="stable"))
            self.offsets.append(np.concatenate([[0], np.cumsum(freq)[:-1]])
                                .astype(np.int64))
            self.counts.append(freq.astype(np.float32))
        self.cdf = torch.cumsum(torch.as_tensor(
            p_train.astype(np.float32), device=device), dim=1)
        self.cond_start = torch.as_tensor(layout.cond_start, device=device)
        self.steps = len(data) // cfg["batch_size"]

    # ---------------------------------------------------------- draws
    def _u(self, shape):
        return torch.rand(shape, generator=self.gen, device=self.device)

    def _keep(self):
        B, pac = self.cfg["batch_size"], self.cfg["pac"]
        return [self._u((B // pac, h)) < 1.0 - DROPOUT
                for h in self.cfg["dis_dims"]]

    def _cond(self):
        B = self.cfg["batch_size"]
        col = torch.randint(0, len(self.layout.soft), (B,),
                            generator=self.gen, device=self.device)
        return col, self._u((B, 1))

    def _noise(self):
        return torch.randn((self.cfg["batch_size"], self.cfg["embedding_dim"]),
                           generator=self.gen, device=self.device)

    def _pick(self, col, r):
        """Options by inverse CDF of each row's column; the cond vector."""
        opt = (self.cdf[col] > r).to(torch.int8).argmax(dim=1)
        vec = torch.zeros((len(col), self.layout.n_opt), device=self.device)
        vec[torch.arange(len(col), device=self.device),
            self.cond_start[col] + opt] = 1.0
        return opt, vec

    def _real_rows(self, col, opt, u):
        """A row holding each (column, option), picked by ``u``."""
        col_h, opt_h = col.cpu().numpy(), opt.cpu().numpy()
        cnt = np.asarray([max(self.counts[c][o], 1.0)
                          for c, o in zip(col_h, opt_h)], dtype=np.float32)
        pos = (u * torch.as_tensor(cnt, device=self.device)).to(torch.long)
        idx = [self.pool[c][min(self.offsets[c][o] + p, len(self.pool[c]) - 1)]
               for c, o, p in zip(col_h, opt_h, pos.cpu().numpy())]
        return torch.as_tensor(np.asarray(idx), device=self.device)

    # ----------------------------------------------------------- step
    def step(self):
        """One critic and one generator update; ``(loss_d, pen, loss_g)``."""
        B, pac, lay = self.cfg["batch_size"], self.cfg["pac"], self.layout
        z = self._noise()
        col, r = self._cond()
        perm = torch.randperm(B, generator=self.gen, device=self.device)
        row_u = self._u((B,))
        u = self._u((B, lay.dim))
        keep_fake, keep_real, keep_gp = self._keep(), self._keep(), self._keep()
        alpha = self._u((B, 1))
        opt, c1 = self._pick(col, r)
        real = self.data[self._real_rows(col[perm], opt[perm], row_u)]
        with torch.no_grad():
            fake = activate(self.G(torch.cat([z, c1], dim=1)), lay, u)
        fake_cat = torch.cat([fake, c1], dim=1)
        real_cat = torch.cat([real, c1[perm]], dim=1)
        loss_d = (self.D(fake_cat, keep_fake).mean()
                  - self.D(real_cat, keep_real).mean())
        pen = penalty(self.D, real_cat, fake_cat, alpha, keep_gp, pac)
        params = list(self.D.parameters())
        g1 = torch.autograd.grad(loss_d, params)
        g2 = torch.autograd.grad(pen, params, allow_unused=True)
        for p, a, b in zip(params, g1, g2):
            p.grad = a if b is None else a + b
        self.opt_d.step()

        z = self._noise()
        col, r = self._cond()
        u = self._u((B, lay.dim))
        keep = self._keep()
        opt, c1 = self._pick(col, r)
        raw = self.G(torch.cat([z, c1], dim=1))
        act = activate(raw, lay, u)
        loss_g = (-self.D(torch.cat([act, c1], dim=1), keep).mean()
                  + cond_loss(raw, lay, col, opt))
        params = list(self.G.parameters())
        for p, g in zip(params, torch.autograd.grad(loss_g, params)):
            p.grad = g
        self.opt_g.step()
        return loss_d.detach(), pen.detach(), loss_g.detach()


def shared_state(G, D) -> dict:
    """The averaged leaves: every parameter and the running statistics."""
    out = {f"G.{k}": v for k, v in G.named_parameters()}
    out.update({f"D.{k}": v for k, v in D.named_parameters()})
    for j, b in enumerate(G.blocks):
        out[f"G.blocks.{j}.bn.running_mean"] = b.bn.running_mean
        out[f"G.blocks.{j}.bn.running_var"] = b.bn.running_var
    return out


def _median(x: torch.Tensor) -> torch.Tensor:
    s = torch.sort(x).values
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


@torch.no_grad()
def aggregate(clients: list, prev: dict, weights: np.ndarray,
              gate_factor: float) -> np.ndarray:
    """Gate, average and write the result into every client; returns
    the gate's rejections."""
    states = [shared_state(c.G, c.D) for c in clients]
    norms = torch.stack([torch.sqrt(sum(
        ((s[k].float() - prev[k]) ** 2).sum() for k in prev))
        for s in states])
    med = _median(norms)
    bad = (norms > gate_factor * med) | (norms * gate_factor < med)
    if not (torch.isfinite(med) and med > 0):
        bad = torch.zeros_like(bad)
    w = torch.as_tensor(weights, dtype=torch.float32, device=norms.device)
    if bad.any():
        w = torch.where(bad, 0.0, w)
        w = w / w.sum()
    for k in prev:
        avg = sum(w[i] * torch.where(bad[i], prev[k], s[k])
                  for i, s in enumerate(states))
        for s in states:
            s[k].copy_(avg)
    return bad.cpu().numpy()


def init_models(in_g, dim, cfg, seed):
    """The initial generator and critic, made on the CPU from ``seed`` in
    construction order (generator, then critic)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        G = Generator(in_g, cfg["gen_dims"], dim)
        D = Discriminator(dim + (in_g - cfg["embedding_dim"]),
                          cfg["dis_dims"], cfg["pac"])
    return G, D


def run(ref_init, cfg: dict, seed: int, rounds: int, device,
        tf32: bool = False, on_round=None) -> list:
    """``rounds`` federated rounds from the reference init; returns the
    clients.  ``on_round(r, clients, metrics (P, 3))`` after each round's
    aggregation."""
    layout = Layout(ref_init.segments)
    in_g = cfg["embedding_dim"] + layout.n_opt
    G0, D0 = init_models(in_g, layout.dim, cfg, seed)
    clients = []
    for i, m in enumerate(ref_init.matrices):
        G = Generator(in_g, cfg["gen_dims"], layout.dim)
        D = Discriminator(layout.dim + layout.n_opt, cfg["dis_dims"],
                          cfg["pac"])
        G.load_state_dict(G0.state_dict())
        D.load_state_dict(D0.state_dict())
        clients.append(Client(m, layout, cfg, G.to(device).train(),
                              D.to(device).train(), seed_of(seed, i), device))
    with matmul_precision(tf32):
        for r in range(rounds):
            prev = {k: v.detach().clone().float()
                    for k, v in shared_state(clients[0].G,
                                             clients[0].D).items()}
            metrics = []
            for c in clients:
                last = (0.0, 0.0, 0.0)
                for _ in range(c.steps):
                    last = c.step()
                metrics.append([float(x) for x in last])
            aggregate(clients, prev, ref_init.weights, cfg["gate_norm_factor"])
            if on_round is not None:
                on_round(r, clients, np.asarray(metrics))
    return clients
