"""The reference's federation init: shards, harmonized categories,
mixture fits, similarity weights and encoded matrices.

From the raw table alone, as the reference protocol defines them:

- IID shards: a seeded permutation of the rows split into equal parts,
  each part's rows in table order;
- a categorical column's global vocabulary is every value seen, ordered
  by total count (ties in the order first seen, client by client), and
  its integer code is its rank among the sorted values;
- a client's score per categorical column is the Jensen-Shannon distance
  of its counts to the global counts, per continuous column the
  Wasserstein distance of its mixture's rows-proportional sample to the
  pooled sample; each column's scores are divided by their sum over
  clients, and the weights are ``softmax((1 - d_i / sum(d)) * n_i / N)``;
- the global mixture of a continuous column is fitted on the pooled
  sample; a value is encoded as ``(x - mu_k) / (4 sigma_k)`` (clipped to
  0.99) for a mode k drawn from its posterior over the active modes, and
  a one-hot of k; a categorical value as a one-hot over the vocabulary.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import bgm

SCALE = 4.0
CLIP = 0.99


@dataclass
class Column:
    """One column of the encoded layout."""

    name: str
    kind: str                  # "cont" or "disc"
    mixture: object = None     # the global mixture of a continuous column
    vocab: tuple = ()          # a categorical column's values, slot order
    non_negative: bool = False

    @property
    def width(self) -> int:
        return 1 + int(self.mixture.active.sum()) if self.kind == "cont" \
            else len(self.vocab)


@dataclass
class ReferenceInit:
    columns: list               # Column per table column, in order
    matrices: list              # encoded (rows, dim) float32 per client
    weights: np.ndarray         # (n_clients,) float64
    rows_per_client: list

    @property
    def segments(self) -> list:
        """``(start, width, kind)`` of every segment: a continuous column
        is a 1-wide ``tanh`` then its modes' ``softmax``; a categorical
        column one ``softmax``."""
        out, pos = [], 0
        for c in self.columns:
            if c.kind == "cont":
                out.append((pos, 1, "tanh"))
                out.append((pos + 1, c.width - 1, "softmax"))
            else:
                out.append((pos, c.width, "softmax"))
            pos += c.width
        return out

    @property
    def dim(self) -> int:
        return sum(c.width for c in self.columns)


def shard_iid(n_rows: int, n_clients: int, seed: int) -> list:
    """Row indices of each client: a permutation split equally."""
    perm = np.random.default_rng(seed).permutation(n_rows)
    return [np.sort(p) for p in np.array_split(perm, n_clients)]


def _strings(col: np.ndarray) -> list:
    return [str(v) for v in col.tolist()]


def _jsd(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen-Shannon distance (natural log) of two count vectors."""
    p = p / p.sum()
    q = q / q.sum()
    m = 0.5 * (p + q)

    def kl(a, b):
        nz = a > 0
        return float(np.sum(a[nz] * np.log(a[nz] / b[nz])))

    return float(np.sqrt(max(0.5 * kl(p, m) + 0.5 * kl(q, m), 0.0)))


def _wasserstein(pooled: np.ndarray, parts: list, device) -> np.ndarray:
    """W1 distance of each part's empirical law to the pooled law (each
    part a subset of the pooled values): the integral of the CDFs'
    difference over the pooled values' grid, in float64."""
    xs = torch.as_tensor(np.sort(pooled), dtype=torch.float64, device=device)
    grid, deltas = xs[:-1], torch.diff(xs)
    f_pool = torch.searchsorted(xs, grid, right=True).double() / xs.numel()
    out = []
    for part in parts:
        ps = torch.as_tensor(np.sort(part), dtype=torch.float64,
                             device=device)
        f_part = torch.searchsorted(ps, grid, right=True).double() / ps.numel()
        out.append(float(torch.sum(torch.abs(f_pool - f_part) * deltas)))
    return np.asarray(out)


def _normalize(dist: np.ndarray) -> np.ndarray:
    dist = dist.astype(np.float64).copy()
    total = dist.sum(axis=0)
    nz = total != 0
    dist[:, nz] = dist[:, nz] / total[nz]
    dist[:, ~nz] = 1.0 / dist.shape[0]
    return dist


def initialize(table: dict, categorical, non_negative, n_clients: int,
               seed: int, device) -> ReferenceInit:
    names = list(table)
    n_rows = len(table[names[0]])
    shards = [{c: table[c][idx] for c in names}
              for idx in shard_iid(n_rows, n_clients, seed)]
    rows = [len(s[names[0]]) for s in shards]
    cat = [c for c in names if c in set(categorical)]
    cont = [c for c in names if c not in set(categorical)]

    # categories: per client counts by value (count order, first seen),
    # merged client by client, ordered by total count
    vocab, codes, jsd = {}, {}, np.zeros((n_clients, len(cat)))
    for k, c in enumerate(cat):
        per_client, merged = [], {}
        for s in shards:
            counts: dict = {}
            for v in _strings(s[c]):
                counts[v] = counts.get(v, 0) + 1
            counts = dict(sorted(counts.items(), key=lambda kv: -kv[1]))
            per_client.append(counts)
            for v, n in counts.items():
                merged[v] = merged.get(v, 0) + n
        order = [v for v, _ in sorted(merged.items(), key=lambda kv: kv[1],
                                      reverse=True)]
        vocab[c] = tuple(order)
        rank = {v: i for i, v in enumerate(sorted(order))}
        codes[c] = rank
        glob = np.zeros(len(order))
        for v, n in merged.items():
            glob[rank[v]] = n
        for i, counts in enumerate(per_client):
            vec = np.zeros(len(order))
            for v, n in counts.items():
                vec[rank[v]] = n
            jsd[i, k] = _jsd(glob, vec)
    jsd = _normalize(np.nan_to_num(jsd, nan=0.0))

    def values(s, c):
        x = np.asarray(s[c], dtype=np.float64)
        return np.log(x + 1.0) if c in set(non_negative) else x

    # each client's mixtures, the pooled rows-proportional sample, scores
    local = bgm.fit([values(s, c) for s in shards for c in cont], device)
    local = [local[i * len(cont):(i + 1) * len(cont)]
             for i in range(n_clients)]
    total = int(np.sum(rows))
    share = [float(r) / total for r in rows]
    rng = np.random.default_rng(seed)
    wd, pooled_cols = np.zeros((n_clients, len(cont))), []
    for j in range(len(cont)):
        parts = [local[i][j].sample(int(total * share[i]), rng)
                 for i in range(n_clients)]
        pooled = np.concatenate(parts)
        wd[:, j] = _wasserstein(pooled, parts, device)
        pooled_cols.append(pooled)
    wd = _normalize(wd)
    glob_mix = dict(zip(cont, bgm.fit(pooled_cols, device)))

    combo = jsd.sum(axis=1) + wd.sum(axis=1)
    e = np.exp((1.0 - combo / combo.sum()) * (np.asarray(rows) / total))
    weights = e / e.sum()

    columns = [Column(c, "cont", mixture=glob_mix[c],
                      non_negative=c in set(non_negative))
               if c in glob_mix else Column(c, "disc", vocab=vocab[c])
               for c in names]
    matrices = []
    for i, s in enumerate(shards):
        draw = np.random.default_rng(seed + i)
        n, parts = rows[i], []
        for col in columns:
            if col.kind == "cont":
                x, g = values(s, col.name), col.mixture
                z = ((x[:, None] - g.means[None]) / (SCALE * g.stds[None])
                     )[:, g.active]
                pp = g.posterior(x)[:, g.active] + 1e-6
                pp = pp / pp.sum(axis=1, keepdims=True)
                r = draw.random((n, 1))
                k = (np.cumsum(pp, axis=1) > r).argmax(axis=1)
                onehot = np.zeros((n, pp.shape[1]))
                onehot[np.arange(n), k] = 1.0
                parts += [np.clip(z[np.arange(n), k], -CLIP, CLIP)[:, None],
                          onehot]
            else:
                slot = {v: j for j, v in enumerate(col.vocab)}
                idx = np.asarray([slot[v] for v in _strings(s[col.name])])
                onehot = np.zeros((n, len(col.vocab)))
                onehot[np.arange(n), idx] = 1.0
                parts.append(onehot)
        matrices.append(np.concatenate(parts, axis=1).astype(np.float32))
    return ReferenceInit(columns=columns, matrices=matrices, weights=weights,
                         rows_per_client=rows)
