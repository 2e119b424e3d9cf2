"""Splitting one table into per-client shards
(copy of ``fed_tgan_tpu/data/sharding.py:16-80``, with a column table in
place of the DataFrame).

:func:`shard_indices` makes the same numpy generator calls as the JAX
package, so a seed gives the same shards in both.
"""

from __future__ import annotations

import numpy as np


def shard_indices(
    n_rows: int,
    n_clients: int,
    strategy: str = "iid",
    labels: np.ndarray | None = None,
    alpha: float = 0.5,
    seed: int = 0,
) -> list[np.ndarray]:
    """Partition ``range(n_rows)`` into ``n_clients`` disjoint index sets.

    - ``iid``: shuffled equal split;
    - ``contiguous``: consecutive row blocks;
    - ``label_sorted``: rows sorted by label then block-split;
    - ``dirichlet``: per-label Dirichlet(alpha) allocation across clients
      (smaller alpha = more skew).
    """
    rng = np.random.default_rng(seed)
    if strategy == "iid":
        perm = rng.permutation(n_rows)
        return [np.sort(part) for part in np.array_split(perm, n_clients)]
    if strategy == "contiguous":
        return list(np.array_split(np.arange(n_rows), n_clients))
    if labels is None:
        raise ValueError(f"strategy {strategy!r} requires labels")
    labels = np.asarray(labels)
    if strategy == "label_sorted":
        order = np.argsort(labels, kind="stable")
        return [np.sort(part) for part in np.array_split(order, n_clients)]
    if strategy == "dirichlet":
        shards: list[list[int]] = [[] for _ in range(n_clients)]
        for value in np.unique(labels):
            rows = np.flatnonzero(labels == value)
            rng.shuffle(rows)
            probs = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(probs)[:-1] * len(rows)).astype(int)
            for client, part in enumerate(np.split(rows, cuts)):
                shards[client].extend(part.tolist())
        return [np.sort(np.asarray(s, dtype=np.int64)) for s in shards]
    raise ValueError(f"unknown strategy {strategy!r}")


def shard_table(
    table: dict,
    n_clients: int,
    strategy: str = "iid",
    label_column: str | None = None,
    alpha: float = 0.5,
    seed: int = 0,
) -> list[dict]:
    """``{name: column}`` -> one such table per client (rows in their
    original order).  A client with no row at all is an error."""
    n_rows = len(next(iter(table.values()))) if table else 0
    labels = table[label_column] if label_column else None
    parts = shard_indices(n_rows, n_clients, strategy, labels, alpha, seed)
    empty = [i for i, idx in enumerate(parts) if len(idx) == 0]
    if empty:
        raise ValueError(
            f"clients {empty} received 0 rows under strategy={strategy!r} "
            f"(alpha={alpha}, seed={seed}); raise alpha, reduce n_clients, "
            "or change the shard seed")
    return [{k: v[idx] for k, v in table.items()} for idx in parts]
