"""The port's aggregators on a stacked client axis against the JAX
package's: the ``shard_map`` programs on the 8-device CPU mesh (one client
per device) and the numpy twin ``host_robust_aggregate``.

Tolerance: aggregates within atol 1e-6 (float32 sums in another order);
quarantine masks equal; a clean gated ``weighted`` round equal to the
plain weighted average bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fed_tgan_torch.parallel import fedavg
from fed_tgan_tpu.parallel.fedavg import host_robust_aggregate
from fed_tgan_tpu.parallel.fedavg import robust_aggregate as jax_robust
from fed_tgan_tpu.parallel.fedavg import weighted_average as jax_weighted
from fed_tgan_tpu.parallel.mesh import CLIENTS_AXIS, client_mesh, shard_map

torch.set_num_threads(1)
ATOL = 1e-6
AGGREGATORS = ["weighted", "clipped", "trimmed", "median"]
SHAPES = {"a": (3, 2), "b": (4,), "c": (2, 2, 2)}


def trees(n, seed, poison=None):
    """(prev, news): ``n`` clients' small deltas around one prev; the
    last client is ``poison``ed: 'nan', 'scale' (x1e3) or 'stuck'."""
    rng = np.random.default_rng(seed)
    prev = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    news = []
    for i in range(n):
        new = {k: (v + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
               for k, v in prev.items()}
        if i == n - 1 and poison == "nan":
            new = {k: np.full_like(v, np.nan) for k, v in prev.items()}
        elif i == n - 1 and poison == "scale":
            new = {k: (prev[k] + 1e3 * (v - prev[k])).astype(np.float32)
                   for k, v in new.items()}
        elif i == n - 1 and poison == "stuck":
            new = {k: v.copy() for k, v in prev.items()}
        news.append(new)
    return prev, news


def port_run(prev, news, weights, steps, **kw):
    keys = sorted(prev)  # the JAX leaf order of a dict
    p = [torch.from_numpy(prev[k]) for k in keys]
    x = [torch.from_numpy(np.stack([t[k] for t in news])) for k in keys]
    agg, q = fedavg.robust_aggregate(p, x, torch.as_tensor(weights),
                                     torch.as_tensor(steps), **kw)
    return dict(zip(keys, (a.numpy() for a in agg))), q.numpy()


def jax_run(prev, news, weights, steps, **kw):
    n = len(news)
    prev_s = jax.tree.map(lambda v: jnp.broadcast_to(v[None], (n,) + v.shape),
                          prev)
    new_s = jax.tree.map(lambda *xs: jnp.stack(xs), *news)
    fn = shard_map(lambda p, x, w, s: jax_robust(p, x, w, s, k=1, **kw),
                   mesh=client_mesh(n), in_specs=(P(CLIENTS_AXIS),) * 4,
                   out_specs=(P(), P(CLIENTS_AXIS)), check_vma=False)
    agg, q = jax.jit(fn)(prev_s, new_s, jnp.asarray(weights),
                         jnp.asarray(steps, dtype=jnp.int32))
    return jax.tree.map(np.asarray, agg), np.asarray(q) > 0.5


CASES = [(4, None), (4, "nan"), (4, "scale"), (4, "stuck"), (5, "scale"),
         (6, None)]


@pytest.mark.parametrize("aggregator", AGGREGATORS)
@pytest.mark.parametrize("n,poison", CASES,
                         ids=[f"{n}-{p}" for n, p in CASES])
def test_robust_aggregate_matches_shard_map(aggregator, n, poison):
    prev, news = trees(n, seed=n, poison=poison)
    weights = np.linspace(1.0, 2.0, n).astype(np.float32)
    weights /= weights.sum()
    steps = np.ones(n, dtype=np.int64)
    kw = dict(aggregator=aggregator, update_gate=True, trim_ratio=0.3)
    got, q = port_run(prev, news, weights, steps, **kw)
    want, jq = jax_run(prev, news, weights, steps, **kw)
    np.testing.assert_array_equal(q, jq)
    assert q[-1] == (poison is not None) and not q[:-1].any()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)
    if aggregator != "clipped":  # the twin takes another median for clip
        host, hq = host_robust_aggregate(prev, news, weights, steps, **kw)
        np.testing.assert_array_equal(q, hq)
        for k in host:
            np.testing.assert_allclose(got[k], host[k], atol=ATOL, rtol=0)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_gate_off_zero_step_and_dropped_clients(aggregator):
    """No gate: a NaN client is still screened out; a zero-step client
    and a dropped (weight 0) one take part as the JAX program has them."""
    prev, news = trees(5, seed=11, poison="nan")
    weights = np.asarray([0.3, 0.3, 0.0, 0.2, 0.2], dtype=np.float32)
    steps = np.asarray([1, 0, 0, 1, 1])
    for gate in (True, False):
        kw = dict(aggregator=aggregator, update_gate=gate, trim_ratio=0.2)
        got, q = port_run(prev, news, weights, steps, **kw)
        want, jq = jax_run(prev, news, weights, steps, **kw)
        np.testing.assert_array_equal(q, jq)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)


def test_everyone_rejected_keeps_prev():
    prev, news = trees(3, seed=2)
    news = [{k: np.full_like(v, np.inf) for k, v in t.items()} for t in news]
    got, q = port_run(prev, news, np.full(3, 1 / 3, np.float32),
                      np.ones(3), aggregator="weighted")
    assert q.all()
    for k in prev:
        np.testing.assert_array_equal(got[k], prev[k])


def test_clean_gated_round_equals_plain_weighted_exactly():
    prev, news = trees(4, seed=5)
    weights = np.asarray([0.4, 0.3, 0.2, 0.1], dtype=np.float32)
    keys = sorted(prev)
    stacks = [torch.from_numpy(np.stack([t[k] for t in news])) for k in keys]
    plain = fedavg.weighted_average(stacks, torch.as_tensor(weights))
    gated, q = port_run(prev, news, weights, np.ones(4))
    assert not q.any()
    for k, a in zip(keys, plain):
        assert torch.equal(torch.from_numpy(gated[k]), a)
    # and the plain average matches the psum program
    fn = shard_map(lambda x, w: jax_weighted(x, w),
                   mesh=client_mesh(4), in_specs=(P(CLIENTS_AXIS),) * 2,
                   out_specs=P(), check_vma=False)
    want = jax.jit(fn)(jax.tree.map(lambda *xs: jnp.stack(xs), *news),
                       jnp.asarray(weights))
    for k, a in zip(keys, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(want[k]), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_nanmedian_averages_the_middle_pair(n):
    """The median trap: an even count averages the two middle values
    (``torch.median`` would return the lower one)."""
    x = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    x[0, 1] = np.nan
    x[:, 4] = np.nan
    got = fedavg.nanmedian(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=0))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_unknown_aggregator_raises():
    prev, news = trees(2, seed=0)
    with pytest.raises(ValueError, match="unknown aggregator"):
        port_run(prev, news, np.full(2, 0.5, np.float32), np.ones(2),
                 aggregator="mean")
