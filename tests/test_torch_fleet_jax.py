"""The fleet's lane dispatch against the JAX package's vmapped bucket
program (``fed_tgan_tpu/serve/fleet.py:828-854`` over
``serve/engine.py:59-130``), on JAX demo artifacts converted with
``interop.convert_jax_artifact``.

Each lane has its own model, seed and first step.  JAX runs its lanes as
one ``jax.vmap`` of the bucket program with each lane's key; the port's
lane dispatch gets the same per-lane draws, regenerated with the
reference's key layout (``fold_in(key(seed + key_offset), step)`` then
``split(., 3)``) and injected through ``draws=``.  Encoded rows agree
within ``ENC_ATOL`` and decoded rows within ``DEC_RTOL``, rows with a
near tie in a softmax segment set aside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fed_tgan_torch import interop
from fed_tgan_torch.serve.fleet import (
    FleetRegistry,
    FleetService,
    _FleetRequest,
    _Member,
)
from fed_tgan_tpu.ops.decode import decode_layout, decode_tables
from fed_tgan_tpu.serve.demo import build_demo_artifact
from fed_tgan_tpu.serve.engine import build_bucket_program
from fed_tgan_tpu.serve.fleet import _stack_pytrees
from fed_tgan_tpu.serve.registry import load_model as jax_load_model
from fed_tgan_tpu.serve.registry import resolve_artifact as jax_resolve

torch.set_num_threads(1)

ENC_ATOL = 1e-4  # float32 GEMM order differences, times 5 from 1/tau
DEC_RTOL = 1e-4
NEAR_TIE = 1e-3  # a segment's top two outputs this close may flip argmax
STEPS = 2
_silent = lambda *a, **k: None  # noqa: E731


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    """Two JAX demo models of one layout (1 and 2 epochs: other weights)
    and their port conversions in one CPU fleet."""
    root = tmp_path_factory.mktemp("torch_fleet_jax")
    fleet = FleetRegistry(device="cpu", log=_silent)
    jmodels = {}
    for name, epochs in (("one", 1), ("two", 2)):
        jdir = build_demo_artifact(str(root / f"jax_{name}"), epochs=epochs)
        jmodels[name] = jax_load_model(jax_resolve(jdir, log=_silent))
        fleet.load(name, interop.convert_jax_artifact(
            jdir, str(root / f"port_{name}")))
    a, b = (m.synth for m in jmodels.values())
    assert decode_layout(a.transformer.columns) == \
        decode_layout(b.transformer.columns)
    assert not np.array_equal(np.asarray(a.params_g["out"]["w"]),
                              np.asarray(b.params_g["out"]["w"]))
    return fleet, jmodels


def jax_draws(jmodel, seed):
    synth = jmodel.synth
    B, emb, dim = synth.cfg.batch_size, synth.cfg.embedding_dim, synth.spec.dim
    key = jax.random.key(seed + synth.key_offset)

    def draws(step):
        kz, kc, ka = jax.random.split(jax.random.fold_in(key, step), 3)
        return (np.asarray(jax.random.normal(kz, (B, emb))),
                np.asarray(synth.cond.sample_empirical(kc, B)),
                np.asarray(jax.random.uniform(ka, (B, dim))))

    return draws


def jax_lanes(jmodels, seeds, starts, poss, conditional, decoded):
    """JAX's lane program: the bucket program vmapped over the lanes."""
    synths = [m.synth for m in jmodels]
    s0 = synths[0]
    layout = decode_layout(s0.transformer.columns) if decoded else None
    run = build_bucket_program(s0.spec, s0.cfg, layout, STEPS, conditional)
    tables = _stack_pytrees([jax.device_put(decode_tables(
        s.transformer.columns)) for s in synths])
    width = len(layout) if decoded else s0.spec.dim
    out = jnp.zeros((len(synths), STEPS * s0.cfg.batch_size, width))
    keys = jnp.stack([jax.random.key(seed + s.key_offset)
                      for seed, s in zip(seeds, synths)])
    return np.asarray(jax.jit(jax.vmap(run))(
        _stack_pytrees([s.params_g for s in synths]),
        _stack_pytrees([s.state_g for s in synths]),
        _stack_pytrees([s.cond for s in synths]), keys,
        np.asarray(starts, np.int32), np.asarray(poss, np.int32), tables,
        out))


def near_ties(encoded, spec):
    near = np.zeros(len(encoded), dtype=bool)
    start = 0
    for size, kind in spec.output_info:
        if kind == "softmax" and size > 1:
            top = np.sort(encoded[:, start:start + size], axis=1)
            near |= (top[:, -1] - top[:, -2]) < NEAR_TIE
        start += size
    return near


@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("names", [("one", "two"), ("two", "one", "one")])
def test_lanes_match_jax_vmapped_bucket_program(tenants, names,
                                                conditional):
    fleet, jmodels = tenants
    lanes = [jmodels[n] for n in names]
    seeds = [5 + 3 * i for i in range(len(names))]
    starts = [2 * i for i in range(len(names))]
    B = lanes[0].synth.cfg.batch_size
    poss, members = [], []
    for name, seed, start in zip(names, seeds, starts):
        rt = fleet.get(name)
        cond = (rt.engine.resolve_condition("color", "blue")
                if conditional else None)
        poss.append(0 if cond is None else cond)
        members.append(_Member(
            _FleetRequest(name, STEPS * B, seed, start * B, cond, True), rt,
            rt.engine.snapshot(), start, 0))
    draws = [jax_draws(m, s) for m, s in zip(lanes, seeds)]
    svc = FleetService(fleet, max_lanes=4, log=_silent)
    _, enc = svc.lane_encoded(members, STEPS, draws=draws)
    dec = svc.lane_pass(members, STEPS, draws=draws)
    want_enc = jax_lanes(lanes, seeds, starts, poss, conditional, False)
    want_dec = jax_lanes(lanes, seeds, starts, poss, conditional, True)
    spec = members[0].snap.spec
    for i in range(len(names)):
        got = enc[i].numpy()
        np.testing.assert_allclose(got, want_enc[i], atol=ENC_ATOL)
        near = near_ties(got, spec)
        assert near.sum() <= max(1, len(got) // 100), near.sum()
        np.testing.assert_allclose(dec[i][~near], want_dec[i][~near],
                                   rtol=DEC_RTOL)
