"""The port's serving path against the JAX package's, on one JAX demo
artifact converted with ``interop.convert_jax_artifact``.

JAX's draws are regenerated with its own key layout
(``fold_in(key(seed + key_offset), step)`` then ``split(., 3)`` into
z / conditional / Gumbel-uniform keys, ``serve/engine.py:95-110``) and
injected into the port's engine through ``draws=``.
"""

import csv
import io
import json
import os
import pickle
import shutil
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fed_tgan_tpu.ops.decode import decode_tables as jax_decode_tables
from fed_tgan_tpu.serve import engine as jax_engine
from fed_tgan_tpu.serve.demo import build_demo_artifact
from fed_tgan_tpu.serve.registry import load_model as jax_load_model
from fed_tgan_tpu.serve.registry import resolve_artifact as jax_resolve
from fed_tgan_tpu.train.steps import TrainConfig as JaxTrainConfig
from fed_tgan_torch import interop
from fed_tgan_torch.__main__ import main as port_main
from fed_tgan_torch.ops.decode import decode_tables
from fed_tgan_torch.serve.engine import ConditionError, SamplingEngine
from fed_tgan_torch.serve.registry import (
    ArtifactError,
    MetaMismatchError,
    ModelRegistry,
    open_model,
    resolve_artifact,
)
from fed_tgan_torch.serve.service import SamplingService
from fed_tgan_torch.train.steps import TrainConfig

torch.set_num_threads(1)

ENC_ATOL = 1e-4  # float32 GEMM order differences, times 5 from 1/tau
DEC_RTOL = 1e-4
NEAR_TIE = 1e-3  # a segment's top two outputs this close may flip argmax


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    jax_dir = build_demo_artifact(str(root / "jax"))
    port_dir = interop.convert_jax_artifact(jax_dir, str(root / "port"))
    jmodel = jax_load_model(jax_resolve(jax_dir, log=lambda *a: None))
    pmodel = open_model(port_dir, device="cpu")
    return {"jax_dir": jax_dir, "port_dir": port_dir, "jmodel": jmodel,
            "pmodel": pmodel, "jengine": jax_engine.SamplingEngine(jmodel),
            "pengine": SamplingEngine(pmodel)}


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


def near_ties(encoded, spec):
    """Rows where some softmax segment's top two outputs are within
    NEAR_TIE of each other (their argmax may flip legitimately)."""
    near = np.zeros(len(encoded), dtype=bool)
    start = 0
    for size, kind in spec.output_info:
        if kind == "softmax" and size > 1:
            top = np.sort(encoded[:, start:start + size], axis=1)
            near |= (top[:, -1] - top[:, -2]) < NEAR_TIE
        start += size
    return near


def test_convert_keeps_every_table(arts):
    jsynth, psynth = arts["jmodel"].synth, arts["pmodel"].synth
    assert psynth.key_offset == jsynth.key_offset == 17
    assert psynth.spec.output_info == tuple(jsynth.transformer.output_info)
    assert psynth.cfg == TrainConfig(**{
        f: getattr(jsynth.cfg, f) for f in JaxTrainConfig.__dataclass_fields__})
    # by value: both cond tables are (n_discrete, max_size), a swap would
    # not show in the shapes
    np.testing.assert_array_equal(psynth.cond.p_empirical.numpy(),
                                  np.asarray(jsynth.cond.p_empirical))
    np.testing.assert_array_equal(psynth.cond.p_train.numpy(),
                                  np.asarray(jsynth.cond.p_train))
    again = interop.cond_from_jax(jsynth.cond, psynth.spec)
    np.testing.assert_array_equal(again.p_empirical.numpy(),
                                  psynth.cond.p_empirical.numpy())
    assert not np.array_equal(np.asarray(jsynth.cond.p_train),
                              np.asarray(jsynth.cond.p_empirical))
    gen = psynth.generator
    np.testing.assert_array_equal(gen.out.weight.detach().numpy(),
                                  np.asarray(jsynth.params_g["out"]["w"]).T)
    np.testing.assert_array_equal(
        gen.blocks[1].bn.running_mean.numpy(),
        np.asarray(jsynth.state_g["blocks"][1]["mean"]))
    for tab, jtab in zip(decode_tables(psynth.columns),
                         jax_decode_tables(jsynth.transformer.columns)):
        for a, b in zip(tab, jtab):
            np.testing.assert_array_equal(a, b)
    for enc, jenc in zip(arts["pmodel"].encoders, arts["jmodel"].encoders):
        assert enc.classes_.tolist() == jenc.classes_.tolist()
    assert (arts["pmodel"].meta.to_json_dict()
            == arts["jmodel"].meta.to_json_dict())


def test_unpickler_refuses_foreign_globals(tmp_path):
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump(os.getcwd, f)
    with pytest.raises(pickle.UnpicklingError):
        interop._unpickle(str(path))


def test_encoded_rows_match_jax(arts):
    n, seed = 330, 5
    jsynth = arts["jmodel"].synth
    want = jsynth.sample_encoded(n, seed=seed)
    got = arts["pengine"].sample_encoded(
        n, seed=seed, draws=jax_draws(arts["jmodel"], seed))
    assert got.shape == want.shape == (n, jsynth.spec.dim)
    np.testing.assert_allclose(got, want, atol=ENC_ATOL)


@pytest.mark.parametrize("conditional", [False, True])
def test_decoded_rows_match_jax(arts, conditional):
    n, seed, offset = 260, 9, 37
    condition = (arts["jengine"].resolve_condition("color", "blue")
                 if conditional else None)
    want = arts["jengine"].sample_decoded(n, seed=seed, offset=offset,
                                          condition=condition)
    got = arts["pengine"].sample_decoded(
        n, seed=seed, offset=offset, condition=condition,
        draws=jax_draws(arts["jmodel"], seed))
    assert got.shape == want.shape == (n, 4)
    encoded = arts["pengine"].sample_encoded(
        n, seed=seed, offset=offset, condition=condition,
        draws=jax_draws(arts["jmodel"], seed))
    # the port's encoded rows stand in for JAX's (they agree to ENC_ATOL);
    # near ties are rare: at most 1% of the rows may be set aside
    near = near_ties(encoded, arts["pmodel"].synth.spec)
    assert near.sum() <= n // 100, f"{near.sum()} near-tie rows"
    np.testing.assert_allclose(got[~near], want[~near], rtol=DEC_RTOL)


def test_csv_cells_match_jax(arts):
    n, seed = 150, 3
    want = arts["jengine"].sample_csv_bytes(n, seed=seed)
    got = arts["pengine"].sample_csv_bytes(
        n, seed=seed, draws=jax_draws(arts["jmodel"], seed))
    ours = list(csv.reader(io.StringIO(got.decode())))
    theirs = list(csv.reader(io.StringIO(want.decode())))
    assert ours[0] == theirs[0] == ["amount", "score", "color", "flag"]
    assert len(ours) == len(theirs) == n + 1
    for row, jrow in zip(ours[1:], theirs[1:]):
        assert row[2:] == jrow[2:]
        np.testing.assert_allclose([float(v) for v in row[:2]],
                                   [float(v) for v in jrow[:2]], rtol=DEC_RTOL)


def test_resolve_condition_matches_jax(arts):
    jengine, pengine = arts["jengine"], arts["pengine"]
    for name, enc in zip(arts["pmodel"].meta.categorical_columns,
                         arts["pmodel"].encoders):
        for value in enc.classes_.tolist():
            assert (pengine.resolve_condition(name, value)
                    == jengine.resolve_condition(name, value))
    for column, value in (("amount", 1.0), ("color", "purple"), ("nope", 1)):
        with pytest.raises(ConditionError):
            pengine.resolve_condition(column, value)
        with pytest.raises(jax_engine.ConditionError):
            jengine.resolve_condition(column, value)


def test_chunked_bytes_equal_one_shot(arts):
    """The determinism contract on the port's own stream, across full
    chunks, power-of-two tails and step-straddling offsets."""
    engine = SamplingEngine(arts["pmodel"], max_chunk_steps=4)
    one = engine.sample_csv_bytes(1234, seed=11)
    cuts = [0, 7, 50, 333, 400, 1000, 1234]
    parts = [engine.sample_csv_bytes(b - a, seed=11, offset=a, header=a == 0)
             for a, b in zip(cuts, cuts[1:])]
    assert b"".join(parts) == one
    assert arts["pengine"].sample_csv_bytes(1234, seed=11) == one
    assert engine.sample_csv_bytes(1234, seed=12) != one
    assert [s for _, s in engine._chunk_plan(3, 11)] == [4, 4, 4]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_http_service_on_cpu(arts):
    service = SamplingService(ModelRegistry(arts["port_dir"], device="cpu",
                                            log=lambda *a: None)).start()
    try:
        status, body = _get(f"{service.url}/healthz")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok"
        assert health["device"] == "cpu"
        assert health["model_id"] == arts["pmodel"].model_id
        status, one = _get(f"{service.url}/sample?rows=120&seed=11")
        assert status == 200
        assert one == arts["pengine"].sample_csv_bytes(120, seed=11)
        _, a = _get(f"{service.url}/sample?rows=50&seed=11")
        _, b = _get(f"{service.url}/sample?rows=70&seed=11&offset=50&header=0")
        assert a + b == one
        status, body = _get(f"{service.url}/sample?rows=40&column=color&value=red")
        assert status == 200 and len(body.decode().splitlines()) == 41
        assert _get(f"{service.url}/sample?rows=0")[0] == 400
        assert _get(f"{service.url}/sample?rows=5&column=color&value=x")[0] == 400
        assert _get(f"{service.url}/nope")[0] == 404
        assert json.loads(_get(f"{service.url}/healthz")[1])[
            "requests_total"] == 4
    finally:
        service.shutdown()
    assert not service.submit(None)  # draining: new requests are shed


def test_sample_from_cli_writes_engine_bytes(arts, tmp_path):
    out = tmp_path / "rows.csv"
    rc = port_main(["--sample-from", arts["port_dir"], "--sample-rows", "75",
                    "--seed", "2", "--out", str(out), "--device", "cpu"])
    assert rc == 0
    assert out.read_bytes() == arts["pengine"].sample_csv_bytes(75, seed=2)
    assert port_main(["--sample-from", str(tmp_path), "--sample-rows", "5",
                      "--out", str(out), "--device", "cpu"]) == 2


def test_registry_resolution_and_freshness(arts, tmp_path):
    with pytest.raises(ArtifactError):
        resolve_artifact(str(tmp_path))
    copy = tmp_path / "copy"
    shutil.copytree(arts["port_dir"], copy)
    art = resolve_artifact(str(copy))
    assert art.name == "demo" and art.enc_path.endswith("label_encoders_demo.json")
    assert resolve_artifact(art.synth_dir) == art
    future = os.path.getmtime(art.synth_dir) + 100
    os.utime(art.meta_path, (future, future))
    with pytest.raises(MetaMismatchError):
        open_model(str(copy), device="cpu")
    model = open_model(str(copy), device="cpu", allow_meta_mismatch=True,
                       log=lambda *a: None)
    assert model.model_id == arts["pmodel"].model_id
