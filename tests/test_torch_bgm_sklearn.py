"""``--bgm-backend sklearn``, the reference-exact host fit, against the
JAX package's ``backend="sklearn"`` on the same inputs.

- ``fit_column_gmm``: means, stds, weights and active bit-equal to JAX's,
  ``predict_proba`` within 1e-12 of sklearn's own (JAX keeps the
  estimator for it), the port's ``FED_TGAN_TORCH_BGM_*`` levers as JAX's
  ``FED_TGAN_TPU_BGM_*``;
- ``federated_initialize(backend="sklearn")`` on three ragged shards:
  the global mixtures bit-equal, the weights within 1e-12, the encoded
  matrices equal in at least 99.99% of rows (a tie in the mode draw could
  flip one; the count is printed);
- streaming registration fits a newcomer as the in-process init fits the
  same shard; the multi-process init protocol holds the in-process
  init's bits; the init cache keeps sklearn and torch entries apart;
- the CLI: ``--mode standalone --bgm-backend sklearn --device cpu`` exits
  0; without sklearn ``--bgm-backend sklearn`` exits 2 naming it before
  the backend probe.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from fed_tgan_torch import cli as port_cli
from fed_tgan_torch.data.csvio import read_csv, write_csv
from fed_tgan_torch.features import bgm as port_bgm
from fed_tgan_torch.federation import distributed as dist_init
from fed_tgan_torch.federation.init import federated_initialize
from fed_tgan_torch.federation.streaming import OnboardingSession
from fed_tgan_torch.runtime.transport import ClientTransport, ServerTransport
from fed_tgan_tpu.features import bgm as jax_bgm
from fed_tgan_tpu.federation.init import (
    federated_initialize as jax_federated_initialize,
)
from test_torch_federation_init import KW, both_clients, client_tables
from test_torch_world import next_port

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GMM_FIELDS = ("means", "stds", "weights", "active")


def _columns():
    """A bimodal column, a heavy-tailed one and one of 6 rows (fewer rows
    than components)."""
    rng = np.random.default_rng(2)
    bimodal = np.concatenate([rng.normal(-4, 0.5, 300), rng.normal(3, 1, 200)])
    return [rng.permutation(bimodal), np.exp(rng.normal(1, 1, 400)),
            rng.normal(0, 1, 6)]


def _same_gmm(a, b) -> None:
    for name in GMM_FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("column", [0, 1, 2])
def test_fit_column_gmm_bit_equal_jax(column):
    x = _columns()[column]
    ours = port_bgm.fit_column_gmm(x, seed=7)
    theirs = jax_bgm.fit_column_gmm(x, backend="sklearn", seed=7)
    _same_gmm(ours, theirs)
    assert ours.n_components == min(10, len(x))
    grid = np.linspace(x.min() - 1, x.max() + 1, 257)
    np.testing.assert_allclose(ours.predict_proba(grid),
                               theirs.predict_proba(grid), rtol=0, atol=1e-12)
    # the posterior fields ride along, so the fit round-trips as a dict
    _same_gmm(port_bgm.ColumnGMM.from_dict(ours.to_dict()), ours)


def test_host_fit_levers_match_jax(monkeypatch):
    """``FED_TGAN_TORCH_BGM_MAX_ITER`` / ``_TOL`` set the fit as JAX's
    ``FED_TGAN_TPU_BGM_*`` set its fit; a fit cut at 3 iterations is
    another fit."""
    x = _columns()[0]
    full = port_bgm.fit_column_gmm(x, seed=1)
    for name, value in (("MAX_ITER", "3"), ("TOL", "0.5")):
        monkeypatch.setenv(f"FED_TGAN_TORCH_BGM_{name}", value)
        monkeypatch.setenv(f"FED_TGAN_TPU_BGM_{name}", value)
    cut = port_bgm.fit_column_gmm(x, seed=1)
    _same_gmm(cut, jax_bgm.fit_column_gmm(x, backend="sklearn", seed=1))
    assert not np.array_equal(cut.means, full.means)


def test_fit_backend_names_the_backends():
    cols = _columns()[:1]
    _same_gmm(port_bgm.fit_backend(cols, "sklearn", seed=0)[0],
              port_bgm.fit_column_gmm(cols[0], seed=0))
    with pytest.raises(ValueError, match="unknown BGM backend"):
        port_bgm.fit_backend(cols, "scipy")


@pytest.fixture(scope="module")
def sklearn_init():
    ours, theirs = both_clients()
    return (federated_initialize(ours, seed=3, device="cpu",
                                 backend="sklearn"),
            jax_federated_initialize(theirs, seed=3, backend="sklearn"))


def test_federated_initialize_matches_jax(sklearn_init):
    init, jinit = sklearn_init
    assert init.global_meta.to_json_dict() == jinit.global_meta.to_json_dict()
    for ours, theirs in zip(init.transformers[0].column_gmms,
                            jinit.transformers[0].column_gmms):
        assert (ours is None) == (theirs is None)
        if ours is not None:
            _same_gmm(ours, theirs)
    np.testing.assert_allclose(init.weights, jinit.weights, rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(init.jsd_raw, jinit.jsd_raw)
    np.testing.assert_array_equal(init.wd_raw, jinit.wd_raw)
    rows = equal = 0
    for m, jm in zip(init.client_matrices, jinit.client_matrices):
        assert m.shape == np.shape(jm)
        rows += len(m)
        equal += int(np.all(m == np.asarray(jm), axis=1).sum())
    print(f"sklearn init: {equal} of {rows} encoded rows equal to JAX's")
    assert equal >= 0.9999 * rows


def test_streaming_registration_fits_as_the_in_process_init(sklearn_init):
    """Shard 1 registered into an init of shards 0 and 2 gets the local
    mixtures the three-shard init fitted for it (the same host fits, one
    seed); under the torch fit it would get others."""
    full, _ = sklearn_init
    ours, _ = both_clients()
    first = federated_initialize([ours[0], ours[2]], seed=3, device="cpu",
                                 backend="sklearn")
    grown = OnboardingSession(first, device="cpu").register_clients(
        [ours[1]])
    assert len(grown.rows_per_client) == 3
    for key in ("mix_means", "mix_stds", "mix_weights"):
        np.testing.assert_array_equal(grown.onboarding[key][[0, 2, 1]],
                                      full.onboarding[key], err_msg=key)
    torch_first = federated_initialize([ours[0], ours[2]], seed=3,
                                       device="cpu")
    torch_grown = OnboardingSession(torch_first, device="cpu")
    torch_grown.register_clients([ours[1]])
    assert not np.array_equal(torch_grown.init.onboarding["mix_means"][2],
                              full.onboarding["mix_means"][1])


def test_multi_process_init_holds_the_in_process_bits(sklearn_init):
    """The init protocol over the transport (rank 0 and three participants
    in threads), every side on the host fit: the server's weights and
    each participant's matrix equal the in-process init's."""
    full, _ = sklearn_init
    ours, _ = both_clients()
    port = next_port()
    out = {}

    def participant(rank):
        with ClientTransport("127.0.0.1", port, rank, timeout_ms=20_000) as c:
            out[rank] = dist_init.client_initialize(
                c, ours[rank - 1], seed=3, device="cpu", backend="sklearn")

    threads = [threading.Thread(target=participant, args=(r,), daemon=True)
               for r in (1, 2, 3)]
    for t in threads:
        t.start()
    with ServerTransport(port, 3, timeout_ms=20_000) as server:
        res = dist_init.server_initialize(server, seed=3, device="cpu",
                                          backend="sklearn")
    for t in threads:
        t.join(timeout=60)
    np.testing.assert_array_equal(res["weights"], full.weights)
    for ours_g, full_g in zip(res["global_gmms"],
                              full.transformers[0].column_gmms):
        if full_g is not None:
            _same_gmm(ours_g, full_g)
    for rank in (1, 2, 3):
        np.testing.assert_array_equal(out[rank]["matrix"],
                                      full.client_matrices[rank - 1])


def test_init_cache_keeps_the_backends_apart(tmp_path):
    """A torch-fit entry never restores a sklearn init, nor the other way
    round; each backend's second run restores its own entry bit for
    bit."""
    clients, _ = both_clients()
    cache = str(tmp_path / "cache")
    runs = {}
    for backend in ("jax", "sklearn", "jax", "sklearn"):
        init = federated_initialize(clients, seed=3, device="cpu",
                                    backend=backend, cache=cache)
        runs.setdefault(backend, []).append(init)
    for backend, (cold, warm) in runs.items():
        assert "cache_restore" not in cold.timings
        assert "cache_restore" in warm.timings
        assert cold.onboarding["params"]["backend"] == backend
        for a, b in zip(cold.client_matrices, warm.client_matrices):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs["jax"][0].onboarding["mix_means"],
                              runs["sklearn"][0].onboarding["mix_means"])


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("toy") / "toy.csv")
    write_csv(client_tables()[0], path)
    return path


def _toy_argv(path, out, *extra):
    return ["--datapath", path, "--dataset", "custom", "--categorical",
            *KW["categorical_columns"], "--non-negative",
            *KW["non_negative_columns"], "-epochs", "1", "--batch-size", "50",
            "--embedding-dim", "8", "--sample-rows", "40", "--seed", "1",
            "--out-dir", str(out), *extra]


def test_standalone_cli_with_the_host_fit(toy_csv, tmp_path):
    assert port_cli.main(_toy_argv(toy_csv, tmp_path, "--mode", "standalone",
                                   "--bgm-backend", "sklearn", "--quiet",
                                   "--device", "cpu")) == 0
    fake = read_csv(str(tmp_path / "toy_result"
                        / "toy_synthesis_standalone.csv"))
    assert len(fake["x"]) == 40 and np.isfinite(fake["x"]).all()


def test_cli_without_sklearn_exits_2_before_the_probe(toy_csv, tmp_path):
    """No ``--device cpu``: reaching the backend probe would exit 3 on a
    host without a card, so exit 2 shows the check came first."""
    argv = _toy_argv(toy_csv, tmp_path, "--bgm-backend", "sklearn")
    code = ("import sys\n"
            "sys.modules['sklearn'] = None\n"
            "from fed_tgan_torch.cli import main\n"
            f"sys.exit(main({argv!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert "--bgm-backend sklearn needs sklearn" in proc.stderr
    assert not (tmp_path / "toy_result").exists()
