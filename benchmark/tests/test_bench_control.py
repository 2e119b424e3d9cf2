"""The control of the check: the reference itself in TF32 (the step
below the configurations' float32 with TF32 off) in the program's place
fails at least one number, on the card.  Needs a CUDA device; skips
without one."""

import pytest

import cpu_cells


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["intrusion-8c.snapshot",
                                  "covertype-32c.rounds"])
def test_tf32_reference_fails_a_limit(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    from benchmark import check, tables
    import importlib

    from benchmark.program import cli_args

    w, cfg, traffic = cpu_cells.tiny(cell, rows=8000, clients=4)
    seed = cpu_cells.SEED
    table = tables.generate(cfg["table"], cfg["rows"], seed)
    schema = importlib.import_module(f"benchmark.tables.{cfg['table']}")
    snap = check.snapshot_stream(cli_args(cfg, traffic, seed), seed)
    dev = torch.device("cuda")
    ref = check.reference_readings(table, schema, cfg, seed, dev,
                                   snapshot=snap)
    low = check.reference_readings(table, schema, cfg, seed, dev, tf32=True,
                                   snapshot=snap)
    if snap is not None:
        low["snapshot"] = check.as_written(low["snapshot"])
    numbers = check.compare(low, ref)
    assert any(v > w["limits"][k] for k, v in numbers.items()), numbers
