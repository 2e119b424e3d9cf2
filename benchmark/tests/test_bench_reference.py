"""The port's first rounds held against the plain reference on the CPU,
at a toy size: the same draws on both sides (each makes them from the
seed), every number compared far under its limit, and the result line
complete."""

import math

import pytest

import cpu_cells

CELLS = ["intrusion-8c.snapshot", "covertype-32c.rounds"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_round_matches_reference(cell):
    res = cpu_cells.run(cell, trace=(cell == "covertype-32c.rounds"))
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        # the CPU runs the same arithmetic in another order: far under
        # every limit set for the card
        assert c["value"] <= c["limit"] / 10, (name, c)
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    for m in res["metrics"].values():
        assert math.isfinite(m["value"])
