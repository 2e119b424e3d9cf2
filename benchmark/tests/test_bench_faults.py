"""Each fault a cell can have, planted in the program under a CPU run of
the harness (``benchmark/control.py::planted``, the faults the limits
were read against on the card), turns ``correct`` false: a step that
leaves the state unchanged, half of each batch left out (the mean over
the rest), an aggregate altered where it is made, and a snapshot cell
altered where it is decoded; and the first two in one slot of the
stacked step only, in both configurations.  (One chip: no exchange
between chips to leave out.)"""

import pytest

import cpu_cells
from benchmark.control import planted

FAULTS = [("covertype-32c.rounds", "frozen_state", "change_gap"),
          ("covertype-32c.rounds", "half_batch", "loss_gap"),
          ("covertype-32c.rounds", "altered_aggregate", "change_gap"),
          ("intrusion-8c.snapshot", "altered_snapshot", "snapshot_cells_pct")]
# four clients of two steps a round: one slot of four is hit, and its
# round-1 losses come after a step
ONE_SLOT = [(cell, fault, "client_loss_gap")
            for cell in ("intrusion-8c.snapshot", "covertype-32c.rounds")
            for fault in ("frozen_state_one", "half_batch_one")]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f[1] for f in FAULTS])
def test_fault_turns_correct_false(cell, fault, number):
    with planted(fault):
        res = cpu_cells.run(cell)
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


@pytest.mark.parametrize("cell,fault,number", ONE_SLOT,
                         ids=[f"{f[0].split('.')[0]}-{f[1]}"
                              for f in ONE_SLOT])
def test_one_slot_fault_turns_correct_false(cell, fault, number):
    with planted(fault):
        res = cpu_cells.run(cell, rows=4000, clients=4)
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]
