"""The program's aggregation and host-copy span
(``round_split["aggregate"]``) summed over the window, per round.  In a
chunk of K > 1 rounds it holds only the last round's aggregation and the
chunk's one host copy: the program dispatches the other rounds'
aggregation between their local steps, so ``local_steps_ms_per_round``
counts it (``fed_tgan_torch/train/federated.py::_dispatch_chunk_body``).
With one round a chunk it is the whole aggregation."""


def read(run):
    return 1e3 * sum(run.split("aggregate")) / run.rounds
