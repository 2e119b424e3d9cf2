"""Real rows the clients' local steps consumed in the window, over the
window's seconds by the host's clock (aggregation, host copies and
snapshots included): the rate the host's dispatch sets."""


def read(run):
    return run.rows / run.window_s
