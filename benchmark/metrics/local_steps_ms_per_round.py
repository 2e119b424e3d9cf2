"""The program's local-steps span (``round_split["local_steps"]``, ended
by a synchronisation) summed over the window, per round.  In a chunk of
K > 1 rounds it also holds the aggregation of all but the chunk's last
round, which the program dispatches between the rounds' local steps."""


def read(run):
    return 1e3 * sum(run.split("local_steps")) / run.rounds
