"""The snapshot hook's time on the round's path
(``phase_times["distribution"]``) over the window, per round."""


def read(run):
    if not run.snapshots:
        return None
    return 1e3 * sum(run.distribution) / run.rounds
