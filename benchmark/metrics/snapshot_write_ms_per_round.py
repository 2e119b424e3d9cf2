"""The snapshot writer thread's decode, CSV and file write
(``SnapshotWriter.write_s``) over the window, per round."""


def read(run):
    if not run.snapshots or not run.write_s:
        return None
    return 1e3 * sum(run.write_s) / run.rounds
