"""Seconds of ``federated_initialize`` by the harness's clock, ended by a
device synchronisation."""


def read(run):
    return run.init_s
