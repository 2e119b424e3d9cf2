"""Set-up seconds: process start to the first timed round (imports, the
CUDA context, the table, the federated init, the first rounds)."""


def read(run):
    return run.setup_s
