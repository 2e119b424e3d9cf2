"""Card microseconds a trained row costs: the summed duration of every
kernel, copy and memset that a fixed number of whole rounds launch on
any stream (snapshots included where the cell takes them), read from a
device-only profiler trace after the window, over the real rows those
rounds' local steps consume.  Read in untraced runs on the card."""


def read(run):
    if run.device_rows <= 0:
        return None
    return 1e6 * run.device_s / run.device_rows
