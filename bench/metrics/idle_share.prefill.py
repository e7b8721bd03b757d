"""The device's idle share in the traced slice: 1 - the union of its
operations' intervals over the slice's wall time."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
