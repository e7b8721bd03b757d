"""Train attention a step: the device time of the operations that the
port's attention launched in the traced step, forward, remat's recompute
and backward (``bench.attention`` in ``kinds/train.py``; backward
operations by their autograd link to the forward ones), over the traced
steps."""

from kinds import train


def read(run):
    tr = run.trace
    if tr is None or not run.traced or not tr.parts.get(train.ATTENTION):
        return None
    return 1e3 * tr.parts[train.ATTENTION] / len(run.traced)
