"""The optimizer a step: the device time of the operations that the port's
``AdamW.update`` launched in the traced step (``bench.optimizer`` in
``kinds/train.py``), over the traced steps."""

from kinds import train


def read(run):
    tr = run.trace
    if tr is None or not run.traced or not tr.parts.get(train.OPTIMIZER):
        return None
    return 1e3 * tr.parts[train.OPTIMIZER] / len(run.traced)
