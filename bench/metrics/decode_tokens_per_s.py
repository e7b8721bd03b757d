"""Decode throughput: the tokens every sequence of the pool received in the
window over the window's whole time."""


def read(run):
    steps = run.timed
    if not steps:
        return None
    return sum(s["requests"] for s in steps) / (steps[-1]["t1"] - steps[0]["t0"])
