"""Training throughput: the tokens of every step completed in the window
over the time from the window's first step to the end of its last."""


def read(run):
    steps = run.timed
    if not steps:
        return None
    return sum(s["tokens"] for s in steps) / (steps[-1]["t1"] - steps[0]["t0"])
