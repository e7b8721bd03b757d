"""A decode step's share of the card's memory rate: the bytes the step needs
(weights once, the live K/V positions once, the new K/V written once;
not the rest of the cache that the decode attention also reads) over the
window's steps' time."""

import yardstick


def read(run):
    steps = run.timed
    if not steps:
        return None
    d, N = run.driver.dims, run.driver.mix["sequences"]
    nbytes = sum(yardstick.decode_step_bytes(d, N, s["cache_len"]) for s in steps)
    return 100.0 * nbytes / (steps[-1]["t1"] - steps[0]["t0"]) / yardstick.HBM_BYTES_PER_S
