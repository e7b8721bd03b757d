"""The serve loop's host time a prefill call: from the call to its return,
before the device sync, the median over the window's calls."""

import statistics


def read(run):
    calls = run.timed
    return statistics.median((c["t_ret"] - c["t0"]) * 1e3 for c in calls) if calls else None
