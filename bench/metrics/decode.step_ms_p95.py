"""The 95th percentile of the gap between a sequence's tokens: every
sequence of the pool gets one token a step, so each step's host time from
its call to its sync."""

import harness


def read(run):
    steps = run.timed
    return harness.p95([(s["t1"] - s["t0"]) * 1e3 for s in steps]) if steps else None
