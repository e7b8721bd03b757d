"""The 95th percentile, over every request of the window, of the time from a
request's submission to its first token on the host."""

import harness


def read(run):
    ttft = [(c["t1"] - c["t0"]) * 1e3 for c in run.timed for _ in range(c["requests"])]
    return harness.p95(ttft) if ttft else None
