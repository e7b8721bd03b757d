"""Set-up time: process start to the first timed call (loading, weights from
the seed, warm-up, the first run's kernel builds; the check's readings of
the program during set-up are left out)."""


def read(run):
    return run.setup_s
