"""The training step's share of the card's bf16 peak: the model FLOPs of the
window's steps (6 a weight a token, attention forward and backward; not
remat's recompute) over their time."""

import yardstick


def read(run):
    steps = run.timed
    if not steps:
        return None
    mix = run.driver.mix
    flops = yardstick.train_step_flops(run.driver.dims, mix["batch"], mix["seq_len"]) * len(steps)
    return 100.0 * flops / (steps[-1]["t1"] - steps[0]["t0"]) / yardstick.PEAK_BF16_FLOPS
