"""The training step's share of the card's bf16 peak: the model FLOPs of the
window's steps (the cell's family's ``train_step_flops``: for the dense
decoder 6 a weight a token, attention forward and backward; not remat's
recompute) over their time."""

import yardstick


def read(run):
    steps = run.timed
    if not steps:
        return None
    mix = run.driver.mix
    flops = run.driver.family.train_step_flops(run.driver.dims, mix["batch"], mix["seq_len"])
    flops *= len(steps)
    return 100.0 * flops / (steps[-1]["t1"] - steps[0]["t0"]) / yardstick.PEAK_BF16_FLOPS
