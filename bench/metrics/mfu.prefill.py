"""The prefill calls' share of the card's bf16 peak: the model FLOPs of the
traced calls over their device wall time (each call's first device
operation's start to its last one's end)."""

import yardstick


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    d, B = run.driver.dims, run.driver.mix["batch"]
    flops = wall = 0.0
    for j, c in enumerate(run.traced):
        ks = tr.kernels_of(j)
        if not ks:
            return None
        flops += yardstick.prefill_flops(d, B, c["length"])
        wall += max(k[1] for k in ks) - ks[0][0]
    return 100.0 * flops / wall / yardstick.PEAK_BF16_FLOPS
