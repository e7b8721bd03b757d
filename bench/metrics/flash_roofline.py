"""The flash kernels' share of their roofline in the traced prefill calls:
the least time of every attention call of those calls (the cell's family's
``flash_calls``, each at the frozen bound of ``yardstick.flash_bound_s``,
the same work whatever route runs it) over the device time of the
operations named ``flash_*`` or ``split_kv_*``.  Counted only where the
program's flash counters show one call an attention layer."""

import yardstick

NAMES = ("flash_", "split_kv_")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    fam, d, B = run.driver.family, run.driver.dims, run.driver.mix["batch"]
    shapes = [fam.flash_calls(d, B, c["length"]) for c in run.traced]
    calls = sum(v for k, v in run.counters.items() if k.startswith("flash_attention."))
    if calls != sum(len(s) for s in shapes):
        return None
    busy = sum(b - a for a, b, name in tr.kernels if any(n in name for n in NAMES))
    if busy <= 0:
        return None
    return 100.0 * sum(yardstick.flash_bound_sum(s) for s in shapes) / busy
