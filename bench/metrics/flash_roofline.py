"""The flash kernels' share of their roofline in the traced prefill calls:
the least time of every attention call of those calls (the frozen bound of
``yardstick.flash_bound_s``, the same work whatever route runs it) over
the device time of the operations named ``flash_*`` or ``split_kv_*``.
Counted only where the program's flash counters show one call a layer."""

import yardstick

NAMES = ("flash_", "split_kv_")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    d, B = run.driver.dims, run.driver.mix["batch"]
    calls = sum(v for k, v in run.counters.items() if k.startswith("flash_attention."))
    if calls != d.num_layers * len(run.traced):
        return None
    busy = sum(b - a for a, b, name in tr.kernels if any(n in name for n in NAMES))
    if busy <= 0:
        return None
    bound = sum(d.num_layers * yardstick.flash_bound_s(B, c["length"], c["length"], d.num_heads,
                                                       d.num_kv_heads, d.head_dim)
                for c in run.traced)
    return 100.0 * bound / busy
