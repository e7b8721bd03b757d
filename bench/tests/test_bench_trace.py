"""The traced slice's named ranges: a device operation goes to the range
whose host operation launched it, forward, recompute and backward alike."""

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils import checkpoint

import devtrace

LAUNCHERS = ("aten::mm", "aten::sub_", "aten::mul")


def test_ranges_take_forward_recompute_and_backward():
    """A checkpointed block ``attention(x @ w) + 1`` and an update: each
    ``mm`` stands for one launch.  Attention's are its two forward
    products, their two recomputed ones and the four of their backward;
    ``x @ w``'s four are no range's; the update's two are the optimizer's."""

    gen = torch.Generator().manual_seed(5)
    w = torch.randn(64, 64, generator=gen, requires_grad=True)
    x = torch.randn(8, 64, generator=gen, requires_grad=True)

    def attention(h):
        with record_function("bench.attention"):
            return torch.softmax(h @ h.transpose(-1, -2), -1) @ h

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = checkpoint.checkpoint(lambda h: attention(h @ w) + 1, x, use_reentrant=False)
        y.sum().backward()
        with torch.no_grad(), record_function("bench.optimizer"):
            w.sub_(w.grad * 0.1)
    ops, _ = devtrace.host_ops(prof)
    launches = [(o.start, 1.0) for o in ops if o.name in LAUNCHERS]
    assert len(launches) == 14
    assert devtrace.ranges_s(ops, launches) == {"bench.attention": 8.0, "bench.optimizer": 2.0}


def test_launches_outside_every_range_go_nowhere():
    ops = [devtrace.Op(0.0, 1.0, "aten::mm", 1, 0, 3), devtrace.Op(2.0, 3.0, "bench.x", 1, 0, -1)]
    assert devtrace.ranges_s(ops, [(0.5, 1.0), (1.5, 1.0), (2.5, 2.0)]) == {"bench.x": 2.0}
