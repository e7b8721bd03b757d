"""The traced slice of a run: ``torch.profiler`` over a bounded number of
the window's calls, read into device intervals, the host spans around
them, the device's busy time and the breakdown.

Each call in the slice runs inside a ``bench.iter`` span that the harness
opens (its end follows the call's device sync), so a device event is
assigned to the call whose span holds its start.

A driver may also open named ranges around parts of the program during the
slice (``bench.<part>``).  A device operation belongs to such a part when
the host operation that launched it lies inside the range, or inside the
backward of an operation that ran inside it (linked by the autograd
sequence number); :func:`ranges_s` sums their device time.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "bench."  # the harness's ranges
SPAN = PREFIX + "iter"
TOP = 10
GAPS_NAMED = 5000


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[float, float, str]]  # device events (start s, end s, name)
    spans: List[Tuple[float, float]]  # the bench.iter spans, in call order
    host: List[Tuple[float, float, str]]  # host operations, by start
    window_s: float  # host clock over the slice, from its first call to its last sync
    parts: Dict[str, float] = dataclasses.field(default_factory=dict)  # device s a named range

    @property
    def busy_s(self) -> float:
        return union_s([(a, b) for a, b, _ in self.kernels])

    def kernels_of(self, call: int) -> List[Tuple[float, float, str]]:
        """The device events that started inside call ``call``'s span."""

        a, b = self.spans[call]
        lo = bisect.bisect_left(self.kernels, (a,))
        hi = bisect.bisect_right(self.kernels, (b, float("inf")))
        return self.kernels[lo:hi]


def union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile(calls: List[Callable[[], None]], sync: Callable[[], None]) -> Trace:
    """Run ``calls`` in turn under the profiler, each inside a
    ``bench.iter`` span that ends after ``sync``."""

    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for fn in calls:
            with record_function(SPAN):
                fn()
                sync()
        window_s = time.perf_counter() - t0
    return _read(prof, window_s)


def _read(prof, window_s: float) -> Trace:
    cuda = torch.autograd.DeviceType.CUDA
    kernels, spans, host, launched = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        a, b, name = e.start_ns() * 1e-9, e.end_ns() * 1e-9, e.name()
        if e.device_type() == cuda:
            if not name.startswith(PREFIX):  # a range's device-side copy spans its kernels: no operation
                kernels.append((a, b, name))
                launched.append((e.linked_correlation_id(), b - a))  # the operation that launched it
        elif name == SPAN:
            spans.append((a, b))
        else:
            host.append((a, b, name))
    kernels.sort()
    spans.sort()
    host.sort()
    ops, op_start = host_ops(prof)
    timed = [(op_start[c], d) for c, d in launched if c in op_start]
    return Trace(kernels, spans, host, window_s, ranges_s(ops, timed))


def host_ops(prof) -> Tuple[List["Op"], Dict[int, float]]:
    """PyTorch's host operations of a profile (not the runtime calls), and
    the start of each by its id, which a device event names as the
    operation that launched it."""

    cuda = torch.autograd.DeviceType.CUDA
    ops, op_start = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda and e.linked_correlation_id() == 0:
            a = e.start_ns() * 1e-9
            ops.append(Op(a, e.end_ns() * 1e-9, e.name(), e.start_thread_id(), e.fwd_thread_id(),
                          e.sequence_nr()))
            op_start[e.correlation_id()] = a
    return ops, op_start


@dataclasses.dataclass(frozen=True)
class Op:
    """A host operation of the trace: its interval, thread, and autograd
    sequence number (-1 when it records none); a backward operation names
    the thread of the forward one it belongs to in ``fwd_thread``."""

    start: float
    end: float
    name: str
    thread: int
    fwd_thread: int
    seq: int

    @property
    def key(self) -> Tuple[int, int]:
        """The forward operation this one is, or is the backward of."""

        return (self.fwd_thread or self.thread, self.seq)


def ranges_s(ops: List[Op], launches: List[Tuple[float, float]], prefix: str = PREFIX,
             scan: int = 4096) -> Dict[str, float]:
    """Device seconds by named range: each (start of the launching host
    operation, device seconds) of ``launches`` goes to the range of the
    innermost host operation that holds that start, among the ranges named
    ``prefix...`` and the operations that carry a sequence number.  Such an
    operation belongs to a range when it, or the forward operation it is
    the backward of, ran inside that range on the range's thread."""

    ops = sorted(ops, key=lambda o: o.start)
    op_starts = [o.start for o in ops]
    named = [o for o in ops if o.name.startswith(prefix) and o.name != SPAN]
    owner: Dict[Tuple[int, int], str] = {}
    for r in named:
        for o in ops[bisect.bisect_left(op_starts, r.start):bisect.bisect_right(op_starts, r.end)]:
            if o.seq >= 0 and not o.fwd_thread and o.thread == r.thread:
                owner[o.key] = r.name
    marks = sorted([(o.start, o.end, owner.get(o.key)) for o in ops if o.seq >= 0]
                   + [(r.start, r.end, r.name) for r in named],
                   key=lambda m: (m[0], -m[1]))  # of two that start together, the outer first
    starts = [m[0] for m in marks]
    out: Dict[str, float] = {}
    for t, seconds in launches:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - scan, -1), -1):
            a, b, name = marks[j]
            if a <= t <= b:
                if name is not None:
                    out[name] = out.get(name, 0.0) + seconds
                break
    return out


def device_ops(trace: Trace) -> List[List]:
    """The device operations that took most time, summed by name."""

    by: Dict[str, float] = {}
    for a, b, name in trace.kernels:
        by[name[:160]] = by.get(name[:160], 0.0) + (b - a)
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(trace: Trace) -> List[List]:
    """The idle time between device operations inside the calls, summed by
    the innermost host operation that was running at each gap's middle."""

    gaps = []
    for call, (a, b) in enumerate(trace.spans):
        end = a
        for ka, kb, _ in trace.kernels_of(call):
            if ka > end:
                gaps.append((ka - end, end, ka))
            end = max(end, kb)
        if b > end:
            gaps.append((b - end, end, b))
    gaps.sort(reverse=True)
    starts = [h[0] for h in trace.host]
    by: Dict[str, float] = {}
    for length, a, b in gaps[:GAPS_NAMED]:
        name = _host_at(trace.host, starts, (a + b) / 2) or "no host operation"
        by[name] = by.get(name, 0.0) + length
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def _host_at(host, starts, t: float, scan: int = 256) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - scan, -1), -1):
        a, b, name = host[j]
        if a <= t <= b:
            return name[:160]
    return None
