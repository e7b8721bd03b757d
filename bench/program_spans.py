"""The program's own spans in the traced slice: ``repro_torch.obs.trace``'s
events, which carry their start on the profiler's clock (``epoch_ns``) and,
on the card, their device time (``dur_device``, ms: from a timing event at
the span's entry to one at its exit).

A span belongs to the traced call whose ``bench.iter`` interval holds its
start.  A program without such spans (no ``epoch_ns`` or no ``dur_device``,
as on the CPU) gives nothing to read.

A span's device time counts its work, not the card's waits for the host:
``dur_device`` less the time the card sat idle while the host was inside
the span.  The card is idle only once all it was given is done, the
span's entry event included, and the exit event is not given before the
host leaves the span; so an idle instant while the span is open on the
host lies between the two events, and every other instant between them
runs the span's work (one stream).  The idle time comes from the
profiler's device events, on the spans' clock.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Iterable, List, Optional, Tuple


def device_ms_per_call(run, names: Iterable[str]) -> Optional[float]:
    """The device ms a traced call of the spans named ``names``, summed over
    each call, mean over the calls that hold any; None where no such span
    carries its device time."""

    if run.trace is None or not run.trace.spans:
        return None
    from repro_torch.obs import trace

    per_call = sums(trace.events(), run.trace.spans, run.trace.kernels, set(names))
    return statistics.fmean(per_call) if per_call else None


def sums(events: List[dict], calls: List[Tuple[float, float]],
         kernels: List[Tuple[float, float, str]], names) -> List[float]:
    """Per call of ``calls`` (start s, end s) that holds one, the summed
    device ms of the events named ``names`` that start inside it: each
    one's ``dur_device`` less the card's idle time (outside every interval
    of ``kernels``, (start s, end s, name)) while the host was inside it."""

    starts = [a for a, _ in calls]
    busy = Busy(kernels)
    total = {}
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("name") not in names or "dur_device" not in args or "epoch_ns" not in args:
            continue
        t = args["epoch_ns"] * 1e-9
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= calls[i][1]:
            t1 = t + ev["dur"] * 1e-6
            idle_s = (t1 - t) - busy.within(t, t1)
            total[i] = total.get(i, 0.0) + args["dur_device"] - idle_s * 1e3
    return [total[i] for i in sorted(total)]


class Busy:
    """The union of device intervals, and its length inside any interval."""

    def __init__(self, kernels: List[Tuple[float, float, str]]):
        self.starts: List[float] = []
        self.ends: List[float] = []
        for a, b, _ in sorted(kernels):
            if self.ends and a <= self.ends[-1]:
                self.ends[-1] = max(self.ends[-1], b)
            else:
                self.starts.append(a)
                self.ends.append(b)
        self.before = [0.0]  # the union's length before each of its intervals
        for a, b in zip(self.starts, self.ends):
            self.before.append(self.before[-1] + b - a)

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)  # the intervals starting at or before t
        if i == 0:
            return 0.0
        return self.before[i - 1] + min(t, self.ends[i - 1]) - self.starts[i - 1]

    def within(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a) if b > a else 0.0
