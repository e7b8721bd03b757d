"""The torch side of :mod:`repro_torch.obs.trace` on the LM path: the step
span and the CUDA-event timer that gives spans their device time.

A step (one prefill, one decode step, one train step, one optimizer update)
opens :func:`step` once a call.  Tracing is on for the call when
``obs.trace`` is enabled, or while a ``torch.profiler`` records: the step
checks the profiler's flag once and runs the call inside
``trace.tracing()``, so a profile of the program carries its spans without a
switch of its own.  The spans stay in ``obs.trace``'s buffer: none is
mirrored into the profiler as a ``record_function`` range, whose device-side
copy would read as device work.

On a CUDA device, outside a graph capture, the call's timed spans record a
timing event on the call's stream at entry and exit (:class:`CudaTimer`);
``obs.trace.events()`` reads each pair once the caller has synchronised.
The events come from a pool that each call tops up as it ends, so that the
marks inside a call create no CUDA event.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from repro_torch.obs import trace

# timing events free for reuse, by device index: a decode step records
# hundreds, and creating one costs a CUDA runtime call inside the step
_FREE: Dict[int, List[torch.cuda.Event]] = {}


class CudaTimer:
    """``obs.trace``'s timer on one CUDA stream.  Marks come from a pool of
    events, which :meth:`refill` tops up once the call is enqueued."""

    __slots__ = ("stream", "free", "used")

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream
        self.free = _FREE.setdefault(stream.device.index, [])
        self.used = 0

    def record(self) -> torch.cuda.Event:
        self.used += 1
        try:
            ev = self.free.pop()
        except IndexError:  # the pool is empty (or another thread's call took the last)
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def elapsed_ms(self, a: torch.cuda.Event, b: torch.cuda.Event) -> float:
        b.synchronize()
        ms = a.elapsed_time(b)
        self.free += (a, b)
        return ms

    def refill(self) -> None:
        """Leave as many free events as this call recorded, each recorded
        once after the call's work so that its CUDA event exists: the
        next call's marks then create none (each creation is a CUDA
        runtime call, slower still while a profiler records)."""

        while len(self.free) < self.used:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            self.free.append(ev)


def timer(device: torch.device) -> Optional[CudaTimer]:
    """The timer of a call on ``device``: None on the CPU, and while the
    stream captures a CUDA graph (a timing event there is an error)."""

    if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    return CudaTimer(torch.cuda.current_stream(device))


def step(name: str, tokens: Optional[torch.Tensor] = None, device=None):
    """The span of one call of a step, carrying the call's ``tokens``
    (their count) and timing the device on their device (or ``device``);
    the shared null context when tracing is off and no profiler records."""

    if not (trace.tracing_enabled() or torch.autograd._profiler_enabled()):
        return trace.NULL
    return _traced(name, tokens, device)


@contextlib.contextmanager
def _traced(name: str, tokens: Optional[torch.Tensor], device):
    args = {} if tokens is None else {"tokens": tokens.numel()}
    dev = torch.device(device) if tokens is None else tokens.device
    t = timer(dev)
    with trace.tracing(), trace.call(name, t, **args):
        yield
    if t is not None:  # once the call is enqueued, while its caller waits for the card
        t.refill()
