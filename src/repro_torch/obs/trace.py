"""Zero-dependency span tracer for the staged pipeline and the LM path.

Spans are context managers::

    with trace.span("plan", method="isd"):
        ...

Disabled by default: ``span()`` then returns the shared no-op context
manager :data:`NULL`, whose enter/exit are empty slots-class methods, so
instrumented call sites cost one function call when tracing is off.  Hot
loops (the wavefront per-level loop) must not even pay that — they hoist
``tracing_enabled()`` once and call :func:`emit` with raw
``perf_counter_ns`` stamps only when it was true.

Enabled spans record Chrome-trace *complete* events (``"ph": "X"``): wall
timestamps in microseconds, duration, pid/tid, plus the span's keyword args.
Nesting is tracked per thread through a ``threading.local`` stack — two
planner threads tracing concurrently interleave in the buffer but each
thread's own spans keep strict stack discipline (pinned by a test).  The
buffer is a bounded deque guarded by one lock; exceeding the bound drops the
*oldest* events, so a long serving run keeps its most recent waves.
:class:`tracing` blocks count across threads: recording stays on until the
last open one ends, whatever :func:`disable` does meanwhile.

The LM path adds three things:

* **Calls.**  :func:`call` opens a step span (one prefill, one decode step,
  one train step).  It gives a new ``call`` id that every span under it
  carries in its args; a step span opened under another one joins its call.
  :func:`module` opens a span of one part of a step (``lm.norm`` of layer
  3), with no keyword dict to build, so its off path allocates nothing.
  Another thread takes part in a call only through :func:`joined`: a
  checkpointed block keeps the :func:`current` span of its forward and
  joins it in its recompute, which autograd may run on its device thread.
* **One clock with torch.profiler.**  ``ts`` stays microseconds since this
  module's import on ``perf_counter_ns``; every event also carries
  ``epoch_ns``, its start in Unix-epoch nanoseconds, the clock of the
  profiler's events.  The anchor pair (``time.time_ns()``,
  ``perf_counter_ns()``) is taken whenever tracing turns on.
  :func:`merge_chrome_trace` lays the spans over a profiler's Chrome trace.
* **Device time.**  A call may carry a *timer*: ``record()`` returns a mark
  on the device's stream, ``elapsed_ms(a, b)`` the device milliseconds
  between two marks once they completed.  Spans opened with ``timed=True``
  under such a call record a mark at entry and exit; :func:`events` resolves
  each pair into ``dur_device`` (ms) in the event's args, so read the events
  after the device work is synchronised.  A pair spans the device's waits
  for the host inside the span too.  The timer comes from the caller
  (:mod:`repro_torch.spans` builds one on CUDA events): this module knows no
  device.

Everything here is stdlib-only on purpose: this module sits below
``repro_torch.core.policy`` in the dependency stack and must never pull in
numpy/jax/torch.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

MAX_EVENTS = 65536

# finished spans, converted to Chrome events by events()
_events: deque = deque(maxlen=MAX_EVENTS)
_events_lock = threading.Lock()
_tls = threading.local()
# recording: switched on by enable(), or inside a tracing() block
_enabled = False
_switched = False
_held = 0  # tracing() blocks open, on every thread
_switch_lock = threading.Lock()

# perf_counter_ns is monotonic but epoch-less; anchor ts=0 at import so
# exported traces start near zero instead of at machine uptime
_T0_NS = time.perf_counter_ns()
# (Unix-epoch ns, perf_counter ns) taken together: a stamp's epoch_ns
_anchor = (time.time_ns(), _T0_NS)

_now = time.perf_counter_ns
_ident = threading.get_ident
_call_ids = itertools.count(1)


def _switch(on: Optional[bool] = None, held: int = 0) -> None:
    global _enabled, _switched, _held, _anchor
    with _switch_lock:
        if on is not None:
            _switched = on
        _held += held
        now = _switched or _held > 0
        if now and not _enabled:
            _anchor = (time.time_ns(), time.perf_counter_ns())
        _enabled = now


def enable() -> None:
    """Turn span recording on (global, all threads)."""

    _switch(True)


def disable() -> None:
    """Turn the switch off; recording stays on while a :class:`tracing`
    block is open."""

    _switch(False)


def tracing_enabled() -> bool:
    return _enabled


class tracing:
    """``with trace.tracing():`` — recording on for the block.  Blocks
    count across threads: one thread's block ending leaves another's on."""

    __slots__ = ()

    def __enter__(self) -> "tracing":
        _switch(held=1)
        return self

    def __exit__(self, *exc) -> None:
        _switch(held=-1)


# the open spans of this thread, innermost last
def _stack() -> List["_Span"]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _keep(span: "_Span") -> None:
    span.tid = _ident()
    span.anchor = _anchor
    with _events_lock:
        _events.append(span)


def emit(
    name: str,
    t0_ns: int,
    t1_ns: Optional[int] = None,
    cat: str = "repro",
    **args: Any,
) -> None:
    """Record one complete event from raw ``perf_counter_ns`` stamps.

    The low-level hook for hot loops that hoist the enabled check: caller
    guarantees tracing was enabled when the stamps were taken.
    """

    if t1_ns is None:
        t1_ns = time.perf_counter_ns()
    stack = _stack()
    span = _Span(name, cat, args)
    span._open(stack[-1] if stack else None)
    span.depth = len(stack)
    span.t0, span.t1 = t0_ns, t1_ns
    _keep(span)


class _Span:
    """An open span, then (once closed) a buffered one: the Chrome event is
    built when :func:`events` reads it, so a span costs one object while
    the program runs.  It takes its call and timer from the span it opens
    under."""

    __slots__ = ("name", "cat", "args", "layer", "timed", "parent", "depth", "call", "timer",
                 "t0", "t1", "tid", "anchor", "m0", "m1", "dur_device")

    def __init__(self, name: str, cat: str, args: Optional[Dict[str, Any]],
                 layer: Optional[int] = None, timed: bool = False):
        self.name = name
        self.cat = cat
        self.args = args
        self.layer = layer
        self.timed = timed
        self.m0 = self.dur_device = None

    def _open(self, top: Optional["_Span"]) -> None:
        if top is None:
            self.parent, self.depth, self.call, self.timer = None, 1, None, None
        else:
            self.parent, self.depth, self.call, self.timer = (
                top.name, top.depth + 1, top.call, top.timer)

    def __enter__(self) -> "_Span":
        stack = _stack()
        self._open(stack[-1] if stack else None)
        stack.append(self)
        if self.timed and self.timer is not None:
            self.m0 = self.timer.record()
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = _now()
        _stack().pop()
        if self.m0 is not None:
            self.m1 = self.timer.record()
        _keep(self)

    def event(self) -> dict:
        """The Chrome complete event, its device time read from its marks."""

        if self.m0 is not None:
            self.dur_device = self.timer.elapsed_ms(self.m0, self.m1)
            self.m0 = self.m1 = None
        args = dict(self.args) if self.args else {}
        if self.layer is not None:
            args["layer"] = self.layer
        args["depth"], args["parent"] = self.depth, self.parent
        if self.call is not None:
            args["call"] = self.call
        args["epoch_ns"] = self.anchor[0] + (self.t0 - self.anchor[1])
        if self.dur_device is not None:
            args["dur_device"] = self.dur_device
        return {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": (self.t0 - _T0_NS) / 1000.0,
            "dur": (self.t1 - self.t0) / 1000.0,
            "pid": os.getpid(),
            "tid": self.tid,
            "args": args,
        }


class _Call(_Span):
    """A step span: opens a call (a new id, its own timer), or joins the
    one it is opened under."""

    __slots__ = ("own_timer",)

    def __init__(self, name: str, args: Dict[str, Any], timer):
        super().__init__(name, "lm", args, timed=True)
        self.own_timer = timer

    def _open(self, top: Optional[_Span]) -> None:
        super()._open(top)
        if self.call is None:
            self.call, self.timer = next(_call_ids), self.own_timer


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL = _NullSpan()


def span(name: str, cat: str = "repro", **args: Any):
    """A timed span context manager (no-op while tracing is disabled)."""

    if not _enabled:
        return NULL
    return _Span(name, cat, args)


def call(name: str, timer=None, **args: Any):
    """A step span (no-op while tracing is disabled).  Outside any call it
    opens a new one, whose spans with ``timed`` record device marks on
    ``timer`` (None: no device time); inside a call it joins that call."""

    if not _enabled:
        return NULL
    return _Call(name, args, timer)


def module(name: str, layer: Optional[int] = None, timed: bool = False):
    """A span of one part of a step, with its ``layer`` index when it has
    one; ``timed`` asks for device time (the call's timer)."""

    if not _enabled:
        return NULL
    return _Span(name, "lm", None, layer, timed)


def current() -> Optional[_Span]:
    """This thread's innermost open span (None while tracing is off)."""

    if not _enabled:
        return None
    stack = _stack()
    return stack[-1] if stack else None


class _Join:
    """Opens ``span`` on a thread with no span of its own, for the
    duration of the block."""

    __slots__ = ("span",)

    def __init__(self, span: _Span):
        self.span = span

    def __enter__(self) -> "_Join":
        _stack().append(self.span)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()


def joined(span: Optional[_Span]):
    """Run a block under ``span``, a span open on another thread (from
    :func:`current`), when this thread has no span open: its spans then
    join that span's call and take its timer.  A no-op where ``span`` is
    None or this thread has a span open."""

    if span is None or not _enabled or _stack():
        return NULL
    return _Join(span)


def events() -> List[dict]:
    """Snapshot of the buffered events, oldest first, each timed span's
    ``dur_device`` read from its marks (the device work must be done)."""

    with _events_lock:
        spans = list(_events)
    return [span.event() for span in spans]


def clear() -> None:
    with _events_lock:
        _events.clear()


def to_chrome_trace() -> Dict[str, Any]:
    """The buffered spans in Chrome trace-event format (load in
    ``chrome://tracing`` / Perfetto)."""

    return {"traceEvents": events(), "displayTimeUnit": "ms"}


def trace_json(indent: Optional[int] = None) -> str:
    return json.dumps(to_chrome_trace(), indent=indent)


def merge_chrome_trace(profile: Dict[str, Any]) -> Dict[str, Any]:
    """A torch.profiler Chrome trace (``export_chrome_trace``'s JSON,
    loaded) with the buffered spans laid over it on its clock: its ``ts``
    are microseconds from ``baseTimeNanoseconds`` (0 where absent).  The
    spans keep their own thread tracks, named "repro_torch spans"."""

    base = profile.get("baseTimeNanoseconds", 0)
    spans, tracks = [], set()
    for ev in events():
        spans.append(dict(ev, ts=(ev["args"]["epoch_ns"] - base) / 1000.0))
        tracks.add((ev["pid"], ev["tid"]))
    names = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
              "args": {"name": "repro_torch spans"}} for pid, tid in sorted(tracks)]
    return dict(profile, traceEvents=list(profile.get("traceEvents", [])) + names + spans)
