"""Zero-dependency span tracer for the staged pipeline.

Spans are context managers::

    with trace.span("plan", method="isd"):
        ...

Disabled by default: ``span()`` then returns a shared no-op context manager
whose enter/exit are empty slots-class methods, so instrumented call sites
cost one function call when tracing is off.  Hot loops (the wavefront
per-level loop) must not even pay that — they hoist ``tracing_enabled()``
once and call :func:`emit` with raw ``perf_counter_ns`` stamps only when it
was true.

Enabled spans record Chrome-trace *complete* events (``"ph": "X"``): wall
timestamps in microseconds, duration, pid/tid, plus the span's keyword args.
Nesting is tracked per thread through a ``threading.local`` stack — two
planner threads tracing concurrently interleave in the buffer but each
thread's own spans keep strict stack discipline (pinned by a test).  The
buffer is a bounded deque guarded by one lock; exceeding the bound drops the
*oldest* events, so a long serving run keeps its most recent waves.

Everything here is stdlib-only on purpose: this module sits below
``repro_torch.core.policy`` in the dependency stack and must never pull in
numpy/jax.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

MAX_EVENTS = 65536

_events: deque = deque(maxlen=MAX_EVENTS)
_events_lock = threading.Lock()
_tls = threading.local()
_enabled = False

# perf_counter_ns is monotonic but epoch-less; anchor ts=0 at import so
# exported traces start near zero instead of at machine uptime
_T0_NS = time.perf_counter_ns()


def enable() -> None:
    """Turn span recording on (global, all threads)."""

    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def tracing_enabled() -> bool:
    return _enabled


class tracing:
    """``with trace.tracing():`` — enable within a block, restore on exit."""

    __slots__ = ("_prev",)

    def __enter__(self) -> "tracing":
        self._prev = _enabled
        enable()
        return self

    def __exit__(self, *exc) -> None:
        global _enabled
        _enabled = self._prev


def _stack() -> List[str]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


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
    ev = {
        "name": name,
        "cat": cat,
        "ph": "X",
        "ts": (t0_ns - _T0_NS) / 1000.0,
        "dur": (t1_ns - t0_ns) / 1000.0,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": dict(args, depth=len(stack), parent=stack[-1] if stack else None),
    }
    with _events_lock:
        _events.append(ev)


class _Span:
    __slots__ = ("name", "cat", "args", "t0")

    def __init__(self, name: str, cat: str, args: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        _stack().append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        ev = {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": (self.t0 - _T0_NS) / 1000.0,
            "dur": (t1 - self.t0) / 1000.0,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": dict(
                self.args,
                depth=len(stack) + 1,
                parent=stack[-1] if stack else None,
            ),
        }
        with _events_lock:
            _events.append(ev)


class _NullSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _NullSpan()


def span(name: str, cat: str = "repro", **args: Any):
    """A timed span context manager (no-op while tracing is disabled)."""

    if not _enabled:
        return _NULL
    return _Span(name, cat, args)


def events() -> List[dict]:
    """Snapshot of the buffered events, oldest first."""

    with _events_lock:
        return list(_events)


def clear() -> None:
    with _events_lock:
        _events.clear()


def to_chrome_trace() -> Dict[str, Any]:
    """The buffered spans in Chrome trace-event format (load in
    ``chrome://tracing`` / Perfetto)."""

    return {"traceEvents": events(), "displayTimeUnit": "ms"}


def trace_json(indent: Optional[int] = None) -> str:
    return json.dumps(to_chrome_trace(), indent=indent)
