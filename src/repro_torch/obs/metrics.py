"""Unified metrics registry: counters, gauges, histograms behind one
thread-safe surface.

This absorbs the repo's three ad-hoc stat dicts (`_ANALYSIS_STATS` in the
parallelizer, `_INSPECTOR_STATS` in the inspector, `CacheStats` on the
global compile cache) — those modules now hold registry-backed
:class:`Counter` objects and their ``*_cache_stats()`` functions are thin
views over the same values — and carries the new pipeline metrics:
speculation rollbacks, WavefrontError rejections, per-backend run counts,
and the serving loop's per-wave latency histograms.

Instruments are identified by dotted names (``"compile_cache.hits"``,
``"serve.run_ms"``).  ``counter(name)`` is get-or-create, so independent
modules naming the same metric share one instrument.  A single module lock
guards creation and all updates: the hot increments here are cache-counter
bumps at most a few thousand per second, far below the contention regime
where per-instrument locks would matter.

Stdlib-only, same as the rest of ``repro_torch.obs``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

_LOCK = threading.Lock()

# bounded percentile reservoir: big enough for every wave of any realistic
# serving run, small enough to sort on demand
HISTOGRAM_SAMPLES = 4096


class Counter:
    """Monotonic (reset-able) integer counter.

    Constructed standalone (``Counter()``) for private per-instance stats —
    test-local :class:`repro_torch.compile.cache.CompileCache` objects keep
    unregistered counters — or via :func:`counter` to register globally.
    """

    __slots__ = ("name", "_value")

    def __init__(self, name: str = ""):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def reset(self) -> None:
        with _LOCK:
            self._value = 0

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins numeric value."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str = ""):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        with _LOCK:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        with _LOCK:
            self._value = 0.0

    def snapshot(self):
        return self._value


class Histogram:
    """Streaming summary (count/sum/min/max) plus a bounded reservoir of the
    most recent samples for p50/p99."""

    __slots__ = ("name", "count", "sum", "min", "max", "_samples")

    def __init__(self, name: str = ""):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: deque = deque(maxlen=HISTOGRAM_SAMPLES)

    def observe(self, v: float) -> None:
        v = float(v)
        with _LOCK:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._samples.append(v)

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile over the retained reservoir; None when
        nothing was observed."""

        with _LOCK:
            data = sorted(self._samples)
        if not data:
            return None
        rank = max(0, min(len(data) - 1, int(round(p / 100.0 * (len(data) - 1)))))
        return data[rank]

    def reset(self) -> None:
        with _LOCK:
            self.count = 0
            self.sum = 0.0
            self.min = None
            self.max = None
            self._samples.clear()

    def snapshot(self) -> Dict[str, Optional[float]]:
        with _LOCK:
            data = sorted(self._samples)
            count, total = self.count, self.sum
            lo, hi = self.min, self.max

        def _pct(p: float) -> Optional[float]:
            if not data:
                return None
            rank = max(
                0, min(len(data) - 1, int(round(p / 100.0 * (len(data) - 1))))
            )
            return data[rank]

        return {
            "count": count,
            "mean": (total / count) if count else None,
            "min": lo,
            "max": hi,
            "p50": _pct(50.0),
            "p99": _pct(99.0),
        }


class Registry:
    """Name → instrument store; get-or-create per kind, type-checked."""

    def __init__(self) -> None:
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls):
        with _LOCK:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name)
                self._instruments[name] = inst
                return inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        with _LOCK:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, object]:
        """name → value (counters/gauges) or summary dict (histograms);
        JSON-serializable, suitable for the CI artifact."""

        with _LOCK:
            items = list(self._instruments.items())
        return {name: inst.snapshot() for name, inst in sorted(items)}

    def reset(self) -> None:
        """Zero every instrument IN PLACE — modules hold direct references
        to their counters, so instruments are never discarded, only reset."""

        with _LOCK:
            items = list(self._instruments.values())
        for inst in items:
            inst.reset()


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def snapshot() -> Dict[str, object]:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
