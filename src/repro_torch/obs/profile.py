"""Predicted-vs-measured strategy profiler.

``CostModelPolicy`` scores every strategy offer (chunk/skew/dswp/serial)
per recurrence SCC and keeps the full scoreboard on the winning
:class:`~repro_torch.core.policy.StrategyPlan` (its ``offers`` field).  This
module closes ROADMAP item 3c's loop: run the compiled executable, measure
real wall time, and put the measurement NEXT TO every offer's predicted
cost — one row per recurrence SCC — so cost-model mispredictions are
diffable across PRs from the ``SYNC_REPORTS`` artifact alone, and CI can
check the model never inverts a clearly-measured ordering
(``benchmarks/run.py --check-baseline``).

Measured numbers are wall time of ``Executable.run()`` (best of
``repeats``), normalized per schedule level when the backend exposes a
depth, because predicted costs are per-level too (depth × width terms).
Rows are plain JSON-serializable dicts.

Stdlib-only; executables come in from the caller, never imported here.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional

_RECORDS: deque = deque(maxlen=512)


def record(row: Dict[str, Any]) -> None:
    _RECORDS.append(dict(row))


def records() -> List[Dict[str, Any]]:
    return [dict(r) for r in _RECORDS]


def clear() -> None:
    _RECORDS.clear()


def _schedule_depth(exe) -> Optional[int]:
    """Level count of the executable's schedule, when the backend exposes
    one (wavefront artifact, or the compiled program's report summary)."""

    wf = exe.artifacts.get("wavefront")
    if wf is not None:
        return int(wf.depth)
    summary = exe.report().summary()
    depth = summary.get("wavefront_depth")
    return int(depth) if depth is not None else None


def profile_executable(
    exe,
    program: str = "",
    store: Optional[dict] = None,
    repeats: int = 3,
) -> List[Dict[str, Any]]:
    """Measure ``exe.run()`` and pair it with every recurrence SCC's
    predicted offer costs.  Returns the rows (one per recurrence; a single
    whole-program row when the plan has none) and appends them to the
    module record buffer."""

    init = store if store is not None else exe.plan.program.initial_store()
    best = None
    for _ in range(max(1, repeats)):
        fresh = {a: dict(c) for a, c in init.items()}
        t0 = time.perf_counter()
        exe.run(store=fresh)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    measured_us = best * 1e6
    depth = _schedule_depth(exe)

    summary = exe.report().summary()
    recurrences = summary.get("scc", {}).get("recurrences", [])
    rows: List[Dict[str, Any]] = []
    base = {
        "program": program,
        "backend": exe.backend,
        "measured_us": measured_us,
        "levels": depth,
        "measured_us_per_level": (measured_us / depth) if depth else None,
    }
    if recurrences:
        for rec in recurrences:
            offers = rec.get("offers") or {}
            rows.append(
                dict(
                    base,
                    strategy=rec.get("strategy"),
                    predicted_cost=rec.get("cost"),
                    predicted=dict(offers),
                )
            )
    else:
        rows.append(dict(base, strategy="doall", predicted_cost=None, predicted={}))
    for row in rows:
        record(row)
    return rows
