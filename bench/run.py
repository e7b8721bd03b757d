"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It runs from the root of a checkout, on the machine that holds the card:
set-up (counted in ``setup_s``), a window of ``--seconds`` in which the
cell's traffic drives the port, the cell's metrics (``--trace 0``: its
end-to-end metrics; ``--trace 1``: its per-layer metrics, with a profiled
slice at the start of the window), then the check of the window's output
against the plain reference.  The last line on standard output is the
result as one JSON object; the numbers compared, each beside its limit, are
the last lines on standard error.  Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits 2; if JAX or the JAX
package is loaded once the window has closed, it exits 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    import harness

    cell = harness.load_cell(args.workload)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_PROCESS)
    found = harness.jax_modules()
    if found:
        print(f"JAX or the JAX package loaded in the run: {found}", file=sys.stderr)
        return 3
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
