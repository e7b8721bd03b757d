"""Readings for the check's limits, at a cell's own size, on the card:
the program's sound runs, the control (the plain reference in the
program's place, its products in float8) and, for training, the planted
fault that leaves half of each batch out.  The benchmark's own runs do not
run this.

    python3 bench/control.py --workload <name> --seeds 1 2 3 ... [--control-seeds 3]
        [--seconds 8] [--out chiprun_out/control.jsonl]

One process takes every seed in turn: set-up, a window of ``--seconds``,
the program's numbers as a run computes them; then, on the first
``--control-seeds`` seeds, the control's numbers (and the fault's) against
the same reference.  One JSON line a seed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def readings(cell, seed: int, seconds: float, device, control: bool) -> dict:
    import torch

    import harness

    drv = harness.driver_for(cell, seed, device)
    t0 = time.perf_counter()
    drv.setup()
    harness.sync(device)
    iters, _, _ = harness.window(drv, seconds, False)
    row = {"seed": seed, "setup_s": time.perf_counter() - t0, **after_window(drv, iters, control)}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    row["total_s"] = time.perf_counter() - t0
    return row


def after_window(drv, iters, control: bool) -> dict:
    """The program's numbers over the window ``iters``, and with
    ``control`` the control's (and training's half-batch fault's)."""

    row = {"calls": len(iters)}
    drv.release()
    kind = drv.mix["kind"]
    if kind == "train":
        exact = drv.reference()
        row["program"] = drv.numbers(drv.program_readings(), exact)
        row["losses"] = {"program": drv.losses, "reference": exact["losses"]}
        if control:
            row["control"] = drv.numbers(drv.reference(drv.family.fp8), exact)
            half = list(range(drv.mix["batch"] // 2))
            row["half_batch"] = drv.numbers(drv.reference(rows=half), exact)
    elif kind == "prefill_closed":
        row["program"] = drv.readings(iters)
        if control:
            row["control"] = drv.readings(iters, control=True)
    else:
        gaps = drv.gaps()
        row["program"] = {"served_gap": float(gaps.max())}
        row["served_tokens"] = int(gaps.numel())
        row["nonzero_gaps"] = sorted((float(g) for g in gaps if g > 0), reverse=True)[:8]
        if control:
            cg = drv.gaps(control=True)
            row["control"] = {"served_gap": float(cg.max())}
            row["control_positions"] = int(cg.numel())
            row["control_median_gap"] = float(cg.median())
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for n, seed in enumerate(args.seeds):
            row = readings(cell, seed, args.seconds, torch.device("cuda", 0),
                           n < args.control_seeds)
            row["workload"] = args.workload
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
