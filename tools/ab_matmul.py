"""A/B timing of the pipelined matmul's routes on operands TMA cannot
describe, for two trees of this repo on one CUDA card.

Each process imports ``repro_torch`` from one tree's ``src``, builds that
tree's matmul sources and calls the public ``pipelined_matmul.ops.matmul``
at ``SHAPES`` in bf16 and f32: (300, 257, 130), the smoke's ragged-stride
check, and (2048, 2048, 49155), granite-3-2b's LM head over one
2048-token sequence (B's rows are 98310 bytes).  At each shape, on inputs
drawn from a seed (the same in both trees): the route the call took and
its error against the plain version (``chip_smoke.TOL``), then in the same
rounds as ``torch.matmul`` (TF32 off) the device time alone (L2 flushed)
and the host's enqueue time (``chip_smoke._held_times``), and the
single-launch time (``chip_smoke._time_turns_ms``).  The trees' processes
alternate (A B B A ...), so that a slow host shows in both.

    mkdir -p experiments/parent
    git archive <commit> | tar -x -C experiments/parent
    python3 tools/ab_matmul.py --a experiments/parent --b .

Without ``--b`` it times tree A alone, in ``--pairs`` processes.  Prints
the card's name and power limit, one JSON line a process, then one summary
line: each tree's per-process medians at each shape and, with two trees,
the ratio of their medians (B / A).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (M, K, N): strides TMA cannot describe, at a launch's size and at the LM
# head of src/repro/configs/granite_3_2b.py (d_model 2048, vocab 49155)
SHAPES = [(300, 257, 130), (2048, 2048, 49155)]
METRICS = ("device_ms", "host_ms", "single_ms", "library_device_ms", "library_host_ms",
           "library_single_ms")


def worker(root: Path, reps: int, seed: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch

    import repro_torch

    src = Path(repro_torch.__file__).resolve()
    assert src.is_relative_to((root / "src").resolve()), src
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke

    from repro_torch.kernels import _build, sources
    from repro_torch.kernels.pipelined_matmul import ops
    from repro_torch.kernels.pipelined_matmul.ref import matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build([s for s in sources() if s.parent.parent.name == "pipelined_matmul"])
    flush = torch.zeros(smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for M, K, N in SHAPES:
        a32 = torch.randn(M, K, device="cuda", generator=gen)
        b32 = torch.randn(K, N, device="cuda", generator=gen)
        for dt, tdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            a, b = a32.to(tdt), b32.to(tdt)
            before = dict(ops.matmul.routes)
            out = ops.matmul(a, b)
            took = [r for r, n in ops.matmul.routes.items() if n != before.get(r, 0)]
            torch.cuda.synchronize()
            ref = matmul_ref(a, b)
            err = (out.float() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), atol=smoke.TOL[dt] * math.sqrt(K),
                                rtol=smoke.TOL[dt])
            smoke.check(ok, f"{dt} {M}x{K}x{N}: outside the limit (max err {err})")
            del out, ref
            call = lambda: ops.matmul(a, b)  # noqa: E731
            library = lambda: torch.matmul(a, b)  # noqa: E731
            n = reps if M * N * K < 1e9 else max(5, reps // 4)
            held = smoke._held_times(torch, {"route": call, "library": library}, n, flush)
            single, library_single = smoke._time_turns_ms(torch, [call, library], n)
            rows[f"{dt} {M}x{K}x{N}"] = {
                "route": took[0] if len(took) == 1 else took,
                "max_abs_err": err,
                "reps": n,
                "device_ms": held["route"]["device_ms"],
                "host_ms": held["route"]["host_ms"],
                "single_ms": single,
                "library_device_ms": held["library"]["device_ms"],
                "library_host_ms": held["library"]["host_ms"],
                "library_single_ms": library_single,
            }
            del a, b
            torch.cuda.empty_cache()
    return {"tree": str(root), "device": torch.cuda.get_device_name(0), "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--a", type=Path, help="root of tree A (the parent)")
    ap.add_argument("--b", type=Path, help="root of tree B (the change); omit to time A alone")
    ap.add_argument("--pairs", type=int, default=2, help="processes a tree")
    ap.add_argument("--reps", type=int, default=50, help="rounds a shape (a quarter at the LM head)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.reps, args.seed)))
        return 0
    if args.a is None:
        ap.error("--a is required")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    sides = [("a", args.a)] + ([("b", args.b)] if args.b is not None else [])
    order = []
    for i in range(args.pairs):
        order += sides if i % 2 == 0 else sides[::-1]
    got = {name: [] for name, _ in sides}
    for name, root in order:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(root.resolve()),
             "--reps", str(args.reps), "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=900,
        )
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": name, **row}))
        got[name].append(row["rows"])
    summary = {}
    for case in got["a"][0]:
        med = {side: {m: statistics.median(r[case][m] for r in got[side]) for m in METRICS}
               for side in got}
        summary[case] = {"routes": {side: got[side][0][case]["route"] for side in got},
                         **{f"{side}_{m}": med[side][m] for side in med for m in METRICS}}
        if "b" in med:
            summary[case].update({f"b_over_a_{m}": med["b"][m] / med["a"][m]
                                  for m in METRICS[:3]})
    print(json.dumps({"order": [n for n, _ in order], "rows": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
