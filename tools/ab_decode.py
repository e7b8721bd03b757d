"""A/B timing of the plain (unsharded) decode step of two trees of this repo
on one CUDA card.

Each process imports ``repro_torch`` from one tree's ``src`` and times
yi-6b's greedy decode step at full width (32 layers, bf16, random weights
from a seed): 4 slots against a cache of 2048 filled positions, the shapes
of ``chip_smoke.py``'s phase 7 decode.  Decode is plain PyTorch in both
trees, so nothing is built.  The trees' processes alternate (A B B A A B
...), so that a slow host shows in both; each times its steps one by one
between CUDA syncs after a few warm steps.

    mkdir -p experiments/parent
    git archive <commit> | tar -x -C experiments/parent
    python3 tools/ab_decode.py --a experiments/parent --b .

Prints one JSON line a process, then one summary line: each tree's
per-process median step ms and the ratio of the medians of those (B / A).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARCH = "yi_6b"
SLOTS = 4
FILLED = 2048  # cache positions already written, phase 7's prompt
WARM_STEPS = 4


def worker(root: Path, steps: int, seed: int, device: str, smoke: bool) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch

    import repro_torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model_zoo

    src = Path(repro_torch.__file__).resolve()
    assert src.is_relative_to((root / "src").resolve()), src
    cfg = (get_smoke_config if smoke else get_config)(ARCH)
    params = model_zoo.init(cfg, device=device, seed=seed)
    cache = model_zoo.init_cache(cfg, SLOTS, FILLED + WARM_STEPS + steps, device=device)
    step = make_serve_step(cfg)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    cur = torch.randint(0, cfg.vocab_size, (SLOTS, 1), generator=g, device=device,
                        dtype=torch.int32)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for i in range(WARM_STEPS):
        cur, cache = step(params, cur, cache, FILLED + i)
    ms = []
    for i in range(steps):
        sync()
        t0 = time.perf_counter()
        cur, cache = step(params, cur, cache, FILLED + WARM_STEPS + i)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"tree": str(root), "median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "steps": steps, "tokens": cur[:, 0].tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--a", type=Path, help="root of tree A (the parent)")
    ap.add_argument("--b", type=Path, help="root of tree B (the change)")
    ap.add_argument("--pairs", type=int, default=3, help="processes a tree")
    ap.add_argument("--steps", type=int, default=32, help="timed steps a process")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cpu' for a trial of the script")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (narrow, 2 layers) for a trial")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.steps, args.seed, args.device, args.smoke)))
        return 0
    if args.a is None or args.b is None:
        ap.error("--a and --b are required")
    order = []
    for i in range(args.pairs):
        order += [("a", args.a), ("b", args.b)] if i % 2 == 0 else [("b", args.b), ("a", args.a)]
    got = {"a": [], "b": []}
    tokens = {}
    for name, root in order:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(root.resolve()),
             "--steps", str(args.steps), "--seed", str(args.seed), "--device", args.device]
            + (["--smoke"] if args.smoke else []),
            capture_output=True, text=True, timeout=600,
        )
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": name, **row}))
        got[name].append(row["median_ms"])
        tokens.setdefault(name, row["tokens"])
    print(json.dumps({
        "arch": ARCH, "slots": SLOTS, "filled": FILLED, "order": [n for n, _ in order],
        "a_median_ms": got["a"], "b_median_ms": got["b"],
        "b_over_a": statistics.median(got["b"]) / statistics.median(got["a"]),
        "tokens_equal": tokens["a"] == tokens["b"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
