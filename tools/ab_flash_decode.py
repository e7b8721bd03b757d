"""A/B timing of the flash routes of two trees of this repo on one CUDA
card, at one of two sets of rows (``--rows``).

``decode`` (the default): the few-row route (``flash_decode``) through the
public ``flash_attention`` at ``chip_smoke.py``'s ``DECODE_CASES`` rows and
whisper's prompt self attention (4 x 4, causal).  At each row, on inputs
drawn from a seed (the same in both trees): the output against the plain
f32 attention (``chip_smoke.ROW_TOL``), then in the same rounds as SDPA
the device time alone (L2 flushed) and the host's enqueue time
(``chip_smoke._held_times``), the single-launch time
(``chip_smoke._time_turns_ms``) and each kernel's span under the profiler
(the kernels one call launches, and the gaps between them:
``chip_smoke._kernel_spans``).

``small_hd``: the calls at hd 16 and 32 (``chip_smoke.FLASH_CASES`` below
hd 64: the unaligned 193 / 201 shape, all-MiniLM-L6-v2's attention and
the hd-16 prefill), in bf16 and f32, on whatever route the tree's rule
gives them.  At each row: the route taken, the output against the plain
f32 attention, then in the same rounds the route's call, SDPA, the hd-64
route on q, k and v zero-padded to 64 (``chip_smoke.padded_64``; the pad
and the slice back are in its time): device time alone, host enqueue and
single launch, as above.

The trees' processes alternate (A B B A ...), so that a slow host shows in
both.

    mkdir -p experiments/parent
    git archive <commit> | tar -x -C experiments/parent
    python3 tools/ab_flash_decode.py --a experiments/parent --b . [--rows small_hd]

Without ``--b`` it times tree A alone, in ``--pairs`` processes.  Prints
the card's name and power limit, one JSON line a process, then one summary
line: each tree's per-process medians at each row and, with two trees, the
ratio of their medians (B / A).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# whisper's decoder prompt self attention: B 4, 4 x 4, 16 heads of 64, causal
PROMPT_SELF = ("whisper prompt self", 4, 4, 4, 16, 16, 64, True, None, 0)
SPAN_REPS = 20
METRICS = {
    "decode": ("device_ms", "host_ms", "single_ms", "library_device_ms", "library_host_ms",
               "library_single_ms"),
    "small_hd": tuple(f"{call}_{m}" for call in ("route", "sdpa", "padded_64")
                      for m in ("device_ms", "host_ms", "single_ms")),
}


def _import(root: Path):
    """torch, ``repro_torch`` from ``root``'s ``src`` and this tree's
    ``chip_smoke`` (its helpers and case lists)."""

    sys.path.insert(0, str(root / "src"))
    import torch

    import repro_torch

    src = Path(repro_torch.__file__).resolve()
    assert src.is_relative_to((root / "src").resolve()), src
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke

    return torch, smoke


def decode_worker(root: Path, reps: int, seed: int) -> dict:
    torch, smoke = _import(root)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, sources
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref

    _build.build([s for s in sources() if s.name.startswith("flash_decode")])
    flush = torch.zeros(smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for case in [*smoke.DECODE_CASES, PROMPT_SELF]:
        label, B, Sq, Sk, H, KV, hd, causal, window, q_offset = case
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                   for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        before = ops.flash_attention.routes["flash_decode"]
        out = ops.flash_attention(q, k, v, **kw)
        smoke.check(ops.flash_attention.routes["flash_decode"] == before + 1,
                    f"{label}: not on flash_decode")
        ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), **kw)
        err = smoke.row_rel_err(out, ref)
        smoke.check(err <= smoke.ROW_TOL["bf16"], f"{label} {Sq}x{Sk}: row error {err}")
        call = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
        library = smoke._sdpa_at(torch, q, k, v, causal, window, q_offset)
        held = smoke._held_times(torch, {"route": call, "library": library}, reps, flush)
        single, library_single = smoke._time_turns_ms(torch, [call, library], reps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = tuple(next(n for n in ("combine_kernel", "flash_decode_kernel") if n in e.name)
                      for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        rows[f"{label} {Sq}x{Sk}"] = {
            "route": "flash_decode",
            "max_row_rel_err": err,
            "kernels": names,
            "device_ms": held["route"]["device_ms"],
            "host_ms": held["route"]["host_ms"],
            "single_ms": single,
            "library_device_ms": held["library"]["device_ms"],
            "library_host_ms": held["library"]["host_ms"],
            "library_single_ms": library_single,
            "spans": smoke._kernel_spans(torch, call, flush, SPAN_REPS, names),
        }
    return {"tree": str(root), "device": torch.cuda.get_device_name(0), "reps": reps,
            "rows": rows}


def small_hd_worker(root: Path, reps: int, seed: int) -> dict:
    torch, smoke = _import(root)
    from repro_torch.kernels import _build, sources
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref

    _build.build([s for s in sources() if s.parent.parent.name == "flash_attention"])
    flush = torch.zeros(smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    rows = {}
    for label, B, Sq, Sk, H, KV, hd, causal, window, dt in smoke.FLASH_CASES:
        if hd >= 64:
            continue
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtypes[dt])
                   for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
        kw = dict(causal=causal, window=window)
        call = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
        padded = lambda: smoke.padded_64(ops, q, k, v, **kw)  # noqa: E731
        fns = {"route": call, "sdpa": lambda: smoke._sdpa(torch, q, k, v, causal, window),
               "padded_64": padded}
        before = dict(ops.flash_attention.routes)
        outs = {"route": call()}
        took = [r for r, n in ops.flash_attention.routes.items() if n != before[r]]
        outs["padded_64"] = padded()
        ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), **kw)
        errs = {name: smoke.row_rel_err(out, ref) for name, out in outs.items()}
        del outs, ref
        for name, e in errs.items():
            smoke.check(e <= smoke.ROW_TOL[dt], f"{label} {dt} ({name}): row error {e}")
        held = smoke._held_times(torch, fns, reps, flush)
        single = dict(zip(fns, smoke._time_turns_ms(torch, list(fns.values()), reps)))
        bound_ms, bound_by, _ = smoke.flash_bound(B, Sq, Sk, H, KV, hd, causal, window, dt,
                                                  q.element_size(), took[0])
        rows[f"{label}, {dt}"] = {
            "route": took[0] if len(took) == 1 else took,
            **{f"{name}_max_row_rel_err": e for name, e in errs.items()},
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            **{f"{n}_{m}": held[n][m] for n in fns for m in ("device_ms", "host_ms")},
            **{f"{n}_single_ms": single[n] for n in fns},
        }
        del q, k, v
        torch.cuda.empty_cache()
    return {"tree": str(root), "device": torch.cuda.get_device_name(0), "reps": reps,
            "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--a", type=Path, help="root of tree A (the parent)")
    ap.add_argument("--b", type=Path, help="root of tree B (the change); omit to time A alone")
    ap.add_argument("--rows", choices=("decode", "small_hd"), default="decode")
    ap.add_argument("--pairs", type=int, default=2, help="processes a tree")
    ap.add_argument("--reps", type=int, default=50, help="rounds a row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        work = decode_worker if args.rows == "decode" else small_hd_worker
        print(json.dumps(work(args.worker, args.reps, args.seed)))
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
             "--rows", args.rows, "--reps", str(args.reps), "--seed", str(args.seed)],
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
        metrics = METRICS[args.rows]
        med = {side: {m: statistics.median(r[case][m] for r in got[side]) for m in metrics}
               for side in got}
        summary[case] = {"routes": {side: got[side][0][case]["route"] for side in got},
                         **{f"{side}_{m}": med[side][m] for side in med for m in metrics}}
        if "b" in med:
            summary[case].update({f"b_over_a_{m}": med["b"][m] / med["a"][m] for m in metrics})
    print(json.dumps({"order": [n for n, _ in order], "rows": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
