"""The flash_decode part of ``chip_smoke.py``'s phase 6, alone, on one CUDA
card: a quicker run for work on the few-row route than the whole smoke.

Builds the flash_decode sources only, runs the route once at every
``chip_smoke.DECODE_CASES`` row (launches counted: every call on
flash_decode), then ``chip_smoke._decode_rows``: each row against its plain
version, the planted faults, the probes, the device and host times beside
``tma_wgmma`` forced and SDPA, the crossover and the kernel's time split
into its parts.  Prints the smoke's lines for those rows.

    python3 tools/flash_decode_rows.py [--sweep]

``--sweep`` then times the kernel at whisper's decode and prompt cross
shapes (B 4, 16 heads of 64, 1500 keys) for each key-range count the split
rule would pick at 2, 3, 4 and 6 blocks an SM, at each ring depth the
kernel holds (the route runs ``ops.DECODE_DEPTH``), all in the same rounds
(device time alone, L2 flushed): one JSON line a shape.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("flash_decode_rows: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    smoke.emit(smi)

    from repro_torch.kernels import _build, sources
    from repro_torch.kernels.flash_attention import ops

    decode = [s for s in sources() if s.name.startswith("flash_decode")]
    _build.build(decode)
    failed = None
    try:
        smoke.report_build(_build.BUILD_LOG)
    except smoke.SmokeFailure as e:  # reported at the end, after the timings
        failed = e

    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    inputs, outs = {}, {}
    for case in smoke.DECODE_CASES:
        label, B, Sq, Sk, H, KV, hd, causal, window, q_offset = case
        inputs[case] = tuple(
            torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))
        )
    before = ops.flash_attention.routes["flash_decode"]
    for case in smoke.DECODE_CASES:
        q, k, v = inputs[case]
        outs[case] = ops.flash_attention(q, k, v, causal=case[7], window=case[8],
                                         q_offset=case[9])
    torch.cuda.synchronize()
    took = ops.flash_attention.routes["flash_decode"] - before
    smoke.check(took == len(smoke.DECODE_CASES), f"flash_decode: {took} launches")
    smoke._decode_rows(torch, ops, inputs, outs)
    if "--sweep" in sys.argv[1:]:
        sweep(torch, smoke, ops)
    smoke.emit(smi)
    if failed is not None:
        raise failed
    return 0


def _plan(ops, q, k, v, o, splits, depth):
    """A launch plan of the kernel over ``splits`` key ranges at ring depth
    ``depth`` (non-causal, every key live), read from the Hopper K-loop plan
    at that depth like the route's."""

    import ctypes

    from repro_torch.kernels.pipelined_matmul.ops import hopper_schedule

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    chunk = -(-Sk // splits)
    dims = (ctypes.c_longlong * 10)(B, H, KV, Sq, Sk, hd, 0, Sk, chunk, splits)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    n = ctypes.c_int(0)
    rc = ops._decode_entry_point("fa_decode_clusters")(dims, strides, depth, ctypes.byref(n))
    assert rc == 0, rc
    return ops.DecodePlan(dims, strides, splits, hopper_schedule(depth, ops.DECODE_MAX_STAGES),
                          n.value)


def sweep(torch, smoke, ops):
    from repro_torch.kernels.flash_attention.ref import flash_decode_ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.zeros(smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 7)
    B, Sk, H, hd = 4, 1500, 16, 64
    k, v = (torch.randn(B, Sk, H, hd, device="cuda", generator=gen).bfloat16() for _ in range(2))
    for Sq in (1, 4):
        q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen).bfloat16()
        o = torch.empty_like(q)
        fns = {}
        for per_sm in (2, 3, 4, 6):
            splits = ops.decode_splits(B, H, Sk, sms * per_sm // ops.DECODE_BLOCKS_PER_SM)
            chunk = -(-Sk // splits)
            tiles = -(-chunk // ops.DECODE_BK)
            for depth in range(1, min(ops.DECODE_MAX_STAGES, tiles) + 1):
                key = f"ranges {splits} depth {depth}"
                if key in fns:
                    continue
                plan = _plan(ops, q, k, v, o, splits, depth)

                def call(plan=plan):
                    rc = ops._decode_entry_point("fa_decode")(
                        *ops._decode_args(plan, q, k, v, o, False, None, 0))
                    ops._check(rc, ops.FLASH_DECODE, q, k, plan.sched.depth)

                call()
                torch.cuda.synchronize()
                ref = flash_decode_ref(q, k, v, causal=False, splits=splits)
                err = smoke.row_rel_err(o, ref.float())
                smoke.check(err <= smoke.ROW_TOL["bf16"], f"sweep {Sq} {key}: {err}")
                fns[key] = (call, plan.clusters)
        held = smoke._held_times(torch, {n: f for n, (f, _) in fns.items()},
                                 smoke.DECODE_REPS, flush)
        smoke.emit("flash_decode sweep: " + json.dumps({
            "Sq": Sq, "rows": {n: {"device_ms": held[n]["device_ms"],
                                   "clusters_resident": fns[n][1], "clusters": B * H}
                               for n in fns}}))


if __name__ == "__main__":
    sys.exit(main())
