"""Instruction counts of the flash TMA kernels' SASS, on a machine with the
CUDA toolkit: the exp2s (``MUFU.EX2``), the bf16 packs (``F2FP`` to bf16),
the FMAs, max and add instructions and the wgmma instructions of each
kernel instantiation, as ``cuobjdump -sass`` prints them.

Builds ``tma_wgmma_flash.cu`` and ``tma_wgmma_flash_tf32x3.cu`` (as
``chip_smoke.py`` does) and prints one JSON line a kernel instantiation
whose name matches ``--match`` (by default the hd-16 and hd-32 ones).  The
counts are static (instructions in the code, not executed), so a softmax
body unrolled over a key tile of BK keys holds BK / 2 exp2s of scores a
thread and two of corrections, and a P conversion BK / 4 packs of two
scores: ``softmax_bodies`` and ``p_conversions`` are the counts over
those, and ``ex2_per_score`` / ``pack_per_score`` the counts a score of
one body (the bf16 epilogue's hd / 4 packs left out).

    python3 tools/sass_counts.py [--match REGEX]
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

GROUPS = {
    "MUFU.EX2": lambda op: op == "MUFU.EX2",
    "F2FP.BF16": lambda op: op.startswith("F2FP.BF16"),
    "FFMA": lambda op: op == "FFMA" or op.startswith("FFMA."),
    "FMNMX": lambda op: op.startswith("FMNMX"),
    "FADD": lambda op: op == "FADD" or op.startswith("FADD."),
    "FMUL": lambda op: op == "FMUL" or op.startswith("FMUL."),
    "HGMMA": lambda op: op.startswith("HGMMA"),
}
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)")
KERNEL = re.compile(r"flash_(bf16_tma|tf32x3)_kernelILi(\d+)ELi(\d+)ELi(\d+)E")


def counts(lib: Path):
    """Per mangled function of ``lib``: its opcode counts by group."""

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = collections.Counter()
        elif name is not None:
            found = INSTR.search(line)
            if found:
                op = found.group(1)
                for group, test in GROUPS.items():
                    if test(op):
                        out[name][group] += 1
                out[name]["all"] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--match", default=r"ILi(16|32)E", help="regex on the mangled name")
    args = ap.parse_args(argv)

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    built = _build.build([ops.TMA_SOURCE, ops.TF32X3_SOURCE])
    for src, lib in built.items():
        for name, c in counts(lib).items():
            found = KERNEL.search(name)
            if not found or not re.search(args.match, name):
                continue
            kind, hd, bk, stages = found.group(1), *map(int, found.groups()[1:])
            # a softmax body: a thread's BK / 2 scores of a tile and its two
            # rows' corrections; a P conversion: BK / 4 packs of two scores,
            # besides the bf16 epilogue's hd / 4
            bodies = c["MUFU.EX2"] / (bk // 2 + 2)
            epilogue = hd // 4 if kind == "bf16_tma" else 0
            converts = (c["F2FP.BF16"] - epilogue) / (bk // 4)
            print(json.dumps({
                "source": src.name, "kernel": kind, "hd": hd, "bk": bk, "stages": stages,
                **dict(c), "softmax_bodies": bodies, "p_conversions": converts,
                "ex2_per_score": c["MUFU.EX2"] / bodies / (bk // 2) if bodies else None,
                "pack_per_score": (c["F2FP.BF16"] - epilogue) / converts / (bk // 2)
                if converts else None,
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
