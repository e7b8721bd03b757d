"""Build the port's CUDA sources into shared libraries, on first use.

Each ``csrc/*.cu`` file has a plain C interface.  It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it) and loaded with
:mod:`ctypes`.  Shared headers live in ``kernels/csrc/`` (``-I``).  The
library's file name carries a digest of the source, every header it
includes (``#include "..."``, followed recursively) and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
:func:`build` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # each kernel's registers, shared memory and spills
)

# directories searched for quoted includes, after the including file's own
INCLUDE_DIRS = (Path(__file__).resolve().parent / "csrc",)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

# nvcc's output per source file name, kept for the smoke run to print
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the "
            "port's CUDA kernels are built on first use and need the CUDA "
            "toolkit"
        )
    return str(path)


def headers(src: Path) -> List[Path]:
    """Every header ``src`` includes with quotes, directly or through
    another header, resolved as ``nvcc`` resolves it: beside the including
    file first, then in :data:`INCLUDE_DIRS`.  A name found in neither is a
    system header and is left out."""

    found: List[Path] = []
    todo = [Path(src)]
    while todo:
        cur = todo.pop()
        for name in _INCLUDE.findall(cur.read_text()):
            for d in (cur.parent, *INCLUDE_DIRS):
                path = (d / name).resolve()
                if path.is_file():
                    if path not in found:
                        found.append(path)
                        todo.append(path)
                    break
    return found


def _include_flags() -> List[str]:
    return [flag for d in INCLUDE_DIRS for flag in ("-I", str(d))]


def library_path(src: Path) -> Path:
    h = hashlib.sha1(Path(src).read_bytes())
    # the flags, with each include directory by name only: the digest must
    # not depend on where the checkout lies
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(" ".join(f"-I {d.name}" for d in INCLUDE_DIRS).encode())
    for header in headers(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return build_dir() / f"lib{Path(src).stem}-{h.hexdigest()[:12]}.so"


def build(sources: Iterable[Path]) -> Dict[Path, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; raise with the compiler's output on a failure."""

    sources = [Path(s) for s in sources]
    jobs = []
    try:
        for src in sources:
            out = library_path(src)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, *_include_flags(), "-o", str(tmp),
                 str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            jobs.append((src, out, tmp, proc))
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            BUILD_LOG[src.name] = log
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {src}:\n{log}"
                )
            os.replace(tmp, out)
    finally:
        for _src, _out, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return {src: library_path(src) for src in sources}


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if needed."""

    src = Path(src)
    with _LOCK:
        lib = _LIBS.get(src)
        if lib is None:
            lib = _LIBS[src] = ctypes.CDLL(str(build([src])[src]))
    return lib
