"""Hand-written Hopper kernels of the port.

Each kernel package holds its CUDA source under ``csrc/``, a plain PyTorch
version of the same function in ``ref.py`` and the wrapper in ``ops.py``,
which sends a CPU tensor to the plain version and a CUDA tensor to the
kernel (built on first use, see :mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

from pathlib import Path


def sources():
    """Every CUDA source of the port, for a build that starts them all at
    once."""

    return tuple(sorted(Path(__file__).parent.glob("*/csrc/*.cu")))
