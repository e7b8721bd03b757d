"""Production mesh construction on ``torch.distributed.device_mesh``, as the
reference's ``launch/mesh.py``.

Defined as FUNCTIONS (never module-level constants) so importing this module
never touches process-group state; only the caller that asks for a mesh
needs a default group (:func:`fake_world` for the device-free dry run).

Mesh geometry, the reference's, so every spec compares one to one:
  * single pod: (16, 16)   axes ("data", "model")    — 256 ranks
  * multi pod:  (2, 16, 16) axes ("pod", "data", "model") — 512 ranks

Data parallelism runs over ("pod", "data") — the pod axis only ever carries
DP gradient reductions, while "model" (tensor/expert parallel) stays on the
fast links.  On H100 hosts of 8 NVLink-connected cards the 16-wide model
axis spans two hosts.

A mesh smaller than the default group takes its first ranks, so one group
of 512 ranks serves both production meshes (the 16×16 mesh holds rank 0).
Every entry point builds its mesh on the card unless the caller passes
``device_type="cpu"``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    n = math.prod(shape)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > n:
        return DeviceMesh(
            device_type, torch.arange(n).view(shape), mesh_dim_names=axes
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small (data, model) mesh over the default group's first ranks."""

    return _mesh((data, model), ("data", "model"), device_type)


def fake_world(world_size: int = 512) -> None:
    """Make this process rank 0 of a ``"fake"`` default group of
    ``world_size`` ranks: collectives return at once and move nothing, so
    a single process lowers a step as one rank of the production mesh.
    A default group already in place is kept if it is big enough."""

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is already "
                f"initialized; the fake world needs {world_size}"
            )
        return
    dist.init_process_group(
        "fake", store=FakeStore(), rank=0, world_size=world_size
    )


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh dimension name: size}."""

    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def data_parallel_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n
