"""Pipeline-parallel step on ``torch.distributed``, the counterpart of the
reference's ``runtime/pp_lowering.py``.

Each rank of the default process group is one stage.  The retained events
of :func:`repro_torch.core.schedule.plan_pipeline_sync` become one
point-to-point hand-off per microbatch step, rank s to rank (s+1) % S, as
the reference's one ``ppermute`` over the mesh axis; the eliminated events
(skip and fan-out edges) ride the same payload.  So a step costs ONE
``batch_isend_irecv`` pair per rank per microbatch however many skips the
stage graph has, counted in ``pp.handoffs`` (:mod:`repro_torch.obs.metrics`).

The schedule is the reference's toy one: stage s consumes at step m what
stage s-1 produced at step m-1, so stage S-1's accumulator holds
microbatch m-(S-1)'s output at row m and zeros in its first S-1 rows.  The
reference returns device 0's accumulator (``out_specs=P()``), which is all
zeros for S > 1; each rank here returns its own.

``main`` is the reference's check on the production mesh: the stages are
the 16 ranks of its "model" dimension (this process is rank 0 of a
``"fake"`` group of 512, so the hand-offs move nothing), and the count is
read from ``pp.handoffs`` where the reference counts collective-permutes
in the compiled HLO.  Run as ``python -m repro_torch.runtime.pp_lowering``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.compile.lowering import resolve_device
from repro_torch.core.schedule import StageGraph, plan_pipeline_sync
from repro_torch.obs import metrics

HANDOFFS = "pp.handoffs"


def _stage_group(dev: torch.device, group=None) -> Tuple[int, int]:
    """(rank, size) in ``group`` (the default group when None), whose
    backend must move tensors of ``dev``: gloo CPU ones, NCCL CUDA ones (a
    ``"fake"`` group moves nothing and takes either)."""

    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "build_pipeline_step needs a process group: one rank per stage "
            "(torch.distributed.init_process_group)"
        )
    backend = str(dist.get_backend(group)).lower()
    reaches = {"cuda": ("nccl", "fake"), "cpu": ("gloo", "mpi", "fake")}[dev.type]
    if not any(b in backend for b in reaches):
        raise ValueError(
            f"pipeline step: the process group's backend {backend!r} cannot "
            f"move tensors on {dev}; use an NCCL group for 'cuda' and a gloo "
            "group for 'cpu'"
        )
    return dist.get_rank(group), dist.get_world_size(group)


def build_pipeline_step(
    num_microbatches: int,
    d_model: int,
    skips: Tuple[Tuple[int, int], ...] = (),
    *,
    device="cuda",
    group=None,
):
    """A pipeline step in which this rank is one stage of ``group`` (the
    default group when None; e.g. a mesh dimension's group).

    Stage s applies its own weight matrix; the payload carries both the
    chain activation AND the skip values the transitive reduction proved
    can piggyback (one ``(B, d)`` slab per skip edge).  Returns
    ``(step_fn, plan)``: ``step_fn(w, xs) -> outputs`` with ``w`` this
    stage's ``(d_model, d_model)`` weights and ``xs`` the ``(M, B,
    d_model)`` inputs every rank holds, both on ``device``; the outputs are
    this rank's ``(M, B, d_model)`` accumulator.
    """

    import torch.distributed as dist

    dev = resolve_device(device)
    rank, S = _stage_group(dev, group)
    peer = (lambda r: r) if group is None else (lambda r: dist.get_global_rank(group, r))
    plan = plan_pipeline_sync(
        StageGraph(num_stages=S, num_microbatches=num_microbatches, skips=skips)
    )
    n_skip = len(skips)
    handoffs = metrics.counter(HANDOFFS)

    def stage_step(w, x, skip_vals):
        """One stage's compute: consume chain input + its skip inputs."""
        extra = torch.zeros_like(x)
        for j, (src, dst) in enumerate(skips):
            if rank == dst:
                extra = extra + skip_vals[j]
        y = torch.tanh((x + extra) @ w)
        new_skips = [y if rank == src else skip_vals[j] for j, (src, _) in enumerate(skips)]
        return y, torch.stack(new_skips) if new_skips else skip_vals

    def step(w: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        if w.shape != (d_model, d_model) or xs.dim() != 3 or xs.shape[2] != d_model:
            raise ValueError(
                f"pipeline step: w {tuple(w.shape)} and xs {tuple(xs.shape)}; "
                f"expected ({d_model}, {d_model}) and (M, B, {d_model})"
            )
        if xs.shape[0] != num_microbatches:
            raise ValueError(
                f"pipeline step: {xs.shape[0]} microbatches, planned for "
                f"{num_microbatches}"
            )
        for name, t in (("w", w), ("xs", xs)):
            if resolve_device(t.device) != dev:
                raise ValueError(f"pipeline step: {name} is on {t.device}, the step on {dev}")
        M, B = xs.shape[0], xs.shape[1]
        x_in = torch.zeros((B, d_model), dtype=xs.dtype, device=dev)
        skip_in = torch.zeros((n_skip, B, d_model), dtype=xs.dtype, device=dev)
        outs = torch.zeros((M, B, d_model), dtype=xs.dtype, device=dev)
        for m in range(M):
            # stage 0 injects microbatch m; others consume the moved input
            x = xs[m] if rank == 0 else x_in
            y, skip_out = stage_step(w, x, skip_in)
            # ONE hand-off moves the chain value AND the piggybacked skips —
            # the eliminated dependences cost no extra transfer
            payload = torch.cat([y[None], skip_out]).contiguous()
            if S > 1:
                moved = torch.empty_like(payload)
                for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, payload, peer((rank + 1) % S), group),
                    dist.P2POp(dist.irecv, moved, peer((rank - 1) % S), group),
                ]):
                    req.wait()
                handoffs.inc()
            else:
                moved = payload
            x_in, skip_in = moved[0], moved[1:]
            if rank == S - 1:
                outs[m] = y
        return outs

    return step, plan


def main() -> None:
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    fake_world(512)
    mesh = make_production_mesh(device_type="cpu")
    S = mesh.size(mesh.mesh_dim_names.index("model"))
    skips = tuple((0, d) for d in range(2, 8))  # 6 fan-out edges
    M, B, d = 4, 8, 128
    step, plan = build_pipeline_step(
        M, d, skips, device="cpu", group=mesh.get_group("model")
    )
    handoffs = metrics.counter(HANDOFFS)
    before = handoffs.value
    step(torch.zeros((d, d)), torch.zeros((M, B, d)))
    per_step = (handoffs.value - before) / M
    print("sync plan:", plan.summary())
    naive = (S - 1) + len(skips)
    print(
        f"hand-offs per microbatch step: {per_step:g} on {S} stages "
        f"(naive one-per-dependence schedule: {naive})"
    )
    assert per_step <= 2, "piggybacked schedule must hand off O(1) times a step"
    print("pp lowering: OK")


if __name__ == "__main__":
    main()
