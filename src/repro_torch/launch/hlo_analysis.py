"""Collective traffic + roofline terms of a sharded step, as the reference's
``launch/hlo_analysis.py``.

The reference parses the collectives out of XLA's optimized HLO text.
Nothing in torch emits HLO, so the collectives are read where DTensor
issues them: :class:`CollectiveMode` is a
``torch.distributed.tensor.debug.CommDebugMode`` that also records each
collective's local operand and result bytes, and :func:`collective_stats`
maps torch's collectives to the reference's kinds:

  all_reduce              → all-reduce
  all_gather_into_tensor  → all-gather
  reduce_scatter_tensor   → reduce-scatter
  all_to_all_single       → all-to-all
  send / recv             → collective-permute

Per-rank link traffic heuristics per op (ring algorithms, n shards), the
reference's:

  all-reduce        2 × operand bytes   (reduce-scatter + all-gather phases)
  all-gather        output bytes        (each rank receives the full gather)
  reduce-scatter    operand bytes
  all-to-all        operand bytes
  collective-permute  operand bytes

The operand dtypes are the real ones (the reference corrected an XLA:CPU
artifact that turned bf16 collectives into f32 ones), so ``total_bytes`` is
the record.

Hardware constants are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense
rates, 700 W): 989 TFLOP/s bf16, 3.35 TB/s HBM3, and 450 GB/s NVLink 4 per
direction (900 GB/s both ways).  A 16-wide model axis spans two 8-card
NVLink domains, so the collective term at the NVLink rate is a floor, not a
forecast.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.distributed.tensor.debug import CommDebugMode

PEAK_FLOPS = 989e12        # bf16 dense / card (H100 SXM data sheet)
HBM_BW = 3.35e12           # bytes/s / card (HBM3, H100 SXM data sheet)
NVLINK_BW = 450e9          # bytes/s / card / direction (NVLink 4, 18 links)

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# torch op name (without the namespace) → the reference's kind
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


class CollectiveMode(CommDebugMode):
    """``CommDebugMode`` that also keeps (kind, operand bytes, result
    bytes, group name) of every collective it sees, in ``records`` (the
    group name is that of a functional collective's process group, None
    for the others)."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        packet = getattr(func, "_overloadpacket", None)
        kind = _KINDS.get(getattr(packet, "__name__", "").split(".")[-1])
        if kind is not None:
            group = next((a for a in reversed(args) if isinstance(a, str)), None)
            self.records.append((kind, _bytes(args[0]) if args else 0, _bytes(out), group))
        return out


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, int]   # per-rank link traffic heuristic
    total_bytes: int

    def as_dict(self) -> dict:
        return {
            "counts": self.counts,
            "bytes_by_kind": self.bytes_by_kind,
            "total_bytes": self.total_bytes,
        }


def group_names(mesh, axes) -> set:
    """The process-group names of ``mesh``'s dimensions ``axes``, to pick
    one axis' collectives out of :func:`collective_stats`."""

    return {mesh.get_group(a).group_name for a in axes}


def collective_stats(mode, groups=None) -> CollectiveStats:
    """Counts and per-rank traffic by kind from a :class:`CollectiveMode`'s
    records; only those on the process groups named in ``groups`` when
    given (:func:`group_names`)."""

    counts = {k: 0 for k in _COLLECTIVES}
    traffic = {k: 0 for k in _COLLECTIVES}
    for kind, operand_bytes, out_bytes, group in mode.records:
        if groups is not None and group not in groups:
            continue
        counts[kind] += 1
        if kind == "all-reduce":
            moved = 2 * operand_bytes
        elif kind == "all-gather":
            moved = out_bytes
        else:
            moved = operand_bytes
        traffic[kind] += moved
    counts = {k: v for k, v in counts.items() if v}
    traffic = {k: v for k, v in traffic.items() if v}
    return CollectiveStats(
        counts=counts, bytes_by_kind=traffic, total_bytes=sum(traffic.values())
    )


@dataclasses.dataclass
class RooflineTerms:
    """All terms in SECONDS (per step, per card)."""

    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float          # 6·N_active·tokens for the whole step
    useful_flops_fraction: float  # model_flops / (flops_per_chip × chips)
    chips: int

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline estimate: max of the three terms (perfect overlap)."""

        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline estimate."""

        total = self.step_time_s * self.chips * PEAK_FLOPS
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "step_time_s": self.step_time_s,
            "mfu": self.mfu,
            "chips": self.chips,
        }


def roofline(
    *,
    flops_per_chip: float,
    bytes_per_chip: float,
    collective_bytes_per_chip: float,
    model_flops: float,
    chips: int,
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_chip / PEAK_FLOPS,
        memory_s=bytes_per_chip / HBM_BW,
        collective_s=collective_bytes_per_chip / NVLINK_BW,
        flops_per_chip=flops_per_chip,
        bytes_per_chip=bytes_per_chip,
        collective_bytes_per_chip=collective_bytes_per_chip,
        model_flops=model_flops,
        useful_flops_fraction=(
            model_flops / (flops_per_chip * chips)
            if flops_per_chip
            else 0.0
        ),
        chips=chips,
    )
