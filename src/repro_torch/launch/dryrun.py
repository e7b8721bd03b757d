"""Production-mesh dry run: every (arch × shape × mesh) cell lowered as one
rank of the 256- or 512-rank mesh, the reference's ``launch/dryrun.py``.

Device-free by nature, as the reference's AOT compile on placeholder host
devices is: this process is rank 0 of a ``"fake"`` process group of 512
ranks (collectives return at once and move nothing), and every tensor is a
``FakeTensor`` (shapes, dtypes and strides, no storage), so the configs run
at their full size on any host.  The step is the port's own — params,
optimizer state, batch and cache are DTensors under
:func:`repro_torch.launch.input_specs.cell_shardings`, and the train,
prefill or decode step of :mod:`repro_torch.launch.steps` runs on them —
with three observers on the local shards:

  * ``memory``: ``argument_bytes``, exact from the local shard sizes of
    params, optimizer state, batch and cache; ``temp_peak_bytes``, the peak
    of the step's live tensors (every op output that is not a view, alive
    until Python drops it), and ``peak_bytes`` = argument + temp peak;
  * ``cost``: ``flops_per_chip`` from ``torch.utils.flop_counter``'s
    formulas over the local ops, and ``bytes_per_chip`` as the UNFUSED sum
    of the inputs and outputs of every dispatched local op;
  * ``collectives`` from :mod:`repro_torch.launch.hlo_analysis`;

and the roofline terms at one H100's rates, from those counts and from the
analytic floors (:mod:`repro_torch.launch.analytic`).  Train cells lower
the microbatched step (``--microbatches``, default 8), as the reference's
deployment compile does.

Run as ``python -m repro_torch.launch.dryrun --arch mamba2_2_7b --shape
decode_32k``; records go to ``experiments/dryrun_torch/<arch>__<shape>__
<mesh>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (
    ARCHITECTURES,
    SHAPES,
    cell_is_applicable,
    get_config,
    shape_by_name,
)
from repro_torch.launch import analytic, hlo_analysis, input_specs, sharding, steps
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.optim.optimizer import AdamW

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def _in_shape_propagation() -> bool:
    """Whether DTensor is running an op on global-shape fake tensors to
    learn its output's metadata (under the dry run's fake mode), which is
    no part of the local computation."""

    f = sys._getframe(2)
    while f is not None:
        if "_propagate_tensor_meta" in f.f_code.co_name:
            return True
        f = f.f_back
    return False


_FLOPS = FlopCounterMode(display=False).flop_registry


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for t in x:
            yield from _tensors(t)
    elif isinstance(x, dict):
        for t in x.values():
            yield from _tensors(t)


class LocalCost(TorchDispatchMode):
    """FLOPs, unfused bytes and the live-tensor peak of the local ops (a
    DTensor op is left to DTensor, whose local ops come back here; its
    shape propagation on global fake tensors is skipped).  An op whose
    result aliases an input (a view) moves nothing; an in-place op moves
    its bytes but allocates nothing."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if (
            func.namespace == "aten"
            and func._overloadpacket not in _FLOPS
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"
            )
        ):
            # a composite op (matmul under inference mode) counts as the
            # ops it decomposes into, which come back here
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if not outs or func.namespace == "prim" or _in_shape_propagation():
            return out
        alias = [r.alias_info for r in func._schema.returns]
        if any(a is not None and not a.is_write for a in alias):
            return out
        packet = func._overloadpacket
        if packet in _FLOPS:
            self.flops += int(_FLOPS[packet](*args, **kwargs, out_val=out))
        ins = list(_tensors((args, kwargs)))
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if not any(a is not None for a in alias):
            for t in outs:
                n = t.untyped_storage().nbytes()
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


def _write(record: dict, out_dir: pathlib.Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{record['arch']}__{record['shape']}__{record['mesh']}.json".replace("/", "_")
    (out_dir / fname).write_text(json.dumps(record, indent=2))


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: pathlib.Path,
    microbatches: int = 8,
    kv_quant: bool = False,
) -> dict:
    cfg = get_config(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    shape = shape_by_name(shape_name)
    ok, why = cell_is_applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    record: dict = {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "kv_quant": kv_quant,
    }
    if not ok:
        record["skipped"] = why
        _write(record, out_dir)
        return record

    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_world(512)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh.size()
    opt = AdamW()
    cell = input_specs.cell_shardings(cfg, shape, mesh, opt)
    record["microbatches"] = microbatches if shape.kind == "train" else None

    # the step's arguments: params, then the optimizer state and the batch
    # (train), the batch and the cache (prefill), or the new tokens and
    # the cache (decode)
    arg_bytes = input_specs.argument_bytes(cell["params_abstract"], cell["params"])
    if shape.kind == "train":
        arg_bytes += input_specs.argument_bytes(cell["opt_state_abstract"], cell["opt_state"])
    else:
        arg_bytes += input_specs.argument_bytes(cell["cache_abstract"], cell["cache"])
    if shape.kind == "decode":
        tokens, _, cache_len = input_specs.decode_inputs(cfg, shape)
        tok_sh = sharding.named(mesh, sharding.batch_pspecs(cfg, mesh, {"tokens": tokens}))
        arg_bytes += input_specs.argument_bytes({"tokens": tokens}, tok_sh)
    else:
        arg_bytes += input_specs.argument_bytes(cell["batch_abstract"], cell["batch"])
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = sharding.distribute(cell["params_abstract"], cell["params"])
        batch = sharding.distribute(cell["batch_abstract"], cell["batch"])
        if shape.kind == "train":
            opt_state = sharding.distribute(cell["opt_state_abstract"], cell["opt_state"])
        else:
            cache = sharding.distribute(cell["cache_abstract"], cell["cache"])
        if shape.kind == "decode":
            tokens = sharding.distribute({"tokens": tokens}, tok_sh)["tokens"]
        with hlo_analysis.CollectiveMode() as comm, LocalCost() as cost:
            if shape.kind == "train":
                fn = steps.make_train_step(
                    cfg, opt, microbatches=microbatches, mesh=mesh,
                    grad_shardings=cell["grad_shardings"],
                )
                fn(params, opt_state, batch)
            elif shape.kind == "prefill":
                steps.make_prefill_step(cfg)(params, batch, cache)
            else:  # decode
                steps.make_serve_step(cfg)(params, tokens, cache, cache_len)
    t_lower = time.time() - t0

    mem = {
        "argument_bytes": arg_bytes,
        "temp_peak_bytes": cost.peak,
        "peak_bytes": arg_bytes + cost.peak,
    }
    coll = hlo_analysis.collective_stats(comm)

    abstract = cell["params_abstract"]
    n_active = zoo.active_param_count(abstract, cfg)
    n_params = zoo.param_count(abstract)
    # MODEL_FLOPS: 6·N_active per token (train) or 2·N_active (prefill,
    # decode), over the tokens of the step
    if shape.kind == "decode":
        tokens_per_step = shape.global_batch  # one token per sequence
    else:
        tokens_per_step = shape.global_batch * shape.seq_len
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens_per_step

    terms = hlo_analysis.roofline(
        flops_per_chip=cost.flops,
        bytes_per_chip=cost.bytes,
        collective_bytes_per_chip=coll.total_bytes,
        model_flops=model_flops,
        chips=chips,
    )
    ana = analytic.analytic_record(cfg, shape, n_params, n_active, chips, microbatches)
    ana_terms = hlo_analysis.roofline(
        flops_per_chip=ana["flops_per_chip"],
        bytes_per_chip=ana["bytes_per_chip"],
        collective_bytes_per_chip=coll.total_bytes,
        model_flops=model_flops,
        chips=chips,
    )
    record.update(
        lower_s=round(t_lower, 2),
        chips=chips,
        memory=mem,
        cost={
            "flops_per_chip": cost.flops,
            "bytes_per_chip": cost.bytes,
            "bytes_note": "unfused: the inputs and outputs of every dispatched local op",
        },
        collectives=coll.as_dict(),
        n_active_params=n_active,
        n_total_params=n_params,
        tokens_per_step=tokens_per_step,
        roofline=terms.as_dict(),
        analytic=ana,
        roofline_analytic=ana_terms.as_dict(),
        hardware={
            "peak_flops": hlo_analysis.PEAK_FLOPS,
            "hbm_bytes_per_s": hlo_analysis.HBM_BW,
            "nvlink_bytes_per_s": hlo_analysis.NVLINK_BW,
        },
    )
    _write(record, out_dir)
    tag = f"[{cfg.name} × {shape_name} × {mesh_name}]"
    print(f"{tag} memory: {mem}")
    print(f"{tag} collectives: {coll.counts} ({coll.total_bytes} bytes)")
    print(
        f"{tag} roofline(counted): compute={terms.compute_s:.4f}s "
        f"memory={terms.memory_s:.4f}s collective={terms.collective_s:.4f}s "
        f"dominant={terms.dominant} (lowered in {t_lower:.1f}s)"
    )
    print(
        f"{tag} roofline(analytic): compute={ana_terms.compute_s:.4f}s "
        f"memory={ana_terms.memory_s:.4f}s collective={ana_terms.collective_s:.4f}s "
        f"dominant={ana_terms.dominant}"
    )
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="architecture id (or 'all')")
    ap.add_argument("--shape", default=None, help="shape name (or 'all')")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (optimized serving variant)")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    archs = ARCHITECTURES if args.arch in (None, "all") else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape in (None, "all") else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape_name, mp, out_dir, args.microbatches, args.kv_quant)
                except Exception:
                    failures.append((arch, shape_name, mp))
                    traceback.print_exc()
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run: all requested cells lowered")


if __name__ == "__main__":
    main()
