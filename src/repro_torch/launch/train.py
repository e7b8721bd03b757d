"""Training entry point, the counterpart of the reference's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4

On the card (``--device cuda``, the default) it trains the full published
config; with ``--device cpu`` ``--smoke`` (the default there) selects the
reduced config, as the reference selects it when no accelerator is present.

Composes the deterministic data pipeline, AdamW + schedule, microbatched
gradient accumulation, optional error-feedback int8 gradient compression,
async checkpointing and heartbeat/straggler/elastic fault handling.
"""

from __future__ import annotations

import argparse

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.compile.lowering import resolve_device
from repro_torch.configs import ARCHITECTURES, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.compression import Int8Compressor
from repro_torch.optim.optimizer import AdamW
from repro_torch.runtime.trainer import TrainResult, train_loop


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi_6b", choices=ARCHITECTURES)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", default=None,
                    help="reduced config (default with --device cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    smoke = (dev.type == "cpu") if args.smoke is None else args.smoke
    cfg = get_smoke_config(args.arch) if smoke else get_config(args.arch)
    print(f"config: {cfg.name} (smoke={smoke}, device={dev})")

    data_cfg = DataConfig(
        global_batch=args.global_batch, seq_len=args.seq, seed=args.seed
    )
    opt = AdamW(
        learning_rate=args.lr, warmup_steps=args.warmup, total_steps=args.steps
    )
    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None

    hook = None
    if args.compress_grads:
        comp = Int8Compressor()
        state = {"res": None}

        def hook(grads, opt_state):  # noqa: F811
            if state["res"] is None:
                state["res"] = comp.init(grads)
            out, state["res"] = comp.apply(grads, state["res"])
            return out, opt_state

    try:
        res = train_loop(
            cfg,
            data_cfg,
            total_steps=args.steps,
            ckpt=ckpt,
            ckpt_every=args.ckpt_every,
            opt=opt,
            microbatches=args.microbatches,
            seed=args.seed,
            grad_compressor=hook,
            device=dev,
        )
    finally:
        if ckpt:
            ckpt.close()
    print(
        f"finished: step={res.final_step} restarts={res.restarts} "
        f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}"
    )
    return res


if __name__ == "__main__":
    main()
