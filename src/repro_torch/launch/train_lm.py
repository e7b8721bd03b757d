"""End-to-end training script, the counterpart of the reference's
``examples/train_lm.py``: data pipeline → train loop → checkpoints → fault
recovery.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --arch yi_6b --steps 60
    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
        --arch granite_3_2b --steps 40 --microbatches 2 --inject-failure 25

It trains the reduced config of ``--arch`` (``--width-mult`` scales its
widths) on ``--device`` (``cuda`` unless the caller asks for ``cpu``).
Checkpoints land in a fresh temporary directory unless ``--ckpt-dir`` names
one, and a run resumes from the newest checkpoint there.
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHITECTURES, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.optimizer import AdamW
from repro_torch.runtime.fault_tolerance import WorkerFailure
from repro_torch.runtime.trainer import TrainResult, train_loop


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi_6b", choices=ARCHITECTURES)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--width-mult", type=int, default=1,
                    help="multiply d_model/d_ff (scale toward ~100M params)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="simulate a worker failure at this step (recovery demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if args.width_mult > 1:
        cfg = cfg.scaled(
            d_model=cfg.d_model * args.width_mult,
            d_ff=cfg.d_ff * args.width_mult,
            head_dim=cfg.head_dim * args.width_mult,
        )
    data_cfg = DataConfig(global_batch=args.batch, seq_len=args.seq, seed=0)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix=f"repro_ckpt_{args.arch}_")
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    opt = AdamW(learning_rate=args.lr, warmup_steps=10, total_steps=args.steps)

    fired = []

    def injector(step):
        if step == args.inject_failure and not fired:
            fired.append(True)
            print(f"!! injecting WorkerFailure at step {step}")
            raise WorkerFailure("w0")

    print(f"training {cfg.name} ({args.steps} steps, ckpt: {ckpt_dir})")
    try:
        res = train_loop(
            cfg,
            data_cfg,
            total_steps=args.steps,
            ckpt=ckpt,
            ckpt_every=args.ckpt_every,
            opt=opt,
            microbatches=args.microbatches,
            failure_injector=injector if args.inject_failure is not None else None,
            device=args.device,
        )
    finally:
        ckpt.close()
    print(
        f"done: step={res.final_step} restarts={res.restarts} "
        f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}"
    )
    for i in range(0, len(res.losses), max(1, len(res.losses) // 10)):
        print(f"  step {i:4d}  loss {res.losses[i]:.4f}")
    return res


if __name__ == "__main__":
    main()
