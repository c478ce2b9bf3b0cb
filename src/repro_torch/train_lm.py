"""End-to-end training driver on a ~100M-param llama-style model:
config -> state -> fault-tolerant loop -> checkpoints, with a mid-run
failure injection to demonstrate the elastic restart.

    PYTHONPATH=src python -m repro_torch.train_lm --device cpu --steps 12 [--fail-at 5]
    PYTHONPATH=src python -m repro_torch.train_lm --steps 12      # on cuda

The port of ``examples/train_lm.py``, with its flags plus ``--device``.
Defaults are sized for a CPU container (tiny batch, --steps 12).  The
checkpoints go to ``--ckpt-dir`` (emptied first), by default a fresh
temporary directory removed at exit.  Runs on ``cuda`` unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from typing import Optional, Sequence

from repro_torch import config as C
from repro_torch.runtime.failure import FailurePlan
from repro_torch.runtime.trainer import Trainer

MODEL_100M = C.ModelConfig(
    name="llama-100m", family="dense", num_layers=8, d_model=512,
    num_heads=8, num_kv_heads=4, head_dim=64, d_ff=1536, vocab_size=8192,
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train_lm",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a node failure at this step")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, emptied first (default: a fresh "
                         "temporary one, removed at exit)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a GPU)")
    args = ap.parse_args(argv)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    shutil.rmtree(ckpt_dir, ignore_errors=True)   # fresh demo run
    try:
        shape = C.ShapeConfig("train_demo", args.seq, args.batch, "train")
        rc = C.RunConfig(
            model=MODEL_100M, shape=shape, mesh=C.SMOKE_MESH,
            train=C.TrainConfig(total_steps=args.steps, warmup_steps=2,
                                learning_rate=3e-4, checkpoint_every=4,
                                checkpoint_dir=ckpt_dir))
        plan = FailurePlan()
        if args.fail_at >= 0:
            plan.failures[args.fail_at] = 0
        report = Trainer(rc, use_mesh=False, failure_plan=plan, device=args.device).train()
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    n = max(len(report.losses) // 6, 1)
    print("loss curve:", [round(loss, 3) for loss in report.losses[::n]])
    print(f"steps={report.steps_done} restarts={report.restarts} "
          f"checkpoints={report.checkpoints} final={report.final_loss:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
