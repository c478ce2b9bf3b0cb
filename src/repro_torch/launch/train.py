"""Training launcher: the fault-tolerant trainer on synthetic LM data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b --smoke --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b --smoke   # on cuda

The port of ``repro.launch.train``, with its flags plus ``--device``.
``--smoke`` uses the reduced config and a tiny shape (seq 64, batch 4)
without a mesh.  The full path (``--shape``, ``--multi-pod``) trains on a
mesh, which waits for the port's distributed layer (ROADMAP A5) and
raises ``NotImplementedError``; so does ``train_4k``'s batch of 256, which no
single card holds.  Runs on ``cuda`` unless ``--device cpu`` is given.
Checkpoints go to ``--ckpt-dir``, and a run resumes from the latest one
there; without it they go to a fresh temporary directory, removed at exit,
so every run starts at step 0.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from typing import Optional, Sequence

from repro_torch import config as C
from repro_torch.runtime.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory to save to and resume from "
                         "(default: a fresh temporary one, removed at exit)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a GPU)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    entry = C.get(args.arch)
    if args.smoke:
        model = entry.smoke
        shape = C.ShapeConfig("smoke_train", 64, 4, "train")
        mesh_cfg = C.SMOKE_MESH
        use_mesh = False
    else:
        model = entry.full
        shape = C.SHAPES_BY_NAME[args.shape]
        mesh_cfg = C.MULTI_POD_MESH if args.multi_pod else C.SINGLE_POD_MESH
        use_mesh = True
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        train = C.TrainConfig(total_steps=args.steps or 100, checkpoint_dir=ckpt_dir,
                              accum_steps=entry.accum_steps)
        rc = C.RunConfig(model=model, shape=shape, mesh=mesh_cfg, train=train)
        report = Trainer(rc, use_mesh=use_mesh, device=args.device).train()
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"done: steps={report.steps_done} final_loss={report.final_loss:.4f} "
          f"restarts={report.restarts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
