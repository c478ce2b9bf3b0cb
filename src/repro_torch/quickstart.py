"""Quickstart: train a small LM, then replay the exact training step through
the paper's simulator — functional mode, performance mode, AerialVision-style
phase analysis, and the power breakdown.

    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.quickstart            # on cuda

The port of ``examples/quickstart.py``: the llama3-8b smoke config trained
10 steps by the fault-tolerant trainer (checkpoints in a temporary
directory, removed at exit), its train step captured from abstract inputs
and simulated on the ``h100`` spec.  Runs on ``cuda`` unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from typing import Optional, Sequence

from repro_torch import config as C
from repro_torch.core import Simulator
from repro_torch.core.capture import capture_bundle
from repro_torch.device import resolve_device
from repro_torch.runtime.steps import train_bundle
from repro_torch.runtime.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    entry = C.get("llama3-8b")
    shape = C.ShapeConfig("quickstart", seq_len=64, global_batch=4, kind="train")
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_quickstart_")
    try:
        rc = C.RunConfig(model=entry.smoke, shape=shape, mesh=C.SMOKE_MESH,
                         train=C.TrainConfig(total_steps=10, warmup_steps=2,
                                             checkpoint_every=5, checkpoint_dir=ckpt_dir))

        print("== 1. train 10 steps (functional mode: the real workload) ==")
        report = Trainer(rc, use_mesh=False, device=dev).train()
        print(f"loss: {report.losses[0]:.3f} -> {report.losses[-1]:.3f}  "
              f"checkpoints={report.checkpoints}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    print("== 2. capture the step (the paper's PTX-extraction analogue) ==")
    sim = Simulator()
    cap = capture_bundle(train_bundle(rc), name="quickstart_step", device=dev)
    print(f"HLO: {len(cap.hlo_text) / 1e3:.0f} KB, "
          f"IR ops: {int(cap.module.totals()['ops'])} (trip-count scaled)")

    print(f"== 3. performance-simulate on {sim.hw.name} ==")
    rep = sim.performance(cap)
    print(f"modeled step time: {rep.total_seconds * 1e3:.3f} ms, "
          f"MFU {rep.mfu * 100:.1f}%, HBM util {rep.hbm_utilization * 100:.0f}%")

    print("== 4. AerialVision-style utilization timeline ==")
    vr = sim.vision(rep)
    print(vr.ascii_heatmap())
    print(f"phases: {[(f'{t0 * 1e3:.2f}ms', u) for t0, _, u in vr.phases[:6]]}")

    print("== 5. power breakdown (GPUWattch analogue) ==")
    print(sim.power(rep).table())
    return 0


if __name__ == "__main__":
    sys.exit(main())
