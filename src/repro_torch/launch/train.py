"""Training launcher: the fault-tolerant trainer on synthetic LM data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b --smoke --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b --smoke   # on cuda

The port of ``repro.launch.train``, with its flags plus ``--device``.
``--smoke`` uses the reduced config and a tiny shape (seq 64, batch 4)
without a mesh.  The full path (``--shape``, ``--multi-pod``) trains the
full config on a mesh over the default process group: the one ``torchrun``
describes in the environment, or else a group of this one process.  That is the production
mesh where the ranks fill it, and else the data x model mesh of the ranks
there are (model parallel over up to 16 of them).  Before
it starts it checks that the mesh's devices can hold the step's state and
saved activations, and refuses, naming the bytes, when they cannot (on one
H100, ``train_4k``'s batch of 256 at any full config).  Runs on ``cuda``
unless ``--device cpu`` is given.  Checkpoints go to ``--ckpt-dir``, and a
run resumes from the latest one there; without it they go to a fresh
temporary directory, removed at exit, so every run starts at step 0.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch import config as C
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import make_mesh_config, start_process_group
from repro_torch.models import param_count
from repro_torch.models.layers import torch_dtype
from repro_torch.runtime.trainer import Trainer


def step_bytes(rc: C.RunConfig) -> int:
    """A lower bound on the device bytes of one training step: the params
    and their gradients in the model's dtype, the fp32 master, m and v, and
    every layer's saved input (the "full" remat policy keeps nothing else
    across layers)."""
    cfg = rc.model
    width = torch.tensor([], dtype=torch_dtype(cfg.dtype)).element_size()
    acts = rc.shape.global_batch * rc.shape.seq_len * cfg.d_model * width * cfg.num_layers
    return param_count(cfg) * (2 * width + 12) + acts


def mesh_for(ranks: int, multi_pod: bool) -> C.MeshConfig:
    """The production mesh if ``ranks`` fill it, else a data x model mesh of
    the ranks (model parallel over the largest power of two up to 16 that
    divides them)."""
    prod = C.MULTI_POD_MESH if multi_pod else C.SINGLE_POD_MESH
    if ranks >= prod.num_devices:
        return prod
    model = 16
    while ranks % model:
        model //= 2
    return make_mesh_config(ranks, model_parallel=model)


def check_fits(rc: C.RunConfig, ranks: int, device: torch.device) -> None:
    """Raise ``MemoryError`` naming the bytes when the ranks' devices cannot
    hold :func:`step_bytes` (sharded evenly over the mesh)."""
    n = rc.mesh.num_devices
    need = step_bytes(rc) / n
    if device.type == "cuda":
        have = torch.cuda.get_device_properties(device).total_memory
    else:   # the ranks of one host share its memory
        have = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / ranks
    if need > have:
        raise MemoryError(
            f"{rc.model.name} at batch {rc.shape.global_batch} x {rc.shape.seq_len} needs "
            f"at least {need / 1e9:.1f} GB a device on a {n}-device mesh (params, grads, "
            f"fp32 master, m and v, and each layer's saved input: {step_bytes(rc) / 1e9:.1f} "
            f"GB in all); a {device.type} device holds {have / 1e9:.1f} GB")


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
        ranks = int(os.environ.get("WORLD_SIZE", "1"))
        mesh_cfg = mesh_for(ranks, args.multi_pod)
        use_mesh = True
    started = False
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        train = C.TrainConfig(total_steps=args.steps or 100, checkpoint_dir=ckpt_dir,
                              accum_steps=entry.accum_steps)
        rc = C.RunConfig(model=model, shape=shape, mesh=mesh_cfg, train=train)
        if use_mesh:
            dev = resolve_device(args.device)
            check_fits(rc, ranks, dev)
            started = start_process_group(dev)
        report = Trainer(rc, use_mesh=use_mesh, device=args.device).train()
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()
    print(f"done: steps={report.steps_done} final_loss={report.final_loss:.4f} "
          f"restarts={report.restarts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
