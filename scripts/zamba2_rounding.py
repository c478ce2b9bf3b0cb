"""How far zamba2-7b's smoke train step moves under rounding alone, on the CPU.

    PYTHONPATH=src python scripts/zamba2_rounding.py [--meshes 2x2 4x1 1x4]

For the fp32 smoke train step (batch 4 x 32, the weights of
``init_train_state`` seed 0, the batch of ``batches_for`` seed 0) it prints
the largest gap, relative to each leaf's largest magnitude, of

* the plain step's gradients against the same step in float64;
* the plain step's gradients when every weight is changed by a relative
  1e-7 (seeded noise): how much the net amplifies a rounding of its inputs;
* on each mesh, the sharded step's new first moments (the clipped
  gradients, scaled) against the plain step's, in fp32 and in float64 (four
  gloo ranks through ``tests/torch_dist_cases.py``'s ``train_family``
  case; float64 through its function mode, which makes every float32 the
  code asks for float64).

A gap of the fp32 size in fp32 and of the float64 size in float64 says the
sharded step computes the plain step's function, rounded differently.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
ARCH = "zamba2-7b"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _gap(got, want):
    """(largest gap relative to its leaf's scale, that leaf)."""
    ref = dict(_leaves(want))
    return max((float((leaf.double() - ref[p].double()).abs().max())
                / max(float(ref[p].abs().max()), 1e-30), p) for p, leaf in _leaves(got))


def _plain():
    from torch_dist_cases import TRAIN, _Float64
    from repro_torch import config as C
    from repro_torch.data.synthetic import batches_for
    from repro_torch.models import build_model
    from repro_torch.optim import tree_map
    from repro_torch.runtime.steps import init_train_state, loss_and_grads
    cfg = dataclasses.replace(C.get(ARCH).smoke, dtype="float32")
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("t", 32, 4, "train"),
                     mesh=C.MeshConfig((1, 1), ("data", "model")), train=C.TrainConfig(**TRAIN))
    model = build_model(cfg, rc.sharding)
    batch = {k: torch.from_numpy(v) for k, v in next(batches_for(cfg, rc.shape, seed=0)).items()}
    params = init_train_state(rc, seed=0, device="cpu").params

    def grads(p):
        g = tree_map(torch.zeros_like, p)
        loss_and_grads(model, p, batch, g)
        return g
    base = grads(params)
    with _Float64():
        wide = grads(tree_map(torch.Tensor.double, params))
    gen = torch.Generator().manual_seed(1)
    nudged = grads(tree_map(lambda t: t * (1 + 1e-7 * torch.randn(t.shape, generator=gen)),
                            params))
    print(f"plain fp32 against float64:            {_gap(base, wide)}")
    print(f"plain fp32, weights changed by 1e-7:   {_gap(nudged, base)}")


def _mesh(shape):
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), arch=np.array(ARCH), mesh=np.array(shape),
                 fp64=np.array(True))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        res = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_dist_cases.py"),
                              "train_family", d], capture_output=True, text=True, env=env,
                             timeout=600)
        if res.returncode:
            raise SystemExit(res.stderr[-3000:])
        got = torch.load(os.path.join(d, "out.pt"), weights_only=False)
    for prec in ("fp32", "fp64"):
        print(f"mesh {shape}, {prec}: sharded first moments against the plain step's: "
              f"{_gap(got[prec]['m'], got[prec]['want_m'])}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--meshes", nargs="*", default=["2x2", "4x1", "1x4"],
                    help="data x model meshes of the four ranks")
    args = ap.parse_args(argv)
    _plain()
    for m in args.meshes:
        _mesh(tuple(int(n) for n in m.split("x")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
