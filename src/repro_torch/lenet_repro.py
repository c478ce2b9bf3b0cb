"""The paper's pipeline on LeNet, in the port: train, capture, simulate, and
the section V conv-algorithm case study.

    PYTHONPATH=src python -m repro_torch.lenet_repro [--device cuda] [--hw h100]

1. train LeNet (full config) with SGD until accuracy rises — the functional
   check the paper's self-checking MNIST app provides;
2. capture one training step (forward, gradient, update) and simulate it;
3. print the ``SimReport`` summary line, formatted as
   ``python -m repro.analysis`` prints it;
4. run the four cuDNN-analogue conv algorithms at the case-study shape on
   the device (each held to the direct convolution), then capture and
   simulate each: modeled microseconds and the dominant unit.

The port of ``examples/lenet_paper_repro.py`` sections 1 and 4 plus the
summary of ``repro.analysis.__main__``.  Runs on ``cuda`` unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import config as C
from repro_torch.core import CHIPS, Simulator
from repro_torch.core.engine import SimReport
from repro_torch.data.synthetic import synthetic_mnist_batches
from repro_torch.device import resolve_device
from repro_torch.kernels.winograd.ref import conv3x3_ref
from repro_torch.models.conv_algos import CONV_FNS
from repro_torch.models.lenet import LeNet, sgd_step

#: the section V case study: x (64, 28, 28, 16) conv w (3, 3, 16, 32), SAME
CASE_X = (64, 28, 28, 16)
CASE_W = (3, 3, 16, 32)

#: the training run of ``examples/lenet_paper_repro.py``
STEPS, BATCH, LR, CONV_ALGO, SEED = 60, 128, 0.05, "gemm", 0


def summary_lines(arch: str, rep: SimReport) -> List[str]:
    """The summary as ``python -m repro.analysis`` prints it."""
    s = rep.summary()
    lines = [f"== {arch}: modeled step {s['total_seconds'] * 1e3:.3f} ms, "
             f"MFU {s['mfu'] * 100:.1f}%, HBM util "
             f"{s['hbm_utilization'] * 100:.1f}%, launch overhead "
             f"{s['launch_overhead_seconds'] * 1e6:.1f} us =="]
    if rep.memory is not None:
        lines.append(f"   memory: peak {s['peak_hbm_bytes'] / 2**20:.1f} MiB "
                     f"({s['peak_hbm_fraction'] * 100:.1f}% of HBM), spill "
                     f"{s['spill_bytes'] / 2**20:.1f} MiB "
                     f"({s['spill_fraction'] * 100:.1f}% of traffic), channel "
                     f"imbalance {s['channel_imbalance']:.2f}")
    return lines


def new_model(device: Optional[Union[str, torch.device]] = None) -> LeNet:
    """LeNet at the full config with the run's conv algorithm and seed."""
    return LeNet(C.get("lenet").full, conv_algo=CONV_ALGO, device=device,
                 seed=SEED)


def device_batches(model: LeNet, seed: int = SEED
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Synthetic MNIST batches of ``BATCH`` (images, labels) on the model's
    device."""
    for b in synthetic_mnist_batches(model.cfg, batch=BATCH, seed=seed):
        yield (torch.from_numpy(b["images"]).to(model.device),
               torch.from_numpy(b["labels"]).long().to(model.device))


def train(model: LeNet, data: Iterator[Tuple[torch.Tensor, torch.Tensor]]
          ) -> Dict[str, Any]:
    """``STEPS`` SGD steps on ``data``; returns the final params, loss and
    accuracy."""
    params = model.param_dict()
    loss = acc = None
    for i in range(STEPS):
        images, labels = next(data)
        params, loss, acc = sgd_step(model, params, images, labels, LR)
        if i % 15 == 0 or i == STEPS - 1:
            print(f"  step {i:3d} loss={float(loss):.4f} acc={float(acc) * 100:.0f}%")
    return {"params": params, "loss": float(loss), "accuracy": float(acc)}


def conv_case_study(sim: Simulator, device: torch.device,
                    seed: int) -> Dict[str, Dict[str, Any]]:
    """Run, check, capture and simulate each conv algorithm at the case-study
    shape.  Each output is held to the direct fp32 convolution."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(CASE_X, generator=gen).to(device)
    w = torch.randn(CASE_W, generator=gen).to(device)
    ref = conv3x3_ref(x, w, "SAME")
    out: Dict[str, Dict[str, Any]] = {}
    for algo, fn in CONV_FNS.items():
        y = fn(x, w, "SAME")
        err = float((y - ref).abs().max())
        cap = sim.capture(functools.partial(fn, padding="SAME"), x, w,
                          name=algo)
        r = sim.performance(cap)
        dom = max(r.unit_seconds, key=r.unit_seconds.get)
        print(f"  {algo:9s} modeled={r.total_seconds * 1e6:8.1f}us "
            f"dominant={dom:4s} max_abs_err={err:.2e}")
        out[algo] = {"modeled_us": r.total_seconds * 1e6, "dominant": dom,
                     "max_abs_err": err, "shape": tuple(y.shape)}
    return out


def run(device: Optional[str] = None, hw: str = "h100") -> Dict[str, Any]:
    """The whole pipeline; returns what each stage produced."""
    dev = resolve_device(device)
    if hw not in CHIPS:
        raise KeyError(f"unknown hw {hw!r}; known: {sorted(CHIPS)}")
    if dev.type == "cuda":
        # the port's fp32 is full fp32: no TF32 in library convolutions
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = new_model(dev)
    data = device_batches(model)

    print(f"== 1. train LeNet ({CONV_ALGO}, batch {BATCH}, {STEPS} steps, "
        f"on {dev}) ==")
    t0 = time.perf_counter()
    trained = train(model, data)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    if not trained["accuracy"] > 0.6:
        raise RuntimeError(f"LeNet failed to learn: accuracy "
                           f"{trained['accuracy']:.3f} after {STEPS} steps")

    print(f"== 2. capture + simulate one training step ({hw}) ==")
    sim = Simulator(hw=CHIPS[hw])
    images, labels = next(data)
    cap = sim.capture(lambda p, x, y: sgd_step(model, p, x, y, LR),
                      trained["params"], images, labels, name="lenet")
    rep = sim.performance(cap)
    print(f"  captured {len(cap.module.comp(cap.module.entry).ops)} ops in "
        f"{cap.capture_seconds:.2f}s")

    print("== 3. summary ==")
    for line in summary_lines("lenet", rep):
        print(line)

    print("== 4. conv-algorithm case study (SS V) ==")
    algos = conv_case_study(sim, dev, SEED)
    return {"train_seconds": train_s, "loss": trained["loss"],
            "accuracy": trained["accuracy"], "report": rep,
            "conv_algos": algos}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.lenet_repro",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without a GPU)")
    p.add_argument("--hw", default="h100",
                   help=f"simulated chip, one of {sorted(CHIPS)}")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    run(device=args.device, hw=args.hw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
