"""The paper's experiments (sections IV-V) on LeNet, in the port.

    PYTHONPATH=src python -m repro_torch.lenet_repro [--device cuda] [--hw h100] [--trace PATH]

1. train LeNet (full config) with SGD until accuracy rises — the functional
   check the paper's self-checking MNIST app provides — through the
   compiled step (:func:`compiled_step`: a CUDA graph on the card);
2. capture one training step (forward, gradient, update), simulate it, and
   correlate the simulator's time per op class against a reference (Fig.
   6/7; the paper: within 30% overall): on the card, the card's own kernel
   times for the captured program (``card_reference``); with ``--device
   cpu``, the roofline stand-in;
3. the power breakdown (Fig. 8);
4. the four cuDNN-analogue conv algorithms at the case-study shape on the
   device (each held to the direct convolution), then captured and
   simulated: modeled microseconds, the dominant unit, channel camping and
   the phase count (section V);
5. AerialVision-style phase analysis of the training step (section V, Fig.
   4/5): labeled phases, the ASCII timeline, the windowed run against the
   full one, and the dataflow makespan against the serial chain;
6. the memory hierarchy (section V, Figs. 22-25): the live-range HBM
   footprint beside the card's own peak for the step, spills, channel
   imbalance, and the dilation over the flat-clock model.

The port of ``examples/lenet_paper_repro.py``, with the example's own
checks (each raises on failure).  ``--trace PATH`` also writes a
chrome://tracing JSON of the step.  Runs on ``cuda`` unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import config as C
from repro_torch.core import CHIPS, Simulator, card_reference
from repro_torch.core.engine import SimReport
from repro_torch.data.synthetic import synthetic_mnist_batches
from repro_torch.device import resolve_device
from repro_torch.kernels.winograd.ref import conv3x3_ref
from repro_torch.models.conv_algos import CONV_FNS
from repro_torch.models.lenet import LeNet, sgd_step
from repro_torch.runtime.jit import Jitted, jit

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


def compiled_step(model: LeNet) -> Jitted:
    """The paper's training step, compiled with the params donated (the
    counterpart of ``examples/lenet_paper_repro.py``'s ``@jax.jit`` step):
    one CUDA graph on the card, :func:`sgd_step` itself on the CPU."""
    return jit(lambda p, x, y: sgd_step(model, p, x, y, LR), donate=(0,))


def train(model: LeNet, data: Iterator[Tuple[torch.Tensor, torch.Tensor]]
          ) -> Dict[str, Any]:
    """``STEPS`` SGD steps on ``data`` through :func:`compiled_step`, from a
    copy of the model's weights (the step writes its params over the ones
    it is given); returns the final params, loss and accuracy."""
    step = compiled_step(model)
    params = {k: v.clone() for k, v in model.param_dict().items()}
    loss = acc = None
    for i in range(STEPS):
        images, labels = next(data)
        params, loss, acc = step(params, images, labels)
        if i % 15 == 0 or i == STEPS - 1:
            print(f"  step {i:3d} loss={float(loss):.4f} acc={float(acc) * 100:.0f}%")
    return {"params": params, "loss": float(loss), "accuracy": float(acc)}


def conv_case_study(sim: Simulator, device: torch.device,
                    seed: int) -> Dict[str, Dict[str, Any]]:
    """Run, check, capture, simulate and phase-analyze each conv algorithm at
    the case-study shape.  Each output is held to the direct fp32
    convolution."""
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
        a = sim.analysis(r, num_buckets=60)
        dom = max(r.unit_seconds, key=r.unit_seconds.get)
        print(f"  {algo:9s} modeled={r.total_seconds * 1e6:8.1f}us "
              f"dominant={dom:4s} camping={a.channels.imbalance:.2f} "
              f"phases={len(a.phases)} max_abs_err={err:.2e}")
        out[algo] = {"modeled_us": r.total_seconds * 1e6, "dominant": dom,
                     "camping": a.channels.imbalance, "phases": len(a.phases),
                     "max_abs_err": err, "shape": tuple(y.shape)}
    return out


def correlation(sim: Simulator, cap, args, device: torch.device):
    """Section 2: the correlation table against the card's own kernel times
    (on CUDA) or the roofline stand-in (on the CPU).  Returns (report, the
    card's reference or None)."""
    ref = card_reference(cap, *args) if device.type == "cuda" else None
    cr = sim.correlate(cap, ref)
    print("  reference: " + ("the card's device time of each captured node "
                             "(torch.profiler)" if ref is not None
                             else "the roofline stand-in (no card)"))
    print(cr.table())
    print(f"  (paper reports within 30%; we get {cr.overall_discrepancy * 100:.1f}%, "
          f"Pearson r {cr.correlation:.3f} over {len(cr.rows)} op classes)")
    return cr, ref


def step_peak_bytes(model: LeNet, params, images, labels) -> int:
    """The card's peak allocated bytes over one eager training step
    (``torch.cuda.max_memory_allocated``, parameters and batch included)."""
    torch.cuda.synchronize(model.device)
    torch.cuda.reset_peak_memory_stats(model.device)
    sgd_step(model, params, images, labels, LR)
    torch.cuda.synchronize(model.device)
    return torch.cuda.max_memory_allocated(model.device)


def run(device: Optional[str] = None, hw: str = "h100",
        trace: Optional[str] = None) -> Dict[str, Any]:
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

    print(f"== 2. capture, simulate and correlate one training step ({hw}, Fig. 6/7) ==")
    sim = Simulator(hw=CHIPS[hw])
    images, labels = next(data)
    step_args = (trained["params"], images, labels)
    cap = sim.capture(lambda p, x, y: sgd_step(model, p, x, y, LR), *step_args,
                      name="lenet")
    rep = sim.performance(cap)
    print(f"  captured {len(cap.module.comp(cap.module.entry).ops)} ops in "
          f"{cap.capture_seconds:.2f}s")
    for line in summary_lines("lenet", rep):
        print(line)
    cr, ref = correlation(sim, cap, step_args, dev)

    print("== 3. power breakdown (Fig. 8) ==")
    power = sim.power(rep)
    print(power.table())

    print("== 4. conv-algorithm case study (SS V) ==")
    algos = conv_case_study(sim, dev, SEED)

    print("== 5. phase analysis of the training step (SS V, Fig. 4/5) ==")
    ar = sim.analysis(rep, num_buckets=120)
    print(ar.phase_table())
    print(ar.ascii_timeline())
    err = ar.reconcile()
    print(f"  bucket<->summary reconciliation: max rel error {err * 100:.3f}%")
    if not err < 0.01:
        raise RuntimeError(f"bucketed totals diverge from SimReport: {err:.4f}")
    # dataflow-scheduler cross-checks: overlap can only shorten the makespan
    # relative to the serial chain, and the CTA-style windowed run agrees
    # with the full run
    serial_bound = rep.compute_seconds + rep.ici_seconds
    if not rep.total_seconds <= serial_bound + 1e-12:
        raise RuntimeError("dataflow makespan exceeds the serial-chain baseline")
    print("  exposed: " + " ".join(
        f"{u}={t * 1e6:.1f}us" for u, t in sorted(rep.exposed_seconds.items())))
    print("  critical path: " + " ".join(
        f"{u}={t * 1e6:.1f}us" for u, t in sorted(rep.critical_path_seconds.items())))
    win = sim.performance(cap, window=(0, 40))
    for key in ("total_flops", "total_hbm_bytes", "launch_overhead_seconds",
                "total_seconds"):
        full_v, win_v = getattr(rep, key), getattr(win, key)
        if not abs(full_v - win_v) <= 0.01 * max(abs(full_v), 1e-30):
            raise RuntimeError(f"windowed run diverges from full run on {key}")
    print(f"  windowed run (40 detailed ops) matches full totals "
          f"({len(win.timeline)} vs {len(rep.timeline)} timeline entries)")
    distinct = {p.label for p in ar.phases if p.label != "idle"}
    if not (len(ar.phases) >= 2 and distinct):
        raise RuntimeError("phase segmentation found too few phases")
    print(f"  detected {len(ar.phases)} phases "
          f"({len(distinct)} distinct labels: {sorted(distinct)})")

    print("== 6. memory hierarchy (SS V, Figs. 22-25) ==")
    if rep.memory is None or not rep.peak_hbm_bytes > 0:
        raise RuntimeError("the step's report has no memory model")
    print(rep.memory.table(top=4))
    print(f"  spill traffic: {rep.spill_bytes / 2**20:.2f} MiB "
          f"({rep.spill_fraction * 100:.1f}% of HBM bytes), "
          f"channel imbalance {rep.channel_imbalance:.2f}")
    flat = Simulator(hw=CHIPS[hw], memory_model=False).performance(cap)
    dilation = rep.total_seconds / max(flat.total_seconds, 1e-30)
    print(f"  camping dilation vs flat-clock model: {dilation:.3f}x "
          f"(per-channel contention is simulated mechanism, not annotation)")
    if not dilation >= 1.0 - 1e-9:
        raise RuntimeError("the per-channel model must never be faster")
    if not rep.peak_hbm_bytes <= rep.hw.hbm_bytes:
        raise RuntimeError(f"LeNet oversubscribes the {hw} spec's HBM")
    card_peak = step_peak_bytes(model, *step_args) if dev.type == "cuda" else None
    print(f"  modeled peak HBM footprint {rep.peak_hbm_bytes / 2**20:.2f} MiB; the "
          f"card's peak allocated over one step "
          + (f"{card_peak / 2**20:.2f} MiB (torch.cuda.max_memory_allocated, "
             f"parameters and batch included)" if card_peak is not None
             else "not measured (no card)"))
    if trace:
        with open(trace, "w") as f:
            f.write(ar.to_chrome_trace())
        print(f"  wrote chrome://tracing JSON -> {trace}")
    return {"train_seconds": train_s, "loss": trained["loss"],
            "accuracy": trained["accuracy"], "params": trained["params"],
            "model": model, "step_args": step_args, "capture": cap,
            "report": rep, "correlation": cr, "card_reference": ref,
            "power": power, "conv_algos": algos, "analysis": ar,
            "window_report": win, "flat_report": flat,
            "card_peak_bytes": card_peak}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.lenet_repro",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; fails without a GPU)")
    p.add_argument("--hw", default="h100",
                   help=f"simulated chip, one of {sorted(CHIPS)}")
    p.add_argument("--trace", metavar="PATH",
                   help="also write a chrome://tracing JSON of the step here")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    run(device=args.device, hw=args.hw, trace=args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
