"""CLI: phase-analyze a ported architecture's training step.

    PYTHONPATH=src python -m repro_torch.analysis <arch> [options]

Examples::

    python -m repro_torch.analysis lenet                 # on the card
    python -m repro_torch.analysis lenet --device cpu --json -
    python -m repro_torch.analysis lenet --full --hw h100 --chrome-trace /tmp/lenet.json
    python -m repro_torch.analysis qwen1.5-4b --seq-len 128 --batch 4 --device cpu

The port of ``python -m repro.analysis``: captures the architecture's train
step (smoke config by default) from example tensors on ``--device`` (cuda
unless ``--device cpu`` is given; nothing runs on them), performance-
simulates it, and prints the phase table, the ASCII timeline and the
HBM-channel report; optionally dumps chrome://tracing / JSON artifacts.
LeNet's step is ``models/lenet.py::sgd_step``; a decoder LM's is
``runtime/steps.py::train_bundle`` at ``--seq-len`` x ``--batch``, captured
from abstract inputs (``core/capture.py::capture_bundle``), so ``--full``
allocates no weights.  ``--timelapse``, ``--manifest``, ``--doctor`` and
``--spans`` write the AerialVision time-lapse, a run manifest (compare two
with ``python -m repro_torch.obs diff A B``), the doctor's ranked findings
and the simulator's own spans; each composes into ``--chrome-trace``.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AerialVision-style phase analysis of a simulated "
                    "training step (paper §V).")
    p.add_argument("arch", help="registered architecture id, e.g. 'lenet' "
                                "(see repro_torch.configs)")
    p.add_argument("--full", action="store_true",
                   help="use the full-size config instead of the smoke config")
    p.add_argument("--seq-len", type=int, default=64,
                   help="sequence length of a decoder LM's train step")
    p.add_argument("--batch", type=int, default=4, help="global batch size")
    p.add_argument("--buckets", type=int, default=120,
                   help="number of time buckets (default 120)")
    p.add_argument("--hw", default="h100", help="chip spec (h100|tpu-v5e|tpu-v5p)")
    p.add_argument("--device", default=None,
                   help="torch device of the example tensors (default: cuda; "
                        "fails without a GPU)")
    p.add_argument("--no-overlap", action="store_true",
                   help="serialize collectives instead of overlapping")
    p.add_argument("--no-memory", action="store_true",
                   help="disable the repro_torch.memory hierarchy (flat HBM "
                        "clock, no placements/spills) — the legacy model")
    p.add_argument("--topology", metavar="SPEC",
                   help="override the chip's ICI fabric spec "
                        "(ring | ring:N | torus:AxB[xC] | fc[:N])")
    p.add_argument("--no-topology", action="store_true",
                   help="disable the repro_torch.topology fabric (flat "
                        "analytic ICI clock, no per-link contention)")
    p.add_argument("--legacy-scheduler", action="store_true",
                   help="use the retained per-op reference walk instead of "
                        "the batched tape scheduler (results are identical)")
    p.add_argument("--chrome-trace", metavar="PATH",
                   help="write chrome://tracing JSON here ('-' for stdout); "
                        "time-lapse counter tracks and self-spans (when "
                        "--timelapse / --spans are active) compose into the "
                        "same file")
    p.add_argument("--json", metavar="PATH",
                   help="write the full analysis JSON here ('-' for stdout)")
    p.add_argument("--timelapse", metavar="PATH",
                   help="write the AerialVision time-lapse JSON here "
                        "('-' for stdout); also renders the ASCII heat "
                        "strips ('!' marks channel-camping intervals)")
    p.add_argument("--lapse-intervals", type=int, default=64,
                   help="fixed sampling intervals for --timelapse "
                        "(default 64)")
    p.add_argument("--manifest", metavar="PATH",
                   help="write a repro_torch.obs run manifest here (compare runs "
                        "with `python -m repro_torch.obs diff A B`)")
    p.add_argument("--doctor", action="store_true",
                   help="run repro_torch.obs.doctor over the report: ranked "
                        "findings with counterfactual recoverable_seconds "
                        "(annotations also land in --chrome-trace)")
    p.add_argument("--spans", metavar="PATH",
                   help="enable the simulator self-span tracer and write its "
                        "chrome trace here ('-' for stdout)")
    p.add_argument("--width", type=int, default=72,
                   help="ASCII timeline width in columns")
    p.add_argument("--self-profile", action="store_true",
                   help="print wall-clock seconds per pipeline stage "
                        "(capture/simulate/analysis/render/export) to stderr")
    return p


def _lenet_step(full: bool, batch: int, device):
    """LeNet's train step and example arguments (params, images, labels)."""
    import torch

    from repro_torch import config as C
    from repro_torch.lenet_repro import CONV_ALGO, LR, SEED
    from repro_torch.models.lenet import LeNet, sgd_step
    entry = C.get("lenet")
    cfg = entry.full if full else entry.smoke
    model = LeNet(cfg, conv_algo=CONV_ALGO, device=device, seed=SEED)
    images = torch.zeros((batch, cfg.image_hw, cfg.image_hw, cfg.image_c),
                         dtype=torch.float32, device=model.device)
    labels = torch.zeros((batch,), dtype=torch.long, device=model.device)

    def step(params, x, y):
        return sgd_step(model, params, x, y, LR)
    return step, (model.param_dict(), images, labels)


def _lm_capture(arch: str, full: bool, batch: int, seq_len: int, device):
    """A decoder LM's train step (``train_bundle``), captured from abstract
    inputs on ``device``."""
    from repro_torch import config as C
    from repro_torch.core.capture import capture_bundle
    from repro_torch.runtime.steps import train_bundle
    entry = C.get(arch)
    shape = C.ShapeConfig("analysis", seq_len=seq_len, global_batch=batch, kind="train")
    rc = C.RunConfig(model=entry.full if full else entry.smoke, shape=shape,
                     mesh=C.SMOKE_MESH)
    return capture_bundle(train_bundle(rc), name=f"{arch}_train", device=device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch import config as C
    from repro_torch.core import CHIPS, Simulator
    from repro_torch.device import resolve_device
    from repro_torch.obs.metrics import StageTimer
    from repro_torch.obs.trace import TRACER

    timer = StageTimer("analysis")
    mark = timer.mark
    if args.spans:
        TRACER.enable()

    if args.buckets <= 0:
        print(f"--buckets must be positive, got {args.buckets}",
              file=sys.stderr)
        return 2
    if args.hw not in CHIPS:
        print(f"unknown --hw {args.hw!r}; known: {sorted(CHIPS)}",
              file=sys.stderr)
        return 2
    try:
        entry = C.get(args.arch)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    if args.batch <= 0:
        print(f"--batch must be positive, got {args.batch}", file=sys.stderr)
        return 2
    if args.seq_len <= 0:
        print(f"--seq-len must be positive, got {args.seq_len}", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(e.args[0], file=sys.stderr)
        return 1

    hw = CHIPS[args.hw]
    if args.topology:
        import dataclasses

        from repro_torch.topology import Topology
        try:
            Topology.validate_spec(args.topology)
        except KeyError as e:
            print(e.args[0], file=sys.stderr)
            return 2
        hw = dataclasses.replace(hw, ici_topology=args.topology)
    sim = Simulator(hw=hw,
                    overlap_collectives=not args.no_overlap,
                    memory_model=not args.no_memory,
                    topology_model=not args.no_topology,
                    scheduler="legacy" if args.legacy_scheduler
                    else "batched")
    lm = entry.full.family != "conv"
    print(f"capturing {args.arch} train step "
          f"({f'seq={args.seq_len}, ' if lm else ''}batch={args.batch}, {args.hw}, "
          f"example tensors on {device}) ...", file=sys.stderr)
    if lm:
        mark("setup")
        cap = _lm_capture(args.arch, args.full, args.batch, args.seq_len, device)
    else:
        step, example = _lenet_step(args.full, args.batch, device)
        mark("setup")
        cap = sim.capture(step, *example, name=f"{args.arch}_train")
    mark("capture")
    rep = sim.performance(cap)
    mark("simulate")
    ar = sim.analysis(rep, num_buckets=args.buckets)
    mark("analysis")

    s = rep.summary()
    print(f"== {args.arch}: modeled step {s['total_seconds'] * 1e3:.3f} ms, "
          f"MFU {s['mfu'] * 100:.1f}%, HBM util "
          f"{s['hbm_utilization'] * 100:.1f}%, launch overhead "
          f"{s['launch_overhead_seconds'] * 1e6:.1f} us ==")
    if rep.memory is not None:
        print(f"   memory: peak {s['peak_hbm_bytes'] / 2**20:.1f} MiB "
              f"({s['peak_hbm_fraction'] * 100:.1f}% of HBM), spill "
              f"{s['spill_bytes'] / 2**20:.1f} MiB "
              f"({s['spill_fraction'] * 100:.1f}% of traffic), channel "
              f"imbalance {s['channel_imbalance']:.2f}")
    print()
    print(ar.phase_table())
    print()
    print(ar.ascii_timeline(width=args.width))
    print()
    print(ar.channels.table())
    if ar.links is not None and ar.links.num_links:
        print()
        print(ar.links.table())
        print(f"   fabric: {rep.hw.ici_topology}, link imbalance "
              f"{s['link_imbalance']:.2f}, link busy "
              f"{s['link_busy_total_seconds'] * 1e3:.3f} ms summed")
    print(f"\nbucket<->summary reconciliation: max rel error "
          f"{ar.reconcile() * 100:.3f}%")
    mark("render")

    lapse = None
    if args.timelapse or args.manifest or args.chrome_trace or args.doctor:
        from repro_torch.obs.timelapse import TimeLapse
        lapse = TimeLapse.from_report(rep, num_intervals=args.lapse_intervals,
                                      label=args.arch)
    if args.timelapse:
        print()
        print(lapse.heat_strips(width=args.width))

    doctor_rep = None
    if args.doctor:
        from repro_torch.obs.doctor import diagnose_engine
        doctor_rep = diagnose_engine(rep, engine=sim.engine,
                                     module=cap.module, lapse=lapse,
                                     label=args.arch)
        print()
        print(doctor_rep.table(width=args.width))
    mark("doctor")

    outputs = []
    if args.chrome_trace:
        extra: list = lapse.to_chrome_events() if lapse is not None else []
        if doctor_rep is not None:
            extra = extra + doctor_rep.to_chrome_events()
        if TRACER.enabled:
            extra = extra + TRACER.to_chrome_events()
        outputs.append((args.chrome_trace,
                        ar.to_chrome_trace(extra_events=extra)))
    if args.json:
        outputs.append((args.json,
                        ar.to_json(indent=2,
                                   stage_seconds=timer.stage_seconds)))
    if args.timelapse:
        outputs.append((args.timelapse, lapse.to_json(indent=2)))
    if args.manifest:
        from repro_torch.obs.manifest import engine_manifest
        man = engine_manifest(
            rep,
            config={"arch": args.arch, "full": args.full,
                    "seq_len": args.seq_len, "batch": args.batch,
                    "buckets": args.buckets, "hw": args.hw,
                    "overlap": not args.no_overlap,
                    "memory": not args.no_memory,
                    "topology": args.topology or rep.hw.ici_topology,
                    "scheduler": ("legacy" if args.legacy_scheduler
                                  else "batched")},
            label=args.arch, stage_seconds=timer.stage_seconds,
            timelapse=lapse)
        outputs.append((args.manifest, man.to_json()))
    for path, payload in outputs:
        if path == "-":
            print(payload)
        else:
            with open(path, "w") as f:
                f.write(payload)
            print(f"wrote {path}", file=sys.stderr)
    mark("export")
    if args.spans:
        from repro_torch.obs.export import trace_json
        payload = trace_json(TRACER.to_chrome_events())
        if args.spans == "-":
            print(payload)
        else:
            with open(args.spans, "w") as f:
                f.write(payload)
            print(f"wrote {args.spans} "
                  f"({len(TRACER.records)} spans)", file=sys.stderr)
    if args.self_profile:
        print(timer.render(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
