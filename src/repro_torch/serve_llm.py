"""Serve a small LM with batched requests: prefill + batched decode through
the production Server loop, then replay the decode step through the
simulator to see where serving time goes.

    PYTHONPATH=src python -m repro_torch.serve_llm --device cpu
    PYTHONPATH=src python -m repro_torch.serve_llm            # on cuda

The port of ``examples/serve_llm.py``: the llama3-8b smoke config with
seeded random weights, 4 requests of 16 prompt tokens, 12 new tokens each
at temperature 0.8; the decode step against a 64-slot cache captured from
abstract inputs and simulated on the ``h100`` spec.  Runs on ``cuda``
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from repro_torch import config as C
from repro_torch.core import Simulator
from repro_torch.core.capture import capture_bundle
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.server import Server
from repro_torch.runtime.steps import decode_bundle


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve_llm",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    entry = C.get("llama3-8b")
    shape = C.ShapeConfig("serve_demo", seq_len=64, global_batch=4, kind="prefill")
    rc = C.RunConfig(model=entry.smoke, shape=shape, mesh=C.SMOKE_MESH)
    params = build_model(entry.smoke).init(seed=0, device=dev)

    print("== batched generation (4 requests, 12 tokens each) ==")
    server = Server(rc, params, temperature=0.8)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, entry.smoke.vocab_size, (4, 16), generator=gen, device=dev)
    out = server.generate({"tokens": prompts}, max_new_tokens=12, seed=7)
    for i, row in enumerate(out):
        print(f"  request {i}: {row.tolist()}")
    print(f"  prefill {server.stats.prefill_s * 1e3:.1f} ms, "
          f"decode {server.stats.decode_tok_per_s:.0f} tok/s ({dev.type} functional)")

    sim = Simulator()
    print(f"== simulator: where does a decode step go on {sim.hw.name}? ==")
    dshape = C.ShapeConfig("serve_decode", seq_len=64, global_batch=4, kind="decode")
    drc = C.RunConfig(model=entry.smoke, shape=dshape, mesh=C.SMOKE_MESH)
    cap = capture_bundle(decode_bundle(drc), name="decode_step", device=dev)
    rep = sim.performance(cap)
    print(f"  modeled decode step: {rep.total_seconds * 1e6:.1f} us "
          f"({1.0 / max(rep.total_seconds, 1e-12):.0f} tok/s/chip), "
          f"HBM util {rep.hbm_utilization * 100:.0f}% "
          f"(decode is bandwidth-bound: weights re-read per token)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
