#!/usr/bin/env python3
"""Host cost of the port's kernel launchers, in microseconds a call, on one GPU.

    python3 scripts/launcher_cost.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two trees can be measured in one run on one card: for example a parent
commit unpacked with ``git archive`` beside the working tree.  Each launcher
is called on shapes whose kernels take a few microseconds of device time,
so the card keeps up and the host clock over a run of calls, taken before
the final synchronize, measures the host's own path: argument checks, the
output allocation, the stream lookup, the ctypes call and the launch.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def _host_us(fn, calls=200, runs=7):
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    if not torch.cuda.is_available():
        print("launcher_cost: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(128, 84, generator=gen, device="cuda")
    b = torch.randn(84, 10, generator=gen, device="cuda")   # LeNet's last product
    q, k, v = (torch.randn(1, 64, n, 64, generator=gen, device="cuda").bfloat16()
               .transpose(1, 2) for n in (2, 1, 1))
    out = {"src": str(Path(args.src).resolve()),
           "tiled_matmul_us": _host_us(lambda: tiled_matmul(a, b)),
           "flash_attention_us": _host_us(lambda: flash_attention_fwd(q, k, v))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
