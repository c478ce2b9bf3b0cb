#!/usr/bin/env python3
"""Time the bf16 flash kernel at d 32 and 64 with K/V rings of 2, 3 and 4
stages, on one GPU.

    python3 scripts/flash_ring_depth.py

The kernel's ring depth at d < 128 is a compile-time constant
(``REPRO_FLASH_SMALL_D_STAGES`` in ``src/repro_torch/csrc/flash_attention.cu``);
this builds the source once per depth into ``build/ring_depth/`` and times
each build at llama3-8b's serving shape with the head dim cut to 32 or 64
(b 4, h 32, kv 8, s = t = 2048, causal), the builds in turns, after holding
each to ``attention_ref``.  The time is the kernel's own device time
(``torch.profiler``): at these sizes a call's host path is about as long as
the kernel, so CUDA events around a loop of calls would time the host.  Two
CTAs an SM, the other way to hide the loads, would need at most 128
registers a thread; the kernel uses 234-248 (``nvcc -Xptxas -v``), so only
the ring's depth is measured.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEPTHS = (2, 3, 4)


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import attention_ref, kernel
    if not torch.cuda.is_available():
        print("flash_ring_depth: no CUDA device", file=sys.stderr)
        return 1
    out_dir = build.BUILD_DIR.parent / "ring_depth"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for depth in DEPTHS:
        lib = out_dir / f"libflash_attention-stages{depth}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DREPRO_FLASH_SMALL_D_STAGES={depth}",
               "-o", str(lib), str(build.CSRC / "flash_attention.cu")]
        procs[depth] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for depth, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        fns[depth] = kernel._FWD.bind(ctypes.CDLL(str(lib)))

    def run(depth, *args, **kw):
        kernel._FWD.fn = fns[depth]
        return kernel.flash_attention_fwd(*args, **kw)

    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for d in (32, 64):
        q, k, v = (torch.randn(4, 2048, n, d, generator=gen, device="cuda")
                   .bfloat16().transpose(1, 2) for n in (32, 8, 8))
        ref = attention_ref(q[:1], k[:1], v[:1], causal=True).float()
        for depth in DEPTHS:
            out = run(depth, q[:1], k[:1], v[:1], causal=True).float()
            err = float(((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max())
            if not err <= 2e-2:
                print(f"d {d}, {depth} stages: worst row {err} > 2e-2", file=sys.stderr)
                return 1
        times = {depth: [] for depth in DEPTHS}
        for order in (DEPTHS, DEPTHS[::-1], DEPTHS, DEPTHS[::-1]):
            for depth in order:
                run(depth, q, k, v, causal=True)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        run(depth, q, k, v, causal=True)
                    torch.cuda.synchronize()
                # the mean over the launches the profiler recorded (it can drop some)
                rec = [e for e in prof.key_averages()
                       if e.device_type != torch.autograd.DeviceType.CPU and e.count > 0]
                times[depth].append(sum(e.self_device_time_total / e.count for e in rec) / 1e3)
        result[f"d{d}"] = {f"stages{depth}": t for depth, t in times.items()}
        for depth, t in times.items():
            print(f"d {d}, {depth} stages: {' '.join(f'{x:.4f}' for x in t)} ms")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
