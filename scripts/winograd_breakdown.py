#!/usr/bin/env python3
"""Where the fused Winograd conv kernel spends its time, on one GPU.

    python3 scripts/winograd_breakdown.py

Builds ``src/repro_torch/csrc/winograd.cu`` as it is and in variants that
each leave one phase out (by editing the source text; each edit asserts
that its anchor is there), into ``build/winograd_breakdown/``, and times
every build's image-mode launch at the section V case study (x 64x28x28x16,
w 3x3x16x32) and at a ResNet-50 conv2_x layer (x 32x56x56x64, w 3x3x64x64),
SAME, in fp32 and bf16.  A phase's cost is the full kernel's time less the
variant's.  The variants compute wrong outputs by design; only the full
build is held to ``conv3x3_winograd_ref``.

* ``no_x_loads``: no copies of x (the halo stays whatever shared memory
  held);
* ``no_u_loads``: no copies of U;
* ``no_products``: no tensor-core products (the fragments are still loaded
  and split, and kept live);
* ``no_epilogue``: no pass of M through shared memory and no stores of y;
* ``no_cin_loop``: no chunk of cin at all (launch, set-up and epilogue).

The time is the kernel's own device time (``torch.profiler``), the mean
over 20 launches, the builds in turns: full, the variants, full again.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"case": ((64, 28, 28, 16), (3, 3, 16, 32)),
          "resnet": ((32, 56, 56, 64), (3, 3, 64, 64))}
_SINK_F32 = ("acc[pp][mf][nf][0] += __uint_as_float(ah[mf][0] ^ ah[mf][1] ^ ah[mf][2] ^ "
             "ah[mf][3] ^ al[mf][0] ^ al[mf][1] ^ al[mf][2] ^ al[mf][3] ^ bh[nf][0] ^ "
             "bh[nf][1] ^ bl[nf][0] ^ bl[nf][1]);")
_SINK_BF16 = ("acc[pp][mf][nf][0] += __uint_as_float(ah[mf][0] ^ ah[mf][1] ^ ah[mf][2] ^ "
              "ah[mf][3] ^ al[mf][0] ^ al[mf][1] ^ al[mf][2] ^ al[mf][3] ^ bb[nf][0] ^ "
              "bb[nf][1]);")
EDITS = {
    "no_x_loads": [("      copy_unit<T>(raw + (e >> 1)", "      if (c0 < 0) copy_unit<T>(raw + (e >> 1)")],
    "no_u_loads": [("      copy_unit<T>(us + (p", "      if (c0 < 0) copy_unit<T>(us + (p")],
    "no_products": [("mma_tf32(acc[pp][mf][nf], al[mf], bh[nf]);", ""),
                    ("mma_tf32(acc[pp][mf][nf], ah[mf], bl[nf]);", ""),
                    ("mma_tf32(acc[pp][mf][nf], ah[mf], bh[nf]);", _SINK_F32),
                    ("mma_bf16(acc[pp][mf][nf], al[mf], bb[nf]);", ""),
                    ("mma_bf16(acc[pp][mf][nf], ah[mf], bb[nf]);", _SINK_BF16)],
    "no_cin_loop": [("if (n_chunks > 0) load_chunk(0, 0);", ""),
                    ("for (int ch = 0; ch < n_chunks; ++ch) {", "for (int ch = 0; ch < 0; ++ch) {")],
}
_EPILOGUE = "  // M through shared memory, once a block"
_NO_EPILOGUE = """  float sum = 0.f;
#pragma unroll
  for (int pp = 0; pp < 2; ++pp)
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum += acc[pp][mf][nf][e];
  if (sum == 1234.5f) store1<T>(Y + tid, sum);  // keeps the products live
}

"""


def variant_source(src: str, name: str) -> str:
    if name == "no_epilogue":
        i, j = src.index(_EPILOGUE), src.index("bool aligned16")
        return src[:i] + _NO_EPILOGUE + src[j:]
    for old, new in EDITS.get(name, ()):
        if old not in src:
            raise SystemExit(f"winograd_breakdown: the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build
    from repro_torch.kernels.winograd import conv3x3_winograd_ref, filter_transform
    from repro_torch.kernels.winograd.kernel import _CONV, winograd_plan
    if not torch.cuda.is_available():
        print("winograd_breakdown: no CUDA device", file=sys.stderr)
        return 1
    src = (build.CSRC / "winograd.cu").read_text()
    names = ["full", "no_x_loads", "no_u_loads", "no_products", "no_epilogue", "no_cin_loop"]
    out_dir = build.BUILD_DIR.parent / "winograd_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(variant_source(src, name))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        fns[name] = _CONV.bind(ctypes.CDLL(str(lib)))

    def launch(fn, x, u, y, plan):
        b, h, w, cin = x.shape
        rc = fn(0 if x.dtype == torch.float32 else 1, x.data_ptr(), u.data_ptr(),
                y.data_ptr(), b, h, w, cin, u.shape[3], *x.stride()[:3], plan.pad,
                plan.patch[1], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")

    def device_us(fn, x, u, y, plan, n=20):
        launch(fn, x, u, y, plan)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                launch(fn, x, u, y, plan)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if "wino_kernel" in e.key and e.count]
        return sum(e.self_device_time_total for e in ev) / sum(e.count for e in ev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for key, (xs, ws) in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
            u = filter_transform(torch.randn(ws, generator=gen, device="cuda"), dtype)
            plan = winograd_plan(*xs, ws[3], "SAME")
            y = torch.empty(xs[0], plan.oh, plan.ow, ws[3], dtype=dtype, device="cuda")
            launch(fns["full"], x, u, y, plan)
            ref = conv3x3_winograd_ref(x, u, "SAME")
            err = float((y.float() - ref.float()).abs().max() / ref.float().abs().max())
            if err > (2e-2 if dtype == torch.bfloat16 else 1e-4):
                print(f"winograd_breakdown: the full build disagrees ({err})", file=sys.stderr)
                return 1
            times = {name: device_us(fns[name], x, u, y, plan) for name in names}
            times["full_again"] = device_us(fns["full"], x, u, y, plan)
            full = (times["full"] + times["full_again"]) / 2
            label = f"{key} {str(dtype).split('.')[-1]}"
            results[label] = times
            print(f"{label}: full {times['full']:.2f} / {times['full_again']:.2f} us; "
                  + ", ".join(f"{n} {times[n]:.2f} us (phase {full - times[n]:.2f})"
                              for n in names[1:]), flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
