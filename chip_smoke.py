#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, then drives the port's
two paths, each with every kernel's launch count set to 0 just before and
read just after:

* LeNet — ``repro_torch.lenet_repro.run``: train LeNet (full width, batch
  128, 60 SGD steps), capture and simulate one step on the ``h100`` spec,
  and the section V conv-algorithm loop;
* serving — ``repro_torch.launch.serve.run``: llama3-8b at its full config
  (32 layers, bf16, random weights from seed 0) serves batch 4 x 2048-token
  prompts for 16 new tokens, prefill attention in the flash kernel; then the
  kernel is held to its plain version on each layer's served q, k, v, the
  prefill against the plain decode attention at full width, and the
  prefill and decode steps are captured and simulated on ``h100``.

Then it times each kernel, its plain version and the one PyTorch library
call that computes the same function, beside the card's bound for the same
work, and the steady-state LeNet training step with its device time by
kernel.

Exits non-zero on any failure, without a result line; in particular when no
CUDA device is available or when ``src/repro_torch`` is not beside it.  The
next-to-last line of stdout is the JSON ``{"kernels": [...]}`` record and
the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# data-sheet peaks of one H100 SXM (dense, at the 700 W power limit)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
L2_FLUSH_BYTES = 64 << 20    # more than the 50 MB L2

# a ResNet-50 conv2_x 3x3 layer (He et al. 2015, arXiv:1512.03385) at batch 32
RESNET_X, RESNET_W = (32, 56, 56, 64), (3, 3, 64, 64)

# the serving path: llama3-8b FULL, batch 4, 2048-token prompts, 16 new tokens
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "llama3-8b", 4, 2048, 16

F32_TOL = 1e-4
BF16_TOL = 2e-2


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(title: str) -> None:
    print(f"== {title} ==", flush=True)


def device_phase():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    phase("1. device")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def build_phase():
    from repro_torch.kernels import build
    phase("2. build")
    t0 = time.perf_counter()
    secs = build.build()
    print(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f}s "
          f"(per source: {json.dumps({k: round(v, 1) for k, v in secs.items()})})")
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # the redesigned kernels' machine code: wgmma (HGMMA) and TMA loads
    # (UTMALDG) in every bf16 flash instance, cp.async (LDGSTS) in tiled_matmul
    counts = sass_counts("flash_attention", "attn_bf16_kernel", ("HGMMA", "UTMALDG"))
    check(all(c[op] > 0 for c in counts.values() for op in c),
          "a bf16 flash instance has no HGMMA or no UTMALDG")
    sass_counts("tiled_matmul", "", ("LDGSTS",))


def sass_counts(name, func, ops):
    """Count each of ``ops`` in the SASS of every function of library
    ``name`` whose name holds ``func``; print them, and fail if a function
    is missing or an op appears in none of them."""
    from repro_torch.kernels import build
    counts = {}
    for fn_sass in build.sass(name).split("Function : ")[1:]:
        fname = fn_sass.split("\n", 1)[0].strip()
        if func in fname:
            counts[fname] = {op: fn_sass.count(op) for op in ops}
    check(bool(counts), f"no {func or 'kernel'} function in {name}'s SASS")
    for fname, c in counts.items():
        print(f"  {name} SASS {fname[:72]}: {json.dumps(c)}")
    for op in ops:
        check(sum(c[op] for c in counts.values()) > 0, f"{op} never appears in {name}'s SASS")
    return counts


def _close(out, ref, tol):
    """max abs error, and whether it is within ``tol`` of the output's scale.

    The products sum up to 100,352 terms, in another order than the plain
    version, so the rounding error grows with the output's magnitude: the
    bound is ``tol * max(1, max|ref|)``, not elementwise.
    """
    out, ref = out.float(), ref.float()
    if not out.numel():
        return 0.0, True
    err = float((out - ref).abs().max())
    return err, err <= tol * max(1.0, float(ref.abs().max()))


def _close_rows(out, ref, tol):
    """Attention outputs: (max abs error, the worst row's error over that
    row's largest |ref|, whether every row is within ``tol`` of its own).

    A row's output is a weighted mean of v, so its scale falls with the
    number of keys it sees: a bound on the whole tensor's magnitude would
    be set by the first rows and pass a late row that misses a tile.
    """
    out, ref = out.float(), ref.float()
    if not out.numel():
        return 0.0, 0.0, True
    err, scale = (out - ref).abs().amax(-1), ref.abs().amax(-1)
    worst = float((err / scale.clamp_min(1e-30)).max())
    return float(err.max()), worst, bool((err <= tol * scale).all())


# LeNet-full (batch 128, gemm convs) forward products: (M, K, N)
LENET_FWD = ((100352, 25, 6), (12800, 150, 16), (128, 400, 120),
             (128, 120, 84), (128, 84, 10))


def lenet_step_products(gen, device):
    """Every tiled_matmul launch of one LeNet-full training step, with the
    operands' real shapes and strides: the 5 forward products, the 5 filter
    gradients A^T @ dY, and the 4 input gradients dY @ B^T (conv1's input
    needs none)."""
    import torch
    out = []
    for i, (m, k, n) in enumerate(LENET_FWD):
        a = torch.randn(m, k, generator=gen, device=device)
        b = torch.randn(k, n, generator=gen, device=device)
        dy = torch.randn(m, n, generator=gen, device=device)
        out.append((f"fwd{i}", a, b))
        out.append((f"dw{i}", a.t(), dy))
        if i > 0:
            out.append((f"dx{i}", dy, b.t()))
    return out


def matmul_phase():
    import torch
    from repro_torch.kernels.tiled_matmul import (BLOCK_CONFIGS, matmul_ref,
                                                  tiled_matmul)
    phase("3. tiled_matmul against matmul_ref")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    cases = [(f"lenet {n} {tuple(a.shape)}@{tuple(b.shape)}", a, b, F32_TOL, None)
             for n, a, b in lenet_step_products(gen, "cuda")]
    a = torch.randn(257, 129, generator=gen, device="cuda")
    b = torch.randn(129, 65, generator=gen, device="cuda")
    cases.append(("ragged 257x129x65 f32", a, b, F32_TOL, None))
    cases.append(("ragged 257x129x65 bf16", a.bfloat16(), b.bfloat16(),
                  BF16_TOL, None))
    a = torch.randn(256, 256, generator=gen, device="cuda")
    b = torch.randn(256, 256, generator=gen, device="cuda")
    for cfg in BLOCK_CONFIGS:
        cases.append((f"sweep 256^3 block {cfg}", a, b, F32_TOL, cfg))
    # split-K: the weight gradients in bf16, and a K (5000) that is not a
    # multiple of splits * block_k (16 splits of 5 slabs of 64, the last ragged)
    for label, a, b in lenet_step_products(gen, "cuda"):
        if label in ("dw0", "dw1"):
            cases.append((f"split-K {label} bf16", a.bfloat16(), b.bfloat16(), BF16_TOL, None))
    a = torch.randn(64, 5000, generator=gen, device="cuda")
    b = torch.randn(5000, 32, generator=gen, device="cuda")
    cases.append(("ragged split-K 64x5000x32 f32", a, b, F32_TOL, None))
    cases.append(("ragged split-K 64x5000x32 bf16", a.bfloat16(), b.bfloat16(), BF16_TOL, None))
    for label, a, b, tol, cfg in cases:
        kw = {} if cfg is None else dict(block_m=cfg[0], block_n=cfg[1],
                                         block_k=cfg[2])
        out = tiled_matmul(a, b, **kw)
        torch.cuda.synchronize()
        err, ok = _close(out, matmul_ref(a, b), tol)
        print(f"  {label}: max_abs_err {err:.3e} (tol {tol})")
        check(ok, f"tiled_matmul disagrees with matmul_ref on {label}")
        if label.startswith("lenet"):
            worst = max(worst, err)
        if label.startswith("lenet dw0") or label.startswith("lenet dw1"):
            again = tiled_matmul(a, b, **kw)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"two calls on {label} differ in their bits")
            print(f"  {label}: a second call gives the same bits")
    return worst


def winograd_phase():
    """The fused Winograd conv against the direct conv and its plain
    version, the tiles entry against winograd_tiles_ref, both in bf16, the
    bits of a second call, the compiled kernel's shared memory against the
    plan's, and the tensor-core products (HMMA) and cp.async copies
    (LDGSTS) in its machine code.  Returns the fp32 errors at the case
    study: (fused conv vs its plain version, tiles vs winograd_tiles_ref)."""
    import torch
    from repro_torch.kernels.winograd import (conv3x3_ref, conv3x3_winograd,
                                              conv3x3_winograd_ref, filter_transform,
                                              winograd_conv, winograd_tiles,
                                              winograd_tiles_ref)
    from repro_torch.kernels.winograd.kernel import kernel_smem_bytes, smem_bytes
    from repro_torch.lenet_repro import CASE_W, CASE_X
    phase("4. winograd_conv and winograd_tiles against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    bf16 = torch.bfloat16
    cases = [(CASE_X, CASE_W), ((8, 28, 28, 64), (3, 3, 64, 64)),
             ((1, 13, 13, 3), (3, 3, 3, 5))]
    for xs, ws in cases:
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda")
        u = filter_transform(w, torch.float32)
        for pad in ("SAME", "VALID"):
            y = conv3x3_winograd(x, w, pad)
            torch.cuda.synchronize()
            check(y.dtype == torch.float32, f"fused conv returned {y.dtype}")
            # the transforms' extra roundings against a direct conv: Winograd
            # F(2x2,3x3) amplifies fp32 rounding by the transforms' ~4x growth
            err_c, ok_c = _close(y, conv3x3_ref(x, w, pad), 4 * F32_TOL)
            err_p, ok_p = _close(y, conv3x3_winograd_ref(x, u, pad), F32_TOL)
            yb = conv3x3_winograd(x.to(bf16), w.to(bf16), pad)
            err_b, ok_b = _close(yb, conv3x3_winograd_ref(x.to(bf16), filter_transform(
                w.to(bf16), bf16), pad), BF16_TOL)
            print(f"  conv x {xs} w {ws} {pad}: vs conv3x3_ref {err_c:.3e} (tol "
                  f"{4 * F32_TOL}), vs conv3x3_winograd_ref {err_p:.3e} (tol {F32_TOL}); "
                  f"bf16 {err_b:.3e} (tol {BF16_TOL})")
            check(ok_c, f"winograd_conv disagrees with conv3x3_ref at {xs} {pad}")
            check(ok_p, f"winograd_conv disagrees with conv3x3_winograd_ref at {xs} {pad}")
            check(yb.dtype == bf16 and ok_b, f"bf16 winograd_conv disagrees at {xs} {pad}")
            if (xs, pad) == (CASE_X, "SAME"):
                errs["conv"] = err_p
        # the tiles entry on the tiles this conv's SAME tiling gives
        tiles = torch.randn(xs[0], (xs[1] + 1) // 2, (xs[2] + 1) // 2, 4, 4, xs[3],
                            generator=gen, device="cuda")
        yt = winograd_tiles(tiles, u)
        err_t, ok_t = _close(yt, winograd_tiles_ref(tiles, u), F32_TOL)
        tb, ub = tiles.to(bf16), u.to(bf16)
        err_tb, ok_tb = _close(winograd_tiles(tb, ub), winograd_tiles_ref(tb, ub), BF16_TOL)
        print(f"  tiles {tuple(tiles.shape)} u {tuple(u.shape)}: max_abs_err {err_t:.3e} "
              f"(tol {F32_TOL}); bf16 {err_tb:.3e} (tol {BF16_TOL})")
        check(ok_t, f"winograd_tiles disagrees with winograd_tiles_ref at {tuple(tiles.shape)}")
        check(ok_tb, f"bf16 winograd_tiles disagrees at {tuple(tiles.shape)}")
        if xs == CASE_X:
            errs["tiles"] = err_t
            again = (winograd_conv(x, u, "SAME"), winograd_tiles(tiles, u))
            torch.cuda.synchronize()
            check(torch.equal(again[0], winograd_conv(x, u, "SAME"))
                  and torch.equal(again[1], yt), "two winograd calls differ in their bits")
            print("  case study: a second call of each entry gives the same bits")
    # a strided x: a slice of wider pixels, transposed, one channel in (rows
    # off a 16-byte boundary: 4-byte copies in fp32, plain loads in bf16)
    big = torch.randn(4, 30, 29, 40, generator=gen, device="cuda")
    w = torch.randn(3, 3, 32, 24, generator=gen, device="cuda")
    views = (("channel slice, transposed", lambda t: t[..., :32].transpose(1, 2)),
             ("one channel in", lambda t: t[..., 1:33]))
    for label, view in views:
        for dtype, tol in ((torch.float32, F32_TOL), (bf16, BF16_TOL)):
            x, u = view(big.to(dtype)), filter_transform(w, dtype)
            check(x.stride(3) == 1 and not x.is_contiguous(), "strided x is contiguous")
            for pad in ("SAME", "VALID"):
                err, ok = _close(winograd_conv(x, u, pad),
                                 conv3x3_winograd_ref(x, u, pad), tol)
                check(ok, f"winograd_conv on a strided x ({label}, {dtype}, {pad}): "
                          f"max_abs_err {err}")
        print(f"  strided x {tuple(x.shape)} strides {x.stride()} ({label}): fp32 and "
              f"bf16, SAME and VALID agree")
    for dtype in (torch.float32, bf16):
        for image in (True, False):
            check(kernel_smem_bytes(dtype, image) == smem_bytes(dtype, image),
                  f"the plan's shared memory differs from the kernel's ({dtype}, {image})")
    counts = sass_counts("winograd", "wino_kernel", ("HMMA", "LDGSTS"))
    check(all(c["HMMA"] > 0 for c in counts.values()), "a winograd instance has no HMMA")
    return errs


def flash_phase():
    """The flash kernel against attention_ref: the serving slice's shape
    (one llama3-8b layer's prefill attention, handed in as the model's
    (b, s, heads, d) views), a ragged length, and the masks and head dims
    llama3-8b does not use, at small sizes.  Each row is held to its own
    scale (``_close_rows``)."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_fwd
    phase("5. flash_attention against attention_ref")
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16 = torch.bfloat16
    cases = [  # label, (b, h, kv, s, t, d), dtype, causal, window, softcap
        ("slice b4 h32 kv8 s=t=2048 d128 bf16 causal", (4, 32, 8, 2048, 2048, 128),
         bf16, True, 0, 0.0),
        ("ragged s=t=2000 d128 bf16 causal", (1, 32, 8, 2000, 2000, 128),
         bf16, True, 0, 0.0),
        ("ragged s=t=2000 d128 f32 causal", (1, 8, 2, 2000, 2000, 128),
         torch.float32, True, 0, 0.0),
        ("window 64 d64 f32", (2, 8, 2, 500, 500, 64), torch.float32, True, 64, 0.0),
        ("softcap 30 d32 f32", (2, 4, 2, 300, 300, 32), torch.float32, True, 0, 30.0),
        ("non-causal s=200 t=333 d64 f32", (2, 4, 4, 200, 333, 64),
         torch.float32, False, 0, 0.0),
        ("non-causal window 64 softcap 30 d32 bf16", (1, 8, 2, 257, 257, 32),
         bf16, False, 64, 30.0),
    ]
    slice_err = None
    for label, (b, h, kv, sq, t, d), dtype, causal, window, softcap in cases:
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, t, kv, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, t, kv, d, generator=gen, device="cuda").to(dtype)
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = BF16_TOL if dtype == bf16 else 2e-3
        err, worst, ok = _close_rows(out, attention_ref(q, k, v, **kw), tol)
        print(f"  {label}: max_abs_err {err:.3e}, worst row {worst:.3e} of its "
              f"max |ref| (tol {tol})")
        check(ok, f"flash_attention disagrees with attention_ref on {label}")
        if label.startswith("slice"):
            slice_err = err
    return slice_err


def main_path_phase():
    import torch
    from repro_torch import lenet_repro
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.kernels.winograd import winograd_conv, winograd_tiles
    phase("6. main path: train LeNet, capture + simulate, SS V loop")
    for kern in (tiled_matmul, winograd_conv, winograd_tiles):
        kern.launches = 0
    res = lenet_repro.run(device="cuda", hw="h100")
    launches = {"tiled_matmul": tiled_matmul.launches,
                "winograd_conv": winograd_conv.launches,
                "winograd_tiles": winograd_tiles.launches}
    torch.cuda.synchronize()
    print(f"  main-path launches: {json.dumps(launches)}; "
          f"train {res['train_seconds']:.2f}s")
    products_per_step = 3 * len(LENET_FWD) - 1
    expected = lenet_repro.STEPS * products_per_step
    check(math.isfinite(res["loss"]), f"loss is not finite: {res['loss']}")
    check(res["accuracy"] > 0.6, f"accuracy {res['accuracy']} <= 0.6")
    check(launches["tiled_matmul"] >= expected,
          f"tiled_matmul launched {launches['tiled_matmul']} times, expected "
          f">= {expected}")
    # the section V loop's Winograd conv is one fused launch; the tiles
    # entry is not on the path
    check(launches["winograd_conv"] > 0, "winograd_conv never launched")
    s = res["report"].summary()
    check(s["total_seconds"] > 0 and math.isfinite(s["total_seconds"]),
          f"bad simulated step time {s['total_seconds']}")
    check(s["total_flops"] > 0, "simulated step has no FLOPs")
    for algo, r in res["conv_algos"].items():
        tol = 1e-2 if algo == "fft" else 1e-3
        check(r["shape"] == (64, 28, 28, 32), f"{algo}: shape {r['shape']}")
        check(r["max_abs_err"] <= tol,
              f"{algo} conv max_abs_err {r['max_abs_err']} > {tol}")
    return launches, products_per_step


def _time_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cold_ms(fn, flush, reps=10):
    """CUDA-event time of one call of ``fn`` with the L2 cache flushed
    before it (``flush``, a 64 MB buffer, written between calls), mean over
    ``reps``."""
    import torch
    fn()
    pairs = []
    for _ in range(reps):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def _device_events(fn, n=5):
    """(device ms, device ops) a call of ``fn``: every kernel and copy the
    device ran under ``torch.profiler`` over ``n`` warm calls, summed and
    divided by ``n``.  None, None if nothing was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    if not rows:
        return None, None
    return (sum(e.self_device_time_total for e in rows) / n / 1e3,
            sum(e.count for e in rows) / n)


def _device_ms(fn, n=5, match=""):
    """The device's own time for one call of ``fn``, so that host dispatch
    and kernel time can be told apart: from ``torch.profiler`` over ``n``
    warm calls, the mean self device time of each kernel it launches (each
    launched once a call) whose name holds ``match``, summed.  A mean over the recorded launches, not
    a total over ``n``, because late in a long run the profiler can drop
    some of a window's kernel records (one of three fp32 flash launches
    recorded, on an H100).
    None if three profiles in a row record no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU and e.count > 0
                   and e.self_device_time_total > 0 and match in e.key]
        if kernels:
            return sum(e.self_device_time_total / e.count for e in kernels) / 1e3
    print("  torch.profiler recorded no device time: not measured")
    return None


def _fmt_ms(t):
    return "not measured" if t is None else f"{t:.4f} ms"


def _total(values):
    return None if any(v is None for v in values) else sum(values)


def _bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def timing_phase(launches, products_per_step, mm_err, wino_errs):
    import torch
    from repro_torch.kernels.tiled_matmul import matmul_ref, tiled_matmul
    from repro_torch.kernels.tiled_matmul.kernel import split_k_plan
    from repro_torch.kernels.tiled_matmul.ops import DEFAULT_BLOCK
    phase("7. timing of the LeNet kernels (CUDA events; device time from "
          "torch.profiler; TF32 off)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    prods = lenet_step_products(gen, "cuda")
    rows = []
    flops = nbytes = 0.0
    for label, a, b in prods:
        m, k = a.shape
        n = b.shape[1]
        f, nb = 2.0 * m * n * k, 4.0 * (m * k + k * n + m * n)
        flops += f
        nbytes += nb
        t_k = _time_ms(lambda: tiled_matmul(a, b))
        t_d = _device_ms(lambda: tiled_matmul(a, b))
        t_p = _time_ms(lambda: matmul_ref(a, b))
        t_l = _time_ms(lambda: torch.matmul(a, b))
        t_ld = _device_ms(lambda: torch.matmul(a, b))
        splits = split_k_plan(m, n, k, *DEFAULT_BLOCK, sms)
        bound, by = _bound(f, nb, PEAK_F32_FLOPS)
        rows.append({"product": label, "m": m, "k": k, "n": n, "splits": splits,
                     "ms": t_k, "device_ms": t_d, "plain_ms": t_p, "library_ms": t_l,
                     "library_device_ms": t_ld, "bound_ms": bound, "bound_by": by})
        print(f"  tiled_matmul {label} ({m}x{k})@({k}x{n}), {splits} split(s): kernel "
              f"{t_k:.4f} ms ({_fmt_ms(t_d)} on the device), plain {t_p:.4f} ms, "
              f"torch.matmul {t_l:.4f} ms ({_fmt_ms(t_ld)} on the device), bound "
              f"{bound * 1e3:.2f} us ({by})")
    mm_bound, mm_by = _bound(flops, nbytes, PEAK_F32_FLOPS)
    mm = {"name": "tiled_matmul", "route": "cuda",
          "source": "src/repro_torch/csrc/tiled_matmul.cu",
          "replaces": "src/repro/kernels/tiled_matmul/kernel.py:35",
          "launches": launches["tiled_matmul"], "max_abs_err": mm_err,
          "ms": sum(r["ms"] for r in rows),
          "device_ms": _total([r["device_ms"] for r in rows]),
          "plain_ms": sum(r["plain_ms"] for r in rows),
          "bound_ms": mm_bound, "bound_by": mm_by,
          "library_ms": sum(r["library_ms"] for r in rows),
          "unit": f"the {products_per_step} products of one LeNet-full "
                  "training step (batch 128)"}

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_products.json").write_text(json.dumps(rows, indent=1))
    return [mm] + _winograd_timing(gen, launches, wino_errs)


def _unfused_conv3x3_winograd(x, w, padding):
    """The Winograd conv as the port ran it before the fused kernel, written
    out: two pads, the tile copy, G copied from numpy on every call, U, the
    tiles op and the reassembly copy."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.winograd.ops import winograd_tiles_op
    from repro_torch.kernels.winograd.ref import G
    b, H, W, cin = x.shape
    cout = w.shape[-1]
    if padding == "SAME":
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
        H, W = H + 2, W + 2
    oh, ow = H - 2, W - 2
    th, tw = (oh + 1) // 2, (ow + 1) // 2
    x = F.pad(x, (0, 0, 0, 2 * tw + 2 - W, 0, 2 * th + 2 - H))
    tiles = x.unfold(1, 4, 2).unfold(2, 4, 2).permute(0, 1, 2, 4, 5, 3).contiguous()
    g = torch.as_tensor(G, device=x.device, dtype=x.dtype)
    u = torch.einsum("ij,jkcf,lk->ilcf", g, w.to(x.dtype), g).contiguous()
    y = winograd_tiles_op(tiles, u)
    out = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * th, 2 * tw, cout)
    return out[:, :oh, :ow]


def _winograd_timing(gen, launches, errs):
    """The Winograd kernel at the section V case study and at a ResNet-50
    conv2_x layer, SAME: the fused conv warm and with L2 flushed, the whole
    ``conv3x3_winograd`` call and the unfused program it replaces (device
    time and device ops a call), the tiles entry, the plain version, and
    ``F.conv2d`` (TF32 off) on NCHW and on the NHWC tensor viewed as
    channels_last; the bound uses TF32's peak, as the products run on the
    tensor cores.  Returns the ``winograd_tiles`` and ``winograd_conv``
    records."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.winograd import (conv3x3_winograd, conv3x3_winograd_ref,
                                              filter_transform, winograd_conv,
                                              winograd_plan, winograd_tiles,
                                              winograd_tiles_ref)
    from repro_torch.lenet_repro import CASE_W, CASE_X
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    shapes = {"case": (CASE_X, CASE_W), "resnet": (RESNET_X, RESNET_W)}
    out = {}
    for key, (xs, ws) in shapes.items():
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda")
        u = filter_transform(w, torch.float32)
        b, h, wd, cin = xs
        cout = ws[3]
        plan = winograd_plan(b, h, wd, cin, cout, "SAME")
        n_tiles = b * plan.tiles[0] * plan.tiles[1]
        flops = (2.0 * 16 * n_tiles * cin * cout   # the 16 contractions
                 + 32.0 * n_tiles * cin            # B^T d B adds
                 + 24.0 * n_tiles * cout)          # A^T M A adds
        n_out = b * plan.oh * plan.ow * cout
        r = {"x": xs, "w": ws, "patch": plan.patch, "grid": plan.grid}

        def conv():
            return winograd_conv(x, u, "SAME")

        r["ms"], r["device_ms"] = _time_ms(conv), _device_ms(conv)
        r["cold_ms"] = _cold_ms(conv, flush)
        r["cold_device_ms"] = _device_ms(lambda: (flush.fill_(1.0), conv()),
                                         match="wino_kernel")
        r["bound_ms"], r["bound_by"] = _bound(flops, 4.0 * (x.numel() + u.numel() + n_out),
                                              PEAK_TF32_FLOPS)
        for name, fn in (("call", lambda: conv3x3_winograd(x, w, "SAME")),
                         ("unfused_call", lambda: _unfused_conv3x3_winograd(x, w, "SAME"))):
            ms = _time_ms(fn)
            dev, ops = _device_events(fn)
            r[name] = {"ms": ms, "device_ms": dev, "device_ops": ops}
        r["plain_ms"] = _time_ms(lambda: conv3x3_winograd_ref(x, u, "SAME"), reps=5, warmup=1)
        tiles = torch.randn(b, *plan.tiles, 4, 4, cin, generator=gen, device="cuda")
        r["tiles"] = {"ms": _time_ms(lambda: winograd_tiles(tiles, u)),
                      "device_ms": _device_ms(lambda: winograd_tiles(tiles, u)),
                      "plain_ms": _time_ms(lambda: winograd_tiles_ref(tiles, u), reps=5,
                                           warmup=1)}
        r["tiles"]["bound_ms"], r["tiles"]["bound_by"] = _bound(
            flops, 4.0 * (tiles.numel() + u.numel() + n_tiles * 4 * cout), PEAK_TF32_FLOPS)
        xn, wn = x.permute(0, 3, 1, 2).contiguous(), w.permute(3, 2, 0, 1).contiguous()
        xcl, wcl = x.permute(0, 3, 1, 2), wn.contiguous(memory_format=torch.channels_last)
        for name, (xi, wi) in (("library_nchw", (xn, wn)), ("library", (xcl, wcl))):
            r[f"{name}_ms"] = _time_ms(lambda: F.conv2d(xi, wi, padding=1))
            r[f"{name}_device_ms"] = _device_ms(lambda: F.conv2d(xi, wi, padding=1))
        xb, ub = x.bfloat16(), filter_transform(w, torch.bfloat16)
        xbl, wbl = xcl.bfloat16(), wcl.bfloat16()
        r["bf16"] = {"device_ms": _device_ms(lambda: winograd_conv(xb, ub, "SAME")),
                     "library_device_ms": _device_ms(lambda: F.conv2d(xbl, wbl, padding=1))}
        r["bf16"]["bound_ms"], r["bf16"]["bound_by"] = _bound(
            flops, 2.0 * (x.numel() + u.numel() + n_out), PEAK_BF16_FLOPS)
        print(f"  winograd_conv x {xs} w {ws} SAME ({plan.grid} blocks of "
              f"{plan.patch[0]}x{plan.patch[1]} tiles): warm {r['ms']:.4f} ms "
              f"({_fmt_ms(r['device_ms'])} on the device), L2 flushed {r['cold_ms']:.4f} ms "
              f"({_fmt_ms(r['cold_device_ms'])} on the device); bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}, TF32 at 495 TFLOP/s)")
        for name in ("call", "unfused_call"):
            c = r[name]
            print(f"    {'conv3x3_winograd' if name == 'call' else 'unfused program'}: "
                  f"{c['ms']:.4f} ms, {_fmt_ms(c['device_ms'])} on the device over "
                  f"{c['device_ops']:.0f} device ops a call")
        print(f"    winograd_tiles on tiles {tuple(tiles.shape)}: {r['tiles']['ms']:.4f} ms "
              f"({_fmt_ms(r['tiles']['device_ms'])} on the device), bound "
              f"{r['tiles']['bound_ms'] * 1e3:.2f} us ({r['tiles']['bound_by']}); plain "
              f"{r['tiles']['plain_ms']:.4f} ms")
        print(f"    plain conv3x3_winograd_ref {r['plain_ms']:.4f} ms; F.conv2d (TF32 off) "
              f"NCHW {r['library_nchw_ms']:.4f} ms ({_fmt_ms(r['library_nchw_device_ms'])} "
              f"on the device), channels_last {r['library_ms']:.4f} ms "
              f"({_fmt_ms(r['library_device_ms'])} on the device)")
        print(f"    bf16: winograd_conv {_fmt_ms(r['bf16']['device_ms'])} on the device, "
              f"F.conv2d channels_last {_fmt_ms(r['bf16']['library_device_ms'])}; bound "
              f"{r['bf16']['bound_ms'] * 1e3:.2f} us ({r['bf16']['bound_by']})")
        out[key] = r
    case = out["case"]
    unit = "the SS V case study, x (64,28,28,16) w (3,3,16,32) SAME"
    tiles_rec = {"name": "winograd_tiles", "route": "cuda",
                 "source": "src/repro_torch/csrc/winograd.cu",
                 "replaces": "src/repro/kernels/winograd/kernel.py:46",
                 "launches": launches["winograd_tiles"], "max_abs_err": errs["tiles"],
                 "ms": case["tiles"]["ms"], "device_ms": case["tiles"]["device_ms"],
                 "plain_ms": case["tiles"]["plain_ms"],
                 "bound_ms": case["tiles"]["bound_ms"], "bound_by": case["tiles"]["bound_by"],
                 "library_ms": case["library_nchw_ms"],
                 "library_device_ms": case["library_nchw_device_ms"], "peak": "tf32",
                 "unit": f"the tiles entry (not on the main path) on the tiles of {unit}",
                 "resnet": out["resnet"]["tiles"]}
    conv_rec = {"name": "winograd_conv", "route": "cuda",
                "source": "src/repro_torch/csrc/winograd.cu",
                "replaces": "src/repro/kernels/winograd/kernel.py:46",
                "launches": launches["winograd_conv"], "max_abs_err": errs["conv"],
                "peak": "tf32", "unit": f"{unit}, x NHWC to y NHWC in one launch",
                **{k: v for k, v in case.items() if k != "tiles"},
                "resnet": {k: v for k, v in out["resnet"].items() if k != "tiles"}}
    return [tiles_rec, conv_rec]


def step_phase():
    """Steady-state LeNet-full training step time (CUDA events over 10 steps
    after 3 warm-up steps), and the device time by kernel name over 5 steps
    from ``torch.profiler``: the main path's model, batches and SGD step,
    with the batches already on the card."""
    import itertools

    import torch
    from repro_torch import lenet_repro
    from repro_torch.models.lenet import sgd_step
    phase(f"8. LeNet-full training step ({lenet_repro.CONV_ALGO}, "
          f"batch {lenet_repro.BATCH})")
    model = lenet_repro.new_model("cuda")
    batches = list(itertools.islice(lenet_repro.device_batches(model, seed=1), 10))
    state = {"params": model.param_dict(), "i": 0}

    def one_step():
        x, y = batches[state["i"] % len(batches)]
        state["i"] += 1
        state["params"] = sgd_step(model, state["params"], x, y,
                                   lenet_repro.LR)[0]

    step_ms = _time_ms(one_step, reps=10, warmup=3)
    print(f"  step {step_ms:.3f} ms (CUDA events, mean of 10)")
    _profile("step", one_step, 5)
    return step_ms


def _profile(unit, fn, n, top=10):
    """Device time by kernel over ``n`` calls of ``fn`` under
    ``torch.profiler``, and the device's busy share of the host window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    # only the device's own events (kernels, copies): a CPU op's row also
    # carries the device time of the kernels it launched
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        print("  torch.profiler recorded no device time")
        return
    busy_us = sum(r[0] for r in rows)
    print(f"  profiler: device busy {busy_us / n / 1e3:.3f} ms a {unit}, "
          f"{100 * busy_us / window_us:.1f}% of the {window_us / n / 1e3:.3f} ms "
          f"host window, {sum(r[2] for r in rows) / n:.0f} device kernels a "
          f"{unit} ({len(rows)} distinct)")
    for t, key, count in rows[:top]:
        print(f"    {t / n / 1e3:8.3f} ms/{unit}  {count // n:4d} calls/{unit}  {key[:90]}")


def _upcast(tree):
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    return tree.float()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def _decode_vs_prefill(model, params, prompts):
    """(relative error of decoding the last prompt token after prefilling
    the rest, against the whole prompt's prefill; that prefill's logits)."""
    from repro_torch.runtime.server import Server
    from repro_torch.runtime.steps import decode_step, prefill_step
    full, _ = prefill_step(model, params, {"tokens": prompts})
    _, cache = prefill_step(model, params, {"tokens": prompts[:, :-1]})
    cache = Server._grow_cache(cache, 1)
    last, _ = decode_step(model, params, cache, {"token": prompts[:, -1:]})
    return _rel(last, full), full


def _flash_probe(plain):
    """A dispatch mode over the model's ``repro_torch::flash_attention``
    calls, on the q, k, v the served model really makes.  ``plain=False``:
    run the kernel, hold each call's output to ``attention_ref`` row by row
    (``.rows``), and note how hard the layer's attention is (``.hardness``:
    the spread of q.k/sqrt(d) and the mean largest probability, over the
    last 128 queries of head 0).  ``plain=True``: answer every call with
    ``attention_ref``, so the model runs without the kernel."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.flash_attention import attention_ref

    class Probe(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows, self.hardness = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is not torch.ops.repro_torch.flash_attention.default:
                return func(*args, **kwargs)
            q, k, v = args[:3]
            mask = dict(zip(("causal", "window", "softcap"), args[3:]), **kwargs)
            ref = attention_ref(q, k, v, **mask)
            if plain:
                return ref
            out = func(*args, **kwargs)
            self.rows.append(_close_rows(out, ref, BF16_TOL))
            s, d = q.shape[2], q.shape[3]
            sc = (q[:, 0, -128:].float() @ k[:, 0].float().transpose(-1, -2)) / d ** 0.5
            sc = sc.masked_fill(torch.arange(s, device=q.device)[None, :]
                                > torch.arange(s - 128, s, device=q.device)[:, None],
                                float("-inf"))
            p_max = torch.softmax(sc, -1).amax(-1).mean()
            self.hardness.append((float(sc[sc.isfinite()].std()), float(p_max)))
            return out

    return Probe()


def serve_phase():
    """The serving path, as ``python -m repro_torch.launch.serve --arch
    llama3-8b --batch 4 --prompt-len 2048 --max-new 16`` runs it; then a
    warm repeat, a profile of one prefill and four decode steps, the bf16
    kernel held to attention_ref on every layer's served q, k, v, and the
    decode-against-prefill check."""
    import dataclasses

    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.kernels.winograd import winograd_conv, winograd_tiles
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.runtime.server import Server, ServeStats
    from repro_torch.runtime.steps import decode_step, prefill_step
    phase(f"9. main path: serve {SERVE_ARCH} FULL, batch {SERVE_BATCH}, prompt "
          f"{SERVE_PROMPT}, {SERVE_NEW} new tokens")
    torch.cuda.reset_peak_memory_stats()
    for kern in (tiled_matmul, winograd_conv, winograd_tiles, flash_attention_fwd):
        kern.launches = 0
    res = serve.run(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                    max_new=SERVE_NEW, device="cuda")
    launches = {"tiled_matmul": tiled_matmul.launches,
                "winograd_conv": winograd_conv.launches,
                "winograd_tiles": winograd_tiles.launches,
                "flash_attention": flash_attention_fwd.launches}
    torch.cuda.synchronize()
    server, model, params = res["server"], res["model"], res["params"]
    cfg = model.cfg
    stats = server.stats
    print(f"  main-path launches: {json.dumps(launches)}")
    print(f"  main path (first call): prefill {stats.prefill_s * 1e3:.1f} ms, "
          f"decode {stats.decode_tok_per_s:.1f} tok/s ({stats.tokens_out} tokens), "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(weights drawn on the card included)")
    check(launches["flash_attention"] >= cfg.num_layers,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"expected >= {cfg.num_layers} (one per layer of the prefill)")
    tokens = res["tokens"]
    check(tokens.shape[0] == SERVE_BATCH and 1 <= tokens.shape[1] <= SERVE_NEW,
          f"generated tokens have shape {tokens.shape}")
    check(0 <= tokens.min() and tokens.max() < cfg.vocab_size,
          f"generated tokens outside [0, {cfg.vocab_size})")

    # warm repeat of the same requests: serving time and peak memory alone
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    server.stats = ServeStats()
    server.generate({"tokens": res["prompts"]}, max_new_tokens=SERVE_NEW)
    warm = {"prefill_ms": server.stats.prefill_s * 1e3,
            "decode_tok_per_s": server.stats.decode_tok_per_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "weights_gb": sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9}
    print(f"  warm repeat: prefill {warm['prefill_ms']:.1f} ms, decode "
          f"{warm['decode_tok_per_s']:.1f} tok/s, peak memory "
          f"{warm['peak_gb']:.2f} GB ({warm['weights_gb']:.2f} GB of weights)")

    # where a warm prefill and a warm decode step spend the device's time
    prompts = res["prompts"]
    _profile("prefill", lambda: prefill_step(model, params, {"tokens": prompts}), 1,
             top=6)
    _, cache = prefill_step(model, params, {"tokens": prompts})
    state = {"cache": Server._grow_cache(cache, 4)}
    del cache

    def one_decode():
        state["cache"] = decode_step(model, params, state["cache"],
                                     {"token": prompts[:, -1:]})[1]

    _profile("decode step", one_decode, 4, top=6)
    del state

    # the bf16 kernel on the served model's own q, k, v, layer by layer
    probe = _flash_probe(plain=False)
    with probe:
        prefill_step(model, params, {"tokens": prompts})
    check(len(probe.rows) == cfg.num_layers,
          f"probe saw {len(probe.rows)} flash_attention calls, expected "
          f"{cfg.num_layers}")
    worst = max(r[1] for r in probe.rows)
    stds = sorted(h[0] for h in probe.hardness)
    pmax = sorted(h[1] for h in probe.hardness)
    print(f"  flash_attention on the served prefill's q, k, v (bf16, "
          f"{cfg.num_layers} layers): max_abs_err {max(r[0] for r in probe.rows):.3e}, "
          f"worst row {worst:.3e} of its max |ref| (tol {BF16_TOL})")
    print(f"  attention hardness over the layers (last 128 queries of head 0): "
          f"std of q.k/sqrt(d) {stds[0]:.1f} / {stds[len(stds) // 2]:.1f} / "
          f"{stds[-1]:.1f}, mean largest probability {pmax[0]:.3f} / "
          f"{pmax[len(pmax) // 2]:.3f} / {pmax[-1]:.3f} (min / median / max)")
    check(all(r[2] for r in probe.rows),
          f"flash_attention disagrees with attention_ref on the served "
          f"prefill's activations: worst row {worst} > {BF16_TOL}")

    # the kernel's prefill against the plain decode attention, at full width:
    # in bf16 with the kernel, in bf16 without it (the witness of how far
    # bf16 rounding alone carries through this model), and in fp32
    rel_bf16, logits = _decode_vs_prefill(model, params, prompts)
    check(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    with _flash_probe(plain=True):
        rel_plain, logits_plain = _decode_vs_prefill(model, params, prompts)
    rel_paths = _rel(logits, logits_plain)
    del logits, logits_plain
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _upcast(params)
    rel_f32, _ = _decode_vs_prefill(build_model(cfg32), params32, prompts)
    del params32
    torch.cuda.empty_cache()
    print(f"  decode of token {SERVE_PROMPT - 1} after a prefill of "
          f"{SERVE_PROMPT - 1} vs the prefill of {SERVE_PROMPT}, last logits, "
          f"relative error: {rel_f32:.3e} in fp32 (the same weights; tol "
          f"{BF16_TOL}); in bf16 (not checked: see PERF.md) {rel_bf16:.3e} "
          f"with the kernel, {rel_plain:.3e} with attention_ref in its place; "
          f"the two bf16 prefills' logits differ by {rel_paths:.3e}")
    check(rel_f32 <= BF16_TOL,
          f"fp32 decode vs prefill relative error {rel_f32} > {BF16_TOL}")
    return res, launches


def _analytic_dot_flops(cfg, b, n, t):
    """The products of one prefill (n = t) or decode (n = 1) step, as the
    capture emits them (full n x t attention products)."""
    from repro_torch.models.layers import pad_vocab
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    layer = (2 * b * n * d * (h + 2 * kv) * hd + 2 * b * n * h * hd * d
             + 3 * 2 * b * n * d * cfg.d_ff + 2 * 2 * b * h * n * t * hd)
    return cfg.num_layers * layer + 2 * b * d * pad_vocab(cfg.vocab_size)


def serve_sim_phase(res):
    """Capture the full-width prefill and decode steps and simulate them on
    the ``h100`` spec (``examples/serve_llm.py``'s view of serving)."""
    import torch
    from repro_torch.core import H100, Simulator
    from repro_torch.lenet_repro import summary_lines
    from repro_torch.runtime.steps import decode_step, prefill_step
    phase("10. capture + simulate the full-width prefill and decode steps (h100)")
    model, params, prompts = res["model"], res["params"], res["prompts"]
    cfg = model.cfg
    b, s = prompts.shape
    total = s + SERVE_NEW
    kv_shape = (cfg.num_layers, b, total, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.empty(kv_shape, dtype=torch.bfloat16, device="cuda"),
             "v": torch.empty(kv_shape, dtype=torch.bfloat16, device="cuda"),
             "pos": s}
    sim = Simulator(hw=H100)
    caps = {"prefill": sim.capture(lambda p, bt: prefill_step(model, p, bt),
                                   params, {"tokens": prompts}, name="prefill"),
            "decode": sim.capture(lambda p, c, bt: decode_step(model, p, c, bt),
                                  params, cache, {"token": prompts[:, :1]},
                                  name="decode")}
    del cache
    out = {}
    for kind, cap in caps.items():
        rep = sim.performance(cap)
        m = cap.module
        dot_flops = sum(sc * m.op_flops(c, o)["mxu"] for o, c, sc in m.walk_entry())
        n, t = (s, s) if kind == "prefill" else (1, total)
        want = _analytic_dot_flops(cfg, b, n, t)
        print(f"  captured {kind}: {len(m.comp(m.entry).ops)} ops in "
              f"{cap.capture_seconds:.2f}s, dot FLOPs {dot_flops:.4e} "
              f"(analytic {want:.4e})")
        for line in summary_lines(f"{SERVE_ARCH} {kind} b{b} s{s}", rep):
            print(line)
        check(dot_flops == want, f"{kind} capture counts {dot_flops} dot FLOPs, "
                                 f"expected {want}")
        secs = rep.summary()["total_seconds"]
        check(secs > 0 and math.isfinite(secs), f"bad simulated {kind} time {secs}")
        out[kind] = secs
    print(f"  modeled decode step: {out['decode'] * 1e6:.1f} us "
          f"({b / out['decode']:.0f} tok/s on one chip); modeled prefill "
          f"{out['prefill'] * 1e3:.2f} ms")
    return out


def flash_timing_phase(launches, flash_err):
    """One llama3-8b layer's prefill attention at the serving shape: the
    kernel, its plain version and SDPA (the library yardstick, never on the
    path), beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_fwd
    phase("11. timing of flash_attention at the serving shape (CUDA events)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, h, kv, s, d = SERVE_BATCH, 32, 8, SERVE_PROMPT, 128
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for n in (h, kv, kv))
    flops = 0.5 * 4.0 * b * h * s * s * d         # causal: half of QK^T and PV
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    t_k = _time_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    t_d = _device_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    t_p = _time_ms(lambda: attention_ref(q, k, v, causal=True), reps=5, warmup=1)
    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    t_l = _time_ms(sdpa)
    t_ld = _device_ms(sdpa)
    bound, by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"  flash_attention q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal: "
          f"kernel {t_k:.4f} ms ({flops / t_k / 1e9:.1f} TFLOP/s; {_fmt_ms(t_d)} on "
          f"the device), plain {t_p:.4f} ms, SDPA {t_l:.4f} ms ({_fmt_ms(t_ld)} on the "
          f"device), bound {bound * 1e3:.2f} us ({by})")

    # the fp32 instance, left on the CUDA cores, at a quarter of the batch
    b32 = 1
    q32, k32, v32 = (x[:b32].float() for x in (q, k, v))
    f32_flops = flops * b32 / b
    f32_bytes = 4.0 * (2 * q32.numel() + k32.numel() + v32.numel())
    t32 = _time_ms(lambda: flash_attention_fwd(q32, k32, v32, causal=True), reps=5)
    t32_d = _device_ms(lambda: flash_attention_fwd(q32, k32, v32, causal=True), n=3)
    t32_l = _time_ms(lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True, enable_gqa=True), reps=5)
    b32_bound, b32_by = _bound(f32_flops, f32_bytes, PEAK_F32_FLOPS)
    print(f"  flash_attention q {tuple(q32.shape)} fp32 causal (CUDA cores): kernel "
          f"{t32:.4f} ms ({f32_flops / t32 / 1e9:.1f} TFLOP/s; {_fmt_ms(t32_d)} on the "
          f"device), SDPA {t32_l:.4f} ms, bound {b32_bound * 1e3:.2f} us ({b32_by}, "
          f"fp32 at 67 TFLOP/s)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
            "launches": launches["flash_attention"], "max_abs_err": flash_err,
            "ms": t_k, "device_ms": t_d, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": by, "library_ms": t_l, "library_device_ms": t_ld,
            "unit": f"one llama3-8b layer's prefill attention, b{b} h{h} kv{kv} "
                    f"s=t={s} d{d} bf16 causal",
            "fp32": {"ms": t32, "device_ms": t32_d, "library_ms": t32_l,
                     "bound_ms": b32_bound, "bound_by": b32_by,
                     "unit": f"b{b32} h{h} kv{kv} s=t={s} d{d} fp32 causal"}}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: FAIL: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        import torch
        name = device_phase()
        build_phase()
        mm_err = matmul_phase()
        wino_errs = winograd_phase()
        flash_err = flash_phase()
        launches, pps = main_path_phase()
        kernels = timing_phase(launches, pps, mm_err, wino_errs)
        step_phase()
        res, serve_launches = serve_phase()
        serve_sim_phase(res)
        del res
        kernels.append(flash_timing_phase(serve_launches, flash_err))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print("kernels: " + "; ".join(
        f"{k['name']} launches={k['launches']} max_abs_err={k['max_abs_err']:.2e} "
        f"ms={k['ms']:.4f} device_ms={k['device_ms']} plain_ms={k['plain_ms']:.4f} "
        f"library_ms={k['library_ms']:.4f} bound_us={k['bound_ms'] * 1e3:.2f} "
        f"({k['bound_by']})" for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
