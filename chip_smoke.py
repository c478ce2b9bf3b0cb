#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, then drives the port's
main path — ``repro_torch.lenet_repro.run``: train LeNet (full width, batch
128, 60 SGD steps), capture and simulate one step on the ``h100`` spec, and
the section V conv-algorithm loop — with every kernel's launch count set to
0 just before and read just after.  Then it times each kernel, its plain
version and the one PyTorch library call that computes the same function,
beside the card's bound for the same work, and the steady-state training
step with its device time by kernel.

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
HBM_BYTES_PER_S = 3.35e12

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
    return worst


def winograd_phase():
    import torch
    from repro_torch.kernels.winograd import (conv3x3_ref, conv3x3_winograd,
                                              winograd_tiles, winograd_tiles_ref)
    from repro_torch.lenet_repro import CASE_W, CASE_X
    phase("4. winograd_tiles against winograd_tiles_ref and conv3x3_ref")
    gen = torch.Generator(device="cuda").manual_seed(1)
    case_err = None
    cases = [(CASE_X, CASE_W, "SAME"), (CASE_X, CASE_W, "VALID"),
             ((8, 28, 28, 64), (3, 3, 64, 64), "SAME")]
    for xs, ws, pad in cases:
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda")
        # the tiling conv3x3_winograd hands the kernel: 2x2 outputs a tile
        oh, ow = (xs[1], xs[2]) if pad == "SAME" else (xs[1] - 2, xs[2] - 2)
        tiles = torch.randn(xs[0], (oh + 1) // 2, (ow + 1) // 2, 4, 4, xs[3],
                            generator=gen, device="cuda")
        u = torch.randn(4, 4, ws[2], ws[3], generator=gen, device="cuda")
        y = winograd_tiles(tiles, u)
        torch.cuda.synchronize()
        err_t, ok_t = _close(y, winograd_tiles_ref(tiles, u), F32_TOL)
        # the transform's extra roundings against a direct conv: Winograd
        # F(2x2,3x3) amplifies fp32 rounding by the transforms' ~4x growth
        err_c, ok_c = _close(conv3x3_winograd(x, w, pad),
                             conv3x3_ref(x, w, pad), 4 * F32_TOL)
        print(f"  x {xs} w {ws} {pad}: tiles {tuple(tiles.shape)} max_abs_err "
              f"{err_t:.3e} (tol {F32_TOL}), conv max_abs_err {err_c:.3e} "
              f"(tol {4 * F32_TOL})")
        check(ok_t, f"winograd_tiles disagrees with winograd_tiles_ref at "
                    f"tiles {tuple(tiles.shape)}")
        check(ok_c, f"conv3x3_winograd disagrees with conv3x3_ref at {xs} {pad}")
        if (xs, ws, pad) == (CASE_X, CASE_W, "SAME"):
            case_err = err_t
    return case_err


def main_path_phase():
    import torch
    from repro_torch import lenet_repro
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.kernels.winograd import winograd_tiles
    phase("5-6. main path: train LeNet, capture + simulate, SS V loop")
    tiled_matmul.launches = 0
    winograd_tiles.launches = 0
    res = lenet_repro.run(device="cuda", hw="h100")
    launches = {"tiled_matmul": tiled_matmul.launches,
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
    check(launches["winograd_tiles"] > 0, "winograd_tiles never launched")
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


def _bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def timing_phase(launches, products_per_step, mm_err, wino_err):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.tiled_matmul import matmul_ref, tiled_matmul
    from repro_torch.kernels.winograd import winograd_tiles, winograd_tiles_ref
    from repro_torch.lenet_repro import CASE_W, CASE_X
    phase("7. timing (CUDA events, TF32 off)")
    gen = torch.Generator(device="cuda").manual_seed(2)
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
        t_p = _time_ms(lambda: matmul_ref(a, b))
        t_l = _time_ms(lambda: torch.matmul(a, b))
        bound, by = _bound(f, nb, PEAK_F32_FLOPS)
        rows.append({"product": label, "m": m, "k": k, "n": n, "ms": t_k,
                     "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
                     "bound_by": by})
        print(f"  tiled_matmul {label} ({m}x{k})@({k}x{n}): kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, torch.matmul {t_l:.4f} ms, bound "
              f"{bound * 1e3:.2f} us ({by})")
    mm_bound, mm_by = _bound(flops, nbytes, PEAK_F32_FLOPS)
    mm = {"name": "tiled_matmul", "route": "cuda",
          "source": "src/repro_torch/csrc/tiled_matmul.cu",
          "replaces": "src/repro/kernels/tiled_matmul/kernel.py:35",
          "launches": launches["tiled_matmul"], "max_abs_err": mm_err,
          "ms": sum(r["ms"] for r in rows),
          "plain_ms": sum(r["plain_ms"] for r in rows),
          "bound_ms": mm_bound, "bound_by": mm_by,
          "library_ms": sum(r["library_ms"] for r in rows),
          "unit": f"the {products_per_step} products of one LeNet-full "
                  "training step (batch 128)"}

    x = torch.randn(CASE_X, generator=gen, device="cuda")
    w = torch.randn(CASE_W, generator=gen, device="cuda")
    b_, h, w_, cin = CASE_X
    cout = CASE_W[3]
    tiles = torch.randn(b_, h // 2, w_ // 2, 4, 4, cin, generator=gen, device="cuda")
    u = torch.randn(4, 4, cin, cout, generator=gen, device="cuda")
    n_tiles = b_ * (h // 2) * (w_ // 2)
    w_flops = (2.0 * 16 * n_tiles * cin * cout   # the 16 contractions
               + 32.0 * n_tiles * cin            # B^T d B adds
               + 24.0 * n_tiles * cout)          # A^T M A adds
    w_bytes = 4.0 * (tiles.numel() + u.numel() + n_tiles * 4 * cout)
    t_k = _time_ms(lambda: winograd_tiles(tiles, u))
    t_p = _time_ms(lambda: winograd_tiles_ref(tiles, u))
    xn, wn = x.permute(0, 3, 1, 2).contiguous(), w.permute(3, 2, 0, 1).contiguous()
    t_l = _time_ms(lambda: F.conv2d(xn, wn, padding=1))
    wb, wby = _bound(w_flops, w_bytes, PEAK_F32_FLOPS)
    print(f"  winograd_tiles tiles {tuple(tiles.shape)} u {tuple(u.shape)}: "
          f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, F.conv2d {t_l:.4f} ms, "
          f"bound {wb * 1e3:.2f} us ({wby})")
    wino = {"name": "winograd_tiles", "route": "cuda",
            "source": "src/repro_torch/csrc/winograd.cu",
            "replaces": "src/repro/kernels/winograd/kernel.py:46",
            "launches": launches["winograd_tiles"], "max_abs_err": wino_err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": wb, "bound_by": wby,
            "library_ms": t_l,
            "unit": "the SS V case study, x (64,28,28,16) w (3,3,16,32) SAME"}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_products.json").write_text(json.dumps(rows, indent=1))
    return [mm, wino]


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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            one_step()
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
        return step_ms
    busy_us = sum(r[0] for r in rows)
    print(f"  profiler: device busy {busy_us / 5 / 1e3:.3f} ms a step, "
          f"{100 * busy_us / window_us:.1f}% of the {window_us / 5 / 1e3:.3f} ms "
          f"host window, {len(rows)} distinct device kernels")
    for t, key, count in rows[:10]:
        print(f"    {t / 5 / 1e3:8.3f} ms/step  {count // 5:4d} calls/step  {key[:90]}")
    return step_ms


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
        wino_err = winograd_phase()
        launches, pps = main_path_phase()
        kernels = timing_phase(launches, pps, mm_err, wino_err)
        step_phase()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print("kernels: " + "; ".join(
        f"{k['name']} launches={k['launches']} max_abs_err={k['max_abs_err']:.2e} "
        f"ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
        f"library_ms={k['library_ms']:.4f} bound_us={k['bound_ms'] * 1e3:.2f} "
        f"({k['bound_by']})" for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
