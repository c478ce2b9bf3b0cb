#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card (flash attention at head
dims 16 to 256), then drives the port's three paths, each with every
kernel's launch count set to 0 just before and read just after:

* LeNet — ``repro_torch.lenet_repro.run``, the paper's experiments: train
  LeNet (full width, batch 128, 60 SGD steps, the step replayed as a CUDA
  graph), capture and simulate one
  step on the ``h100`` spec and correlate it per op class against the
  card's own kernel times for the captured program, the power model, the
  section V conv-algorithm loop, the phase analysis and the memory model;
* serving — ``repro_torch.launch.serve.run``: llama3-8b at its full config
  (32 layers, bf16, random weights from seed 0) serves batch 4 x 2048-token
  prompts for 16 new tokens, prefill attention in the flash kernel, the
  prefill and decode steps replayed as CUDA graphs (``StepBundle.jit``, as
  every served family below: a replay adds the launches its capture
  recorded to each kernel's count); then the
  kernel is held to its plain version on each layer's served q, k, v, the
  prefill against the plain decode attention at full width, and the
  prefill and decode steps are captured and simulated on ``h100``; the
  llama3-8b smoke config (head_dim 16) and gemma3-12b at its full config
  (48 layers, head_dim 256, window 1024 on 5 of every 6 layers) serve too;
* training — qwen1.5-4b at its full config (40 layers, bf16 params with
  fp32 master, m and v on the card) at train_4k's sequence length, batch
  6 (the largest that fits), 3 AdamW steps through ``train_bundle``,
  ``init_train_state`` and ``DataPipeline`` (phase 15); the step captured
  from abstract inputs and simulated (16); 2 of its layers in fp32 through
  the kernel against attention_ref in its place (17); and the ``Trainer``
  with an injected failure, restoring from its checkpoint on the card, and
  ``python -m repro_torch.launch.train --smoke`` (18);
* the other model families — ``launch.serve.run`` on the same requests:
  qwen3-moe-30b-a3b FULL (61 GB of bf16 weights, 128 experts; phase 19)
  with the flash kernel held to attention_ref at GQA group 8, ``moe_ffn``
  held to an independent plain version in fp32, and the served model's
  first 2 layers in fp32 against the CPU; zamba2-7b, internvl2-2b,
  rwkv6-1.6b and seamless-m4t-large-v2 FULL (20), the flash kernel held to
  attention_ref on every served call (head dim 112, the encoder's
  non-causal attention, cross-attention at s = 2048 and s = 1 against 1024
  frames); every new arch's smoke config, also as ``python -m
  repro_torch.launch.serve --arch <arch> --smoke`` (21);
* the distributed layer — a one-rank NCCL process group and a (1, 1)
  data x model mesh (``build_mesh``): one llama3-8b smoke train step through
  the sharded ``train_bundle`` against the plain step from the same state;
  qwen1.5-4b FULL trained by ``Trainer(rc, use_mesh=True)`` at seq 4096 and
  the largest batch that fits, the flash kernel reached through
  ``local_map`` on each rank's heads; ``quantize_int8``,
  ``compressed_psum_mean`` over the NCCL group and ``pipeline_apply`` at one
  stage (22); then ``python -m repro_torch.launch.dryrun`` as subprocesses on
  the host for llama3-8b decode_32k and dbrx-132b train_4k (depth and
  microbatches extrapolated from 4 cut traces) on the 256-rank mesh (23).
  NCCL takes one rank a card, so the semantics of several ranks are held
  on the CPU (gloo, ``tests/test_torch_distributed.py``).
* the fleet layers (host work beside the card) — ``python -m
  repro_torch.cluster --cost capture --devices 4xh100`` on the default
  40-job trace, each class's smoke train step captured on cuda fake
  tensors, plain, with failures and checkpoints, and with the time-lapse,
  doctor, validate and manifest outputs, and ``python -m
  repro_torch.cluster_quickstart --capture`` (24); ``python -m
  repro_torch.analysis lenet --full`` with ``--timelapse``, ``--doctor``,
  ``--manifest`` and ``--spans``, ``python -m repro_torch.obs diff`` and
  ``doctor`` (25); ``python -m repro_torch.validate`` on the committed
  Alibaba fixture under SJF (26).
* the compiled steps (27) — llama3-8b FULL served graphed and under
  ``disable_jit`` (the same tokens; the prefill's and the first decode
  step's logits bit for bit; warm prefill ms, decode tok/s and busy share
  in both modes; 32 flash launches inside the prefill's graph), the
  LeNet-full step graphed and eager from one state (params bit-equal after
  each of 10 steps; 14 ``tiled_matmul`` launches inside the graph), and
  qwen3-moe-30b-a3b FULL's peak served graphed (phase 19) beside eager.

Then it times each kernel (fp32, bf16 and fp16), its plain version and the
one PyTorch library call that computes the same function, beside the card's
bound for the same work, and the steady-state LeNet training step with its
device time by kernel.  The last three phases read the paper's analysis
path on the card: the correlation table (Fig. 6/7) of the LeNet step and of
the full-width prefill against the card's kernel times (phase 12),
``nvidia-smi``'s power draw idle and under both workloads beside the power
model (phase 13, Fig. 8), and the phase analysis, the vision view, the
differential debugger (clean and with a planted bf16 rounding) and
``python -m repro_torch.analysis`` (phase 14).  Phases 12 and 13 also write
``chiprun_out/chip_smoke_analysis.json``.

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
# gemma3-12b FULL on the same requests: 48 layers, d 256, window 1024 on 5
# of every 6 layers
GEMMA_ARCH = "gemma3-12b"
# the training path: qwen1.5-4b FULL at train_4k's sequence length, bf16
# params with fp32 state, 3 AdamW steps at batch 6, cut from train_4k's 256:
# the largest that fits on an 80 GB H100 (66.65 GB at batch 1, 2.43 GB a
# sequence; batch 6 peaks at 79.10 GB, see PERF.md)
TRAIN_ARCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_BATCH = "qwen1.5-4b", 4096, 3, 6

F32_TOL = 1e-4
BF16_TOL = 2e-2
# fp16: a little over one fp16 ulp (2**-10 = 9.77e-4) of the output's scale.
# A kernel that accumulates in fp32 and rounds once differs from the plain
# version by at most one ulp; the plain version on operands rounded to bf16
# misses by 1.5e-3 to 4e-3 at the main path's shapes, and is held to fail it
F16_TOL = 1.2e-3


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_START = time.perf_counter()


def phase(title: str) -> None:
    print(f"== {title} == ({time.perf_counter() - _START:.1f} s in)", flush=True)


def _bf16(t):
    """``t`` rounded to bf16 and back: the control that the fp16 limit
    must reject."""
    return t.bfloat16().to(t.dtype)


#: the card's name and power limit, as nvidia-smi gives them (phase 1)
CARD = ""


def device_phase():
    global CARD
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    idle = _power_draw(None, 3.0)      # before this process runs anything
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    phase("1. device")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}")
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    print(f"  power.draw before any work: {len(idle)} samples, mean "
          f"{sum(idle) / len(idle):.1f} W (min {min(idle):.1f}, max {max(idle):.1f})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, idle


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
    # (UTMALDG) in every bf16 and fp16 flash instance, cp.async (LDGSTS) in
    # tiled_matmul
    counts = sass_counts("flash_attention", "attn_wgmma_kernel", ("HGMMA", "UTMALDG"))
    check(len(counts) == 12, f"expected 12 wgmma flash instances (bf16 and fp16 at d 16, "
                             f"32, 64, 112, 128, 256), found {len(counts)}")
    check(all(c[op] > 0 for c in counts.values() for op in c),
          "a 16-bit flash instance has no HGMMA or no UTMALDG")
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
    cases.append(("ragged 257x129x65 fp16", a.half(), b.half(), F16_TOL, None))
    a = torch.randn(256, 256, generator=gen, device="cuda")
    b = torch.randn(256, 256, generator=gen, device="cuda")
    for cfg in BLOCK_CONFIGS:
        cases.append((f"sweep 256^3 block {cfg}", a, b, F32_TOL, cfg))
    # split-K: the weight gradients in bf16, and a K (5000) that is not a
    # multiple of splits * block_k (16 splits of 5 slabs of 64, the last ragged)
    # every LeNet product in fp16 too
    for label, a, b in lenet_step_products(gen, "cuda"):
        cases.append((f"fp16 {label} {tuple(a.shape)}@{tuple(b.shape)}", a.half(), b.half(),
                      F16_TOL, None))
        if label in ("dw0", "dw1"):
            cases.append((f"split-K {label} bf16", a.bfloat16(), b.bfloat16(), BF16_TOL, None))
    a = torch.randn(64, 5000, generator=gen, device="cuda")
    b = torch.randn(5000, 32, generator=gen, device="cuda")
    cases.append(("ragged split-K 64x5000x32 f32", a, b, F32_TOL, None))
    cases.append(("ragged split-K 64x5000x32 bf16", a.bfloat16(), b.bfloat16(), BF16_TOL, None))
    cases.append(("ragged split-K 64x5000x32 fp16", a.half(), b.half(), F16_TOL, None))
    for label, a, b, tol, cfg in cases:
        kw = {} if cfg is None else dict(block_m=cfg[0], block_n=cfg[1],
                                         block_k=cfg[2])
        out = tiled_matmul(a, b, **kw)
        torch.cuda.synchronize()
        err, ok = _close(out, matmul_ref(a, b), tol)
        line = f"  {label}: max_abs_err {err:.3e} (tol {tol})"
        if label.startswith("fp16 "):       # a LeNet product: the bf16 control
            err_b, ok_b = _close(matmul_ref(_bf16(a), _bf16(b)), matmul_ref(a, b), tol)
            check(not ok_b, f"the fp16 limit passes {label} on operands rounded to "
                            f"bf16 (max_abs_err {err_b})")
            line += f"; on operands rounded to bf16 {err_b:.3e}, over the limit"
        print(line)
        check(ok and out.dtype == a.dtype, f"tiled_matmul disagrees with matmul_ref on {label}")
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
    version, the tiles entry against winograd_tiles_ref, both in bf16 and
    fp16, the bits of a second call, the compiled kernel's shared memory
    against the plan's, and the tensor-core products (HMMA) and cp.async copies
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
    bf16, f16 = torch.bfloat16, torch.float16
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
            half = {}
            for dt, tol in ((bf16, BF16_TOL), (f16, F16_TOL)):
                xh, wh = x.to(dt), w.to(dt)
                yh = conv3x3_winograd(xh, wh, pad)
                ref_h = conv3x3_winograd_ref(xh, filter_transform(wh, dt), pad)
                err_h, ok_h = _close(yh, ref_h, tol)
                check(yh.dtype == dt and ok_h, f"{dt} winograd_conv disagrees at {xs} {pad}")
                half[dt] = err_h
            if xs == CASE_X:          # the bf16 control of the fp16 limit (dt is fp16)
                err_b, ok_b = _close(conv3x3_winograd_ref(_bf16(xh), filter_transform(
                    _bf16(wh), f16), pad), ref_h, F16_TOL)
                check(not ok_b, f"the fp16 limit passes the case study on operands "
                                f"rounded to bf16 (max_abs_err {err_b})")
                print(f"  conv x {xs} {pad} fp16 on operands rounded to bf16: "
                      f"max_abs_err {err_b:.3e}, over the limit")
            print(f"  conv x {xs} w {ws} {pad}: vs conv3x3_ref {err_c:.3e} (tol "
                  f"{4 * F32_TOL}), vs conv3x3_winograd_ref {err_p:.3e} (tol {F32_TOL}); "
                  f"bf16 {half[bf16]:.3e} (tol {BF16_TOL}), fp16 {half[f16]:.3e} "
                  f"(tol {F16_TOL})")
            check(ok_c, f"winograd_conv disagrees with conv3x3_ref at {xs} {pad}")
            check(ok_p, f"winograd_conv disagrees with conv3x3_winograd_ref at {xs} {pad}")
            if (xs, pad) == (CASE_X, "SAME"):
                errs["conv"] = err_p
        # the tiles entry on the tiles this conv's SAME tiling gives
        tiles = torch.randn(xs[0], (xs[1] + 1) // 2, (xs[2] + 1) // 2, 4, 4, xs[3],
                            generator=gen, device="cuda")
        yt = winograd_tiles(tiles, u)
        err_t, ok_t = _close(yt, winograd_tiles_ref(tiles, u), F32_TOL)
        half = {}
        for dt, tol in ((bf16, BF16_TOL), (f16, F16_TOL)):
            th, uh = tiles.to(dt), u.to(dt)
            err_th, ok_th = _close(winograd_tiles(th, uh), winograd_tiles_ref(th, uh), tol)
            check(ok_th, f"{dt} winograd_tiles disagrees at {tuple(tiles.shape)}")
            half[dt] = err_th
        print(f"  tiles {tuple(tiles.shape)} u {tuple(u.shape)}: max_abs_err {err_t:.3e} "
              f"(tol {F32_TOL}); bf16 {half[bf16]:.3e} (tol {BF16_TOL}), fp16 "
              f"{half[f16]:.3e} (tol {F16_TOL})")
        check(ok_t, f"winograd_tiles disagrees with winograd_tiles_ref at {tuple(tiles.shape)}")
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
        for dtype, tol in ((torch.float32, F32_TOL), (bf16, BF16_TOL), (f16, F16_TOL)):
            x, u = view(big.to(dtype)), filter_transform(w, dtype)
            check(x.stride(3) == 1 and not x.is_contiguous(), "strided x is contiguous")
            for pad in ("SAME", "VALID"):
                err, ok = _close(winograd_conv(x, u, pad),
                                 conv3x3_winograd_ref(x, u, pad), tol)
                check(ok, f"winograd_conv on a strided x ({label}, {dtype}, {pad}): "
                          f"max_abs_err {err}")
        print(f"  strided x {tuple(x.shape)} strides {x.stride()} ({label}): fp32, "
              f"bf16 and fp16, SAME and VALID agree")
    for dtype in (torch.float32, bf16, f16):
        for image in (True, False):
            check(kernel_smem_bytes(dtype, image) == smem_bytes(dtype, image),
                  f"the plan's shared memory differs from the kernel's ({dtype}, {image})")
    counts = sass_counts("winograd", "wino_kernel", ("HMMA", "LDGSTS"))
    check(len(counts) == 6, f"expected 6 winograd instances (fp32, bf16 and fp16, image "
                            f"and tiles), found {len(counts)}")
    check(all(c["HMMA"] > 0 for c in counts.values()), "a winograd instance has no HMMA")
    return errs


def flash_phase():
    """The flash kernel against attention_ref: the serving slice's shape
    (one llama3-8b layer's prefill attention, handed in as the model's
    (b, s, heads, d) views), a ragged length, the masks and head dims
    llama3-8b does not use, at small sizes, and head dims 16, 112 and 256
    in every dtype.  Each row is held to its own scale (``_close_rows``)."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_fwd
    phase("5. flash_attention against attention_ref")
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f16 = torch.bfloat16, torch.float16
    cases = [  # label, (b, h, kv, s, t, d), dtype, causal, window, softcap
        ("slice b4 h32 kv8 s=t=2048 d128 bf16 causal", (4, 32, 8, 2048, 2048, 128),
         bf16, True, 0, 0.0),
        ("slice b4 h32 kv8 s=t=2048 d128 fp16 causal", (4, 32, 8, 2048, 2048, 128),
         f16, True, 0, 0.0),
        ("ragged s=t=2000 d128 fp16 causal", (1, 32, 8, 2000, 2000, 128),
         f16, True, 0, 0.0),
        ("window 64 softcap 30 d64 fp16", (2, 8, 2, 500, 500, 64), f16, True, 64, 30.0),
        ("non-causal s=200 t=333 d32 fp16", (2, 4, 4, 200, 333, 32), f16, False, 0, 0.0),
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
    # head dims 16 (every smoke config), 112 (zamba2-7b) and 256 (gemma3-12b):
    # each in the three dtypes, causal and windowed, with and without the
    # softcap, with ragged s and t
    f32 = torch.float32
    for d in (16, 112, 256):
        w = 1024 if d == 256 else 64
        cases += [
            (f"d{d} bf16 causal ragged s=t=1000", (2, 16, 8, 1000, 1000, d), bf16, True, 0, 0.0),
            (f"d{d} fp16 causal window {w} softcap 30 ragged s=t=1500", (1, 16, 8, 1500, 1500, d),
             f16, True, w, 30.0),
            (f"d{d} f32 non-causal s=200 t=333", (2, 4, 2, 200, 333, d), f32, False, 0, 0.0),
            (f"d{d} bf16 non-causal window 64 softcap 30 s=300 t=277", (1, 8, 4, 300, 277, d),
             bf16, False, 64, 30.0),
            (f"d{d} f32 causal window 64 softcap 30 s=t=300", (1, 4, 4, 300, 300, d),
             f32, True, 64, 30.0),
            (f"d{d} fp16 causal ragged s=t=777", (1, 8, 2, 777, 777, d), f16, True, 0, 0.0),
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
        tol = {bf16: BF16_TOL, f16: F16_TOL}.get(dtype, F32_TOL)
        ref = attention_ref(q, k, v, **kw)
        err, worst, ok = _close_rows(out, ref, tol)
        print(f"  {label}: max_abs_err {err:.3e}, worst row {worst:.3e} of its "
              f"max |ref| (tol {tol})")
        if label.startswith("slice") and dtype == f16:   # the bf16 control
            _, worst_b, ok_b = _close_rows(attention_ref(_bf16(q), _bf16(k), _bf16(v), **kw),
                                           ref, tol)
            check(not ok_b, f"the fp16 limit passes {label} on q, k, v rounded to bf16 "
                            f"(worst row {worst_b})")
            print(f"  {label} on q, k, v rounded to bf16: worst row {worst_b:.3e}, "
                  f"over the limit")
        check(ok and out.dtype == dtype,
              f"flash_attention disagrees with attention_ref on {label}")
        if label.startswith("slice") and dtype == bf16:
            slice_err = err
    # rows that see no key (from t + window - 1 on): the kernel refuses them,
    # and the op runs it on the rows before and gives the rest attention_ref's
    # value, the mean of v over the t keys
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import first_keyless_row
    for (b, h, kv, sq, t, d), dtype, causal, window in (
            ((2, 8, 2, 300, 100, 64), bf16, True, 64), ((1, 4, 4, 200, 150, 128), f32, False, 32),
            ((1, 8, 2, 64, 40, 16), f16, True, 8)):
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
        k = torch.randn(b, t, kv, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
        v = torch.randn(b, t, kv, d, generator=gen, device="cuda").to(dtype).transpose(1, 2)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = {bf16: BF16_TOL, f16: F16_TOL}.get(dtype, F32_TOL)
        err, worst, ok = _close_rows(out, attention_ref(q, k, v, causal=causal, window=window),
                                     tol)
        first = first_keyless_row(sq, t, window)
        print(f"  rows without a key, s={sq} t={t} window {window} d{d} {dtype} "
              f"{'causal' if causal else 'non-causal'} (rows {first}..{sq - 1} see none): "
              f"max_abs_err {err:.3e}, worst row {worst:.3e} (tol {tol})")
        check(ok and first < sq, f"the op's rows without a key disagree with attention_ref "
                                 f"at s={sq} t={t} window {window}")
    return slice_err


def main_path_phase():
    import torch
    from repro_torch import lenet_repro
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.kernels.winograd import winograd_conv, winograd_tiles
    phase("6. main path: the paper's LeNet experiments (train; capture, simulate and "
          "correlate; power; SS V loop; phases; memory)")
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
    return launches, products_per_step, res


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
    # the same 14 products in fp16 (the kernel converts to fp32 on load)
    f16_ms = _total([_device_ms(lambda: tiled_matmul(a16, b16)) for a16, b16 in
                     ((a.half(), b.half()) for _, a, b in prods)])
    f16_lib = _total([_device_ms(lambda: torch.matmul(a16, b16)) for a16, b16 in
                      ((a.half(), b.half()) for _, a, b in prods)])
    lib_ms = _total([r["library_device_ms"] for r in rows])
    f16_bound, f16_by = _bound(flops, nbytes / 2, PEAK_F32_FLOPS)
    print(f"  tiled_matmul fp16, the {len(prods)} products: {_fmt_ms(f16_ms)} on the device, "
          f"bound {f16_bound * 1e3:.2f} us ({f16_by})")
    print(f"  torch.matmul, the {len(prods)} products: fp32 {_fmt_ms(lib_ms)}, fp16 "
          f"{_fmt_ms(f16_lib)} on the device")
    mm_bound, mm_by = _bound(flops, nbytes, PEAK_F32_FLOPS)
    mm = {"name": "tiled_matmul", "route": "cuda",
          "source": "src/repro_torch/csrc/tiled_matmul.cu",
          "replaces": "src/repro/kernels/tiled_matmul/kernel.py:35",
          "launches": launches["tiled_matmul"], "max_abs_err": mm_err,
          "ms": sum(r["ms"] for r in rows),
          "device_ms": _total([r["device_ms"] for r in rows]),
          "plain_ms": sum(r["plain_ms"] for r in rows),
          "bound_ms": mm_bound, "bound_by": mm_by,
          "library_ms": sum(r["library_ms"] for r in rows), "library_device_ms": lib_ms,
          "unit": f"the {products_per_step} products of one LeNet-full "
                  "training step (batch 128)",
          "fp16": {"device_ms": f16_ms, "bound_ms": f16_bound, "bound_by": f16_by,
                   "library_device_ms": f16_lib}}

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
        xh, uh = x.half(), filter_transform(w, torch.float16)
        xhl, whl = xcl.half(), wcl.half()
        r["fp16"] = {"device_ms": _device_ms(lambda: winograd_conv(xh, uh, "SAME")),
                     "library_device_ms": _device_ms(lambda: F.conv2d(xhl, whl, padding=1)),
                     "bound_ms": r["bf16"]["bound_ms"], "bound_by": r["bf16"]["bound_by"]}
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
        print(f"    fp16: winograd_conv {_fmt_ms(r['fp16']['device_ms'])} on the device, "
              f"F.conv2d channels_last {_fmt_ms(r['fp16']['library_device_ms'])}; same bound")
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
    busy_ms = _profile("step", one_step, 5)
    return {"step_ms": step_ms, "busy_ms": busy_ms, "one_step": one_step}


def _profile(unit, fn, n, top=10, host_ops=True, window=None):
    """Device time by kernel over ``n`` calls of ``fn`` under
    ``torch.profiler``, and the device's busy share of the host window.
    Returns the device's busy ms a call (None if nothing was recorded).
    ``host_ops=False`` records the device's activity only (a training step's
    hundreds of thousands of host ops take the profiler minutes to sort).
    A dict passed as ``window`` receives the host window a call, in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
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
        return None
    busy_us = sum(r[0] for r in rows)
    if window is not None:
        window["ms"] = window_us / n / 1e3
    print(f"  profiler: device busy {busy_us / n / 1e3:.3f} ms a {unit}, "
          f"{100 * busy_us / window_us:.1f}% of the {window_us / n / 1e3:.3f} ms "
          f"host window, {sum(r[2] for r in rows) / n:.0f} device kernels a "
          f"{unit} ({len(rows)} distinct)")
    for t, key, count in rows[:top]:
        print(f"    {t / n / 1e3:8.3f} ms/{unit}  {count // n:4d} calls/{unit}  {key[:90]}")
    return busy_us / n / 1e3


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


def _flash_probe(plain, tol=BF16_TOL):
    """A dispatch mode over the model's ``repro_torch::flash_attention``
    calls, on the q, k, v the model really makes (in a training step, the
    backward's recompute too).  ``plain=False``:
    run the kernel, hold each call's output to ``attention_ref`` row by row
    within ``tol`` (``.rows``), with each call's q and k shapes and mask
    (``.shapes``), and note how hard the layer's attention is (``.hardness``:
    the spread of q.k/sqrt(d) and the mean largest probability, over the
    last 128 queries of head 0).  ``plain=True``: answer every call with
    ``attention_ref``, so the model runs without the kernel."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.flash_attention import attention_ref

    class Probe(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows, self.hardness, self.shapes = [], [], []

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
            self.rows.append(_close_rows(out, ref, tol))
            self.shapes.append((tuple(q.shape), tuple(k.shape), bool(mask["causal"])))
            s, t, d = q.shape[2], k.shape[2], q.shape[3]
            n = min(128, s)
            sc = (q[:, 0, -n:].float() @ k[:, 0].float().transpose(-1, -2)) / d ** 0.5
            if mask["causal"]:
                sc = sc.masked_fill(torch.arange(t, device=q.device)[None, :]
                                    > torch.arange(s - n, s, device=q.device)[:, None],
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
    phase(f"9. main path: serve {SERVE_ARCH} smoke and FULL, batch {SERVE_BATCH}, prompt "
          f"{SERVE_PROMPT}, {SERVE_NEW} new tokens; then {GEMMA_ARCH} FULL")
    _serve_smoke()
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
    warm["busy_ms"] = _profile("prefill", lambda: prefill_step(model, params,
                                                              {"tokens": prompts}), 1, top=6)
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
    res["warm"] = warm
    res["gemma"] = _serve_gemma()
    launches["flash_attention_gemma"] = res["gemma"]["launches"]
    return res, launches


def _serve_smoke():
    """The llama3-8b smoke config served on the card (``head_dim`` 16), as
    ``python -m repro_torch.launch.serve --arch llama3-8b --smoke`` runs it,
    its flash calls held to attention_ref."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch import serve
    from repro_torch.runtime.steps import prefill_step
    flash_attention_fwd.launches = 0
    res = serve.run(SERVE_ARCH, smoke=True, device="cuda")
    launches = flash_attention_fwd.launches
    torch.cuda.synchronize()
    cfg, tokens = res["model"].cfg, res["tokens"]
    probe = _flash_probe(plain=False)
    with probe:
        prefill_step(res["model"], res["params"], {"tokens": res["prompts"]})
    worst = max(r[1] for r in probe.rows)
    print(f"  {SERVE_ARCH} smoke (head_dim {cfg.resolved_head_dim}, {cfg.num_layers} layers, "
          f"{cfg.dtype}): generated {tokens.shape}, flash launches {launches}; its calls "
          f"on the prefill's q, k, v: worst row {worst:.3e} (tol {BF16_TOL})")
    check(launches >= cfg.num_layers and tokens.shape[0] == 4,
          f"the smoke serve launched flash {launches} times, tokens {tokens.shape}")
    check(all(r[2] for r in probe.rows), f"flash disagrees on the smoke serve: {worst}")


def _serve_gemma():
    """gemma3-12b FULL (bf16, random weights from seed 0) serves the same
    batch of 2048-token prompts for 16 new tokens through
    ``launch.serve.run``; then the bf16 kernel is held to attention_ref on
    every layer's served q, k, v, window layers and global layers apart.
    Its weights are freed before returning."""
    import gc

    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch import serve
    from repro_torch.runtime.server import ServeStats
    from repro_torch.runtime.steps import prefill_step
    flash_attention_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = serve.run(GEMMA_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                    max_new=SERVE_NEW, device="cuda")
    launches = flash_attention_fwd.launches
    torch.cuda.synchronize()
    server, model, params = res["server"], res["model"], res["params"]
    cfg, tokens = model.cfg, res["tokens"]
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    first = server.stats
    server.stats = ServeStats()
    server.generate({"tokens": res["prompts"]}, max_new_tokens=SERVE_NEW)
    warm = server.stats
    print(f"  {GEMMA_ARCH} FULL ({cfg.num_layers} layers, head_dim {cfg.resolved_head_dim}, "
          f"window {cfg.window_size} on {cfg.global_every - 1} of every {cfg.global_every} "
          f"layers, {weights_gb:.2f} GB of bf16 weights): flash launches {launches}; "
          f"prefill {first.prefill_s * 1e3:.1f} ms first, {warm.prefill_s * 1e3:.1f} ms warm; "
          f"decode {warm.decode_tok_per_s:.1f} tok/s warm; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (with {SERVE_ARCH}'s weights "
          f"resident)")
    check(launches >= cfg.num_layers, f"{GEMMA_ARCH} launched flash {launches} times, "
                                      f"expected >= {cfg.num_layers}")
    check(tokens.shape[0] == SERVE_BATCH and 0 <= tokens.min() and tokens.max() < cfg.vocab_size,
          f"{GEMMA_ARCH} generated tokens {tokens.shape}")
    probe = _flash_probe(plain=False)
    with probe:
        prefill_step(model, params, {"tokens": res["prompts"]})
    check(len(probe.rows) == cfg.num_layers, f"probe saw {len(probe.rows)} calls")
    kinds = {"window": [], "global": []}
    for idx, row in enumerate(probe.rows):
        kinds["global" if model._window_for(idx) == 0 else "window"].append(row)
    for kind, rows in kinds.items():
        print(f"  {GEMMA_ARCH} flash on the served q, k, v, {len(rows)} {kind} layers: "
              f"max_abs_err {max(r[0] for r in rows):.3e}, worst row "
              f"{max(r[1] for r in rows):.3e} (tol {BF16_TOL})")
        check(rows and all(r[2] for r in rows),
              f"flash disagrees with attention_ref on {GEMMA_ARCH}'s {kind} layers")
    out = {"launches": launches, "prefill_ms": warm.prefill_s * 1e3,
           "decode_tok_per_s": warm.decode_tok_per_s, "weights_gb": weights_gb}
    del res, server, model, params, probe
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
             "pos": torch.full((), s, dtype=torch.int32, device="cuda")}
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
        out[f"{kind}_capture"], out[f"{kind}_report"] = cap, rep
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

    # fp16 on the same wgmma kernel
    qh, kh, vh = (x.half() for x in (q, k, v))
    t16_d = _device_ms(lambda: flash_attention_fwd(qh, kh, vh, causal=True))
    t16_ld = _device_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    print(f"  flash_attention fp16, same shape: {_fmt_ms(t16_d)} on the device, SDPA "
          f"{_fmt_ms(t16_ld)} on the device; same bound")
    del qh, kh, vh

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
    del q, k, v, q32, k32, v32
    head_dims = _flash_head_dim_timing(gen)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:80",
            "launches": launches["flash_attention"], "max_abs_err": flash_err,
            "ms": t_k, "device_ms": t_d, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": by, "library_ms": t_l, "library_device_ms": t_ld,
            "unit": f"one llama3-8b layer's prefill attention, b{b} h{h} kv{kv} "
                    f"s=t={s} d{d} bf16 causal",
            "fp16": {"device_ms": t16_d, "library_device_ms": t16_ld,
                     "bound_ms": bound, "bound_by": by},
            "fp32": {"ms": t32, "device_ms": t32_d, "library_ms": t32_l,
                     "bound_ms": b32_bound, "bound_by": b32_by,
                     "unit": f"b{b32} h{h} kv{kv} s=t={s} d{d} fp32 causal"},
            "head_dims": head_dims}


def _attn_flops(b, h, s, t, d, causal, window):
    """4 d FLOPs (q.k and p.v) for every (query, key) pair the masks let
    through, counted exactly."""
    pairs = 0
    for qp in range(s):
        hi = min(qp + 1, t) if causal else t
        lo = max(0, qp - window + 1) if window > 0 else 0
        pairs += max(hi - lo, 0)
    return 4.0 * b * h * pairs * d


def _flash_head_dim_timing(gen):
    """The bf16 kernel at the head dims this slice added, beside SDPA and
    the bound: gemma3-12b's layer (b 4, h 16, kv 8, s = t = 2048, d 256)
    causal and with its window of 1024, zamba2-7b's attention (h 32, kv 32,
    d 112) and a d 16 layer (llama3-8b's heads at the smoke head dim)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    b, s = SERVE_BATCH, SERVE_PROMPT
    out = {}
    for label, h, kv, d, window in ((f"{GEMMA_ARCH} layer, causal", 16, 8, 256, 0),
                                    (f"{GEMMA_ARCH} window layer, window 1024", 16, 8, 256, 1024),
                                    ("zamba2-7b attention, causal", 32, 32, 112, 0),
                                    ("d16, causal", 32, 8, 16, 0)):
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for n in (h, kv, kv))
        flops = _attn_flops(b, h, s, s, d, True, window)
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        bound, by = _bound(flops, nbytes, PEAK_BF16_FLOPS)

        def kern():
            return flash_attention_fwd(q, k, v, causal=True, window=window)
        if window:
            qp = torch.arange(s, device="cuda")[:, None]
            kp = torch.arange(s, device="cuda")[None, :]
            mask = (kp <= qp) & (qp - kp < window)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        t_k, t_kd = _time_ms(kern), _device_ms(kern)
        t_l, t_ld = _time_ms(sdpa), _device_ms(sdpa)
        print(f"  flash_attention {label}: b{b} h{h} kv{kv} s=t={s} d{d} bf16: kernel "
              f"{t_k:.4f} ms ({_fmt_ms(t_kd)} on the device, {flops / t_k / 1e9:.1f} TFLOP/s), "
              f"SDPA {t_l:.4f} ms ({_fmt_ms(t_ld)} on the device), bound "
              f"{bound * 1e3:.2f} us ({by})")
        out[label] = {"ms": t_k, "device_ms": t_kd, "library_ms": t_l,
                      "library_device_ms": t_ld, "bound_ms": bound, "bound_by": by,
                      "unit": f"b{b} h{h} kv{kv} s=t={s} d{d} bf16 causal window {window}"}
        del q, k, v
    return out


def _graph_alone(cap, args, n):
    """The captured graph called as it is (no interpreter, no node ranges),
    profiled apart from ``card_reference`` as ``profile_runs`` profiles it:
    the device's busy ms a run and its device work a run by name."""
    from collections import Counter

    import torch
    from repro_torch.core.correlate import profile_runs

    def run():
        with torch.no_grad():
            cap.graph(*args)

    items, _ = profile_runs(run, n, cuda=True)
    busy_ms = sum(it[1] for it in items) / n / 1e3
    check(busy_ms > 0, "no device time in the captured graph's own profile")
    return busy_ms, {k: v / n for k, v in Counter(it[2] for it in items).items()}


def _check_card_reference(label, ref, cr, alone):
    """Phase 12's checks on one ``card_reference``: every profiled kernel
    under a node; the per-class sums within 1% of the profile's device total
    (``profile_seconds``); the same device work, name by name, as the graph
    called as it is in a profile of its own (``alone``, from
    ``_graph_alone``); and every class with card time present in the
    simulation.  The graph alone's busy time is printed beside the sums and
    not held to them: a run with a range around every node leaves the card
    idle between kernels and one without does not, and the card's times of
    the same kernels differ between the two by up to 1.7% (the LeNet step)
    and 5% (the prefill; PERF.md §6)."""
    alone_ms, alone_counts = alone
    check(ref.clock == "device", f"{label}: card_reference ran on the {ref.clock} clock")
    per_class_ms = sum(ref.values()) * 1e3
    profile_ms = ref.profile_seconds * 1e3
    print(f"  {label}: {len(ref.node_seconds)} nodes timed over {ref.runs} runs, "
          f"{sum(ref.counts.values()):.0f} device kernels a run; the per-class sum "
          f"{per_class_ms:.4f} ms a run, the profile's device total {profile_ms:.4f} ms "
          f"({(per_class_ms / profile_ms - 1) * 100:+.2f}%); the graph alone, profiled "
          f"apart: {sum(alone_counts.values()):.0f} device kernels, {alone_ms:.4f} ms "
          f"({(per_class_ms / alone_ms - 1) * 100:+.2f}%)")
    check(not ref.unattributed, f"{label}: device work under no captured node: "
                                f"{ref.unattributed[:8]}")
    check(abs(per_class_ms - profile_ms) <= 0.01 * profile_ms,
          f"{label}: per-class sum {per_class_ms} ms differs from the profile's device "
          f"total {profile_ms} ms by more than 1%")
    differ = sorted((k, ref.counts.get(k, 0), alone_counts.get(k, 0))
                    for k in set(ref.counts) | set(alone_counts)
                    if ref.counts.get(k, 0) != alone_counts.get(k, 0))
    check(not differ, f"{label}: device work a run (name, under the node ranges, the "
                      f"graph alone) differs: {differ[:8]}")
    simulated = {r.kernel for r in cr.rows if r.sim_seconds > 0}
    missing = sorted(c for c, t in ref.items() if t > 0 and c not in simulated)
    check(not missing, f"{label}: op classes with card time but no simulated time: {missing}")


def correlation_phase(lenet, step, serve_res, serve_sim):
    """Fig. 6/7 on the card: the simulator's time per op class against the
    card's own kernel times for the same captured program, for the LeNet-full
    step (the main path's ``card_reference``, on the trained parameters) and
    for the full-width llama3-8b prefill that phase 10 captured, on phase
    9's weights and prompts."""
    from repro_torch.core import H100, card_reference, correlate
    phase("12. correlation on the card (Fig. 6/7)")
    out = {"lenet": _correlation_lines(
        f"lenet-full step b{lenet['step_args'][1].shape[0]} fp32", lenet["card_reference"],
        lenet["correlation"], lenet["report"], step["step_ms"], step["busy_ms"],
        _graph_alone(lenet["capture"], lenet["step_args"], 5))}
    cap = serve_sim["prefill_capture"]
    args = (serve_res["params"], {"tokens": serve_res["prompts"]})
    t0 = time.perf_counter()
    ref = card_reference(cap, *args, n=2)
    secs = time.perf_counter() - t0
    cr = correlate(cap, H100, ref)
    warm = serve_res["warm"]
    print(f"  ({SERVE_ARCH} prefill: card_reference took {secs:.1f}s)")
    out["prefill"] = _correlation_lines(
        f"{SERVE_ARCH} prefill b{SERVE_BATCH} s{SERVE_PROMPT} bf16", ref, cr,
        serve_sim["prefill_report"], warm["prefill_ms"], warm["busy_ms"],
        _graph_alone(cap, args, 2))
    return out


def _correlation_lines(label, ref, cr, rep, wall_ms, busy_ms, alone):
    print(f"  -- {label} (h100 spec vs the card) --")
    print("\n".join("  " + line for line in cr.table().splitlines()))
    print(f"  overall discrepancy {cr.overall_discrepancy * 100:.1f}% (the paper: within "
          f"30%), Pearson r {cr.correlation:.3f} over {len(cr.rows)} op classes")
    sim_ms = rep.total_seconds * 1e3
    print(f"  simulated step {sim_ms:.4f} ms; measured warm step {wall_ms:.4f} ms wall "
          f"(CUDA events), {_fmt_ms(busy_ms)} device-busy (torch.profiler); the "
          f"captured graph's kernels {ref.profile_seconds * 1e3:.4f} ms")
    _check_card_reference(label, ref, cr, alone)
    return {"classes": {r.kernel: [r.sim_seconds, r.ref_seconds] for r in cr.rows
                        if r.sim_seconds > 0 or r.ref_seconds > 0},
            "overall_discrepancy": cr.overall_discrepancy, "r": cr.correlation,
            "sim_ms": sim_ms, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "card_ms": ref.profile_seconds * 1e3, "graph_ms": alone[0]}


def _power_draw(work, seconds):
    """``power.draw`` samples (W) that ``nvidia-smi`` takes every 100 ms
    while ``work()`` is called in a loop for ``seconds`` (``None``: the
    card is left idle).  The sampler is stopped before this returns."""
    import torch
    if work is not None:
        torch.cuda.synchronize()
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)       # the sampler's start-up
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if work is None:
                time.sleep(0.05)
            else:
                work()
        if work is not None:
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        try:
            text = proc.communicate(timeout=10)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            text = proc.communicate()[0]
    samples = []
    for line in text.splitlines():
        try:
            samples.append(float(line.strip()))
        except ValueError:
            pass
    check(len(samples) >= 3, f"nvidia-smi gave {len(samples)} power samples")
    return samples


def power_phase(lenet, step, serve_res, serve_sim, idle_before):
    """Fig. 8 against the card: ``power.draw`` sampled idle (``idle_before``:
    phase 1's samples, before this process ran anything; then again with its
    context live after the serving phases), during the LeNet training loop
    and during repeated prefills, beside the power model's average watts for
    that step on the ``h100`` spec."""
    from repro_torch.core import H100, analyze_power
    from repro_torch.runtime.steps import prefill_step
    phase("13. power (Fig. 8): nvidia-smi power.draw beside analyze_power")
    model, params, prompts = serve_res["model"], serve_res["params"], serve_res["prompts"]
    runs = (("idle after the serving phases", None, None),
            ("LeNet-full training loop", step["one_step"], lenet["report"]),
            (f"{SERVE_ARCH} prefill loop", lambda: prefill_step(model, params,
                                                               {"tokens": prompts}),
             serve_sim["prefill_report"]))
    out = {"idle before any work": {"samples": idle_before,
                                    "mean_w": sum(idle_before) / len(idle_before)}}
    print(f"  idle before any work (phase 1): {len(idle_before)} samples, mean "
          f"{out['idle before any work']['mean_w']:.1f} W")
    for label, work, rep in runs:
        samples = _power_draw(work, 4.0)
        mean = sum(samples) / len(samples)
        row = {"samples": samples, "mean_w": mean}
        line = (f"  {label}: {len(samples)} samples, mean {mean:.1f} W (min "
                f"{min(samples):.1f}, max {max(samples):.1f})")
        if rep is not None:
            pr = analyze_power(rep, H100)
            row["model_w"] = pr.avg_watts
            row["model_shares"] = pr.shares
            line += f"; analyze_power on h100: {pr.avg_watts:.1f} W"
        else:
            line += f"; the h100 spec's static_watts: {H100.static_watts:.1f} W"
        print(line)
        if rep is not None:
            print("\n".join("    " + r for r in pr.table().splitlines()))
        out[label] = row
    return out


def _train_cfg(model_cfg, batch, **train):
    from repro_torch import config as C
    return C.RunConfig(model=model_cfg, shape=C.ShapeConfig("train_4k_cut", TRAIN_SEQ, batch,
                                                            "train"),
                       mesh=C.SMOKE_MESH, train=C.TrainConfig(**train))


def _slots(tree):
    """A strided sample (about 1024 elements) of every leaf, and of every
    layer's slot of the stacked ``layers`` leaves: enough to tell that each
    one moved, a few MB in all."""
    from repro_torch.optim import tree_leaves
    out = []
    for key, sub in sorted(tree.items()):
        for leaf in tree_leaves(sub):
            for row in (leaf if key == "layers" else [leaf]):
                flat = row.reshape(-1)
                out.append(flat[::max(1, flat.numel() // 1024)].clone())
    return out


def train_phase():
    """The training path: qwen1.5-4b FULL (40 layers, bf16 params, fp32
    master, m and v on the card) at train_4k's sequence length, through
    ``init_train_state``, ``train_bundle`` and ``DataPipeline`` as the
    trainer drives them, without its checkpoints (the forced final save
    would write 63 GB), at ``TRAIN_BATCH``; the step's peak must stay
    under the card's memory.  Three steps: the first cold, the second timed
    warm, the third under ``torch.profiler``; then, with the state freed,
    the bf16 kernel held to ``attention_ref`` at the step's attention shape,
    and attention's backward alone at that shape."""
    import gc

    import torch
    from repro_torch import config as C
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                     flash_attention_fwd)
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.kernels.winograd import winograd_conv, winograd_tiles
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime.steps import init_train_state, train_bundle
    cfg = C.get(TRAIN_ARCH).full
    phase(f"15. main path: train {TRAIN_ARCH} FULL ({cfg.num_layers} layers, d "
          f"{cfg.d_model}), seq {TRAIN_SEQ}, {TRAIN_STEPS} AdamW steps")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory in use before: {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    train_cfg = dict(warmup_steps=2, total_steps=100)
    t0 = time.perf_counter()
    state = init_train_state(_train_cfg(cfg, 1, **train_cfg), seed=0, device="cuda")
    torch.cuda.synchronize()
    state_gb = sum(t.numel() * t.element_size() for part in state[1:]
                   for t in tree_leaves(part)) / 1e9
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"  init_train_state: {n_params / 1e9:.3f} B parameters, {state_gb:.2f} GB of "
          f"params, master, m and v on the card, {time.perf_counter() - t0:.1f}s")
    total = torch.cuda.mem_get_info()[1]
    batch = TRAIN_BATCH
    print(f"  batch {batch} (train_4k's {C.TRAIN_4K.global_batch} cut); the card holds "
          f"{total / 1e9:.2f} GB")

    rc = _train_cfg(cfg, batch, **train_cfg)
    step_fn = train_bundle(rc).fn
    master0, params0 = _slots(state.master), _slots(state.params)
    for kern in (tiled_matmul, winograd_conv, winograd_tiles, flash_attention_fwd):
        kern.launches = 0
    data = DataPipeline(batches_for(cfg, rc.shape, seed=0), "cuda")
    torch.cuda.reset_peak_memory_stats()
    metrics, times, busy_ms = [], [], None
    try:
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i < TRAIN_STEPS - 1:
                state, m = step_fn(state, next(data))
                m = {k: float(v) for k, v in m.items()}
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            else:
                box = {}

                def last():
                    box["state"], box["m"] = step_fn(state, next(data))
                win = {}
                busy_ms = _profile("train step", last, 1, top=12, host_ops=False, window=win)
                state, m = box.pop("state"), {k: float(v) for k, v in box.pop("m").items()}
                times.append(win.get("ms", float("nan")) / 1e3)
            metrics.append(m)
            print(f"  step {i + 1}: loss {m['loss']:.4f}, ce {m['ce']:.4f}, grad_norm "
                  f"{m['grad_norm']:.4f}, lr {m['lr']:.3e}, {times[-1]:.3f}s")
    finally:
        data.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"tiled_matmul": tiled_matmul.launches, "winograd_conv": winograd_conv.launches,
                "winograd_tiles": winograd_tiles.launches,
                "flash_attention": flash_attention_fwd.launches}
    warm_s = times[1]
    tok_s = batch * TRAIN_SEQ / warm_s
    # the profiled step's host window, from its launch to its last kernel
    busy_share = None if busy_ms is None else busy_ms / 1e3 / times[-1]
    print(f"  main-path launches: {json.dumps(launches)} "
          f"({launches['flash_attention'] / TRAIN_STEPS:.0f} flash launches a step)")
    print(f"  batch {batch} x {TRAIN_SEQ}: warm step {warm_s * 1e3:.1f} ms, "
          f"{tok_s:.1f} tokens/s; peak device memory {peak_gb:.2f} GB; device busy "
          f"{_fmt_ms(busy_ms)} of the profiled step's {times[-1] * 1e3:.1f} ms"
          + ("" if busy_share is None else f" ({busy_share * 100:.1f}%)"))
    print(f"  first loss {metrics[0]['loss']:.4f} beside ln({cfg.vocab_size}) = "
          f"{math.log(cfg.vocab_size):.2f} (the reference's init: no band set)")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in metrics),
          f"a loss or grad norm is not finite: {metrics}")
    check(peak_gb * 1e9 < total, f"the step's peak {peak_gb:.2f} GB is over the card's "
                                 f"{total / 1e9:.2f} GB")
    check(launches["flash_attention"] == 2 * cfg.num_layers * TRAIN_STEPS,
          f"flash launched {launches['flash_attention']} times in {TRAIN_STEPS} steps, "
          f"expected {2 * cfg.num_layers} a step (a forward and a recompute a layer)")
    moved = [sum(bool((a != b).any()) for a, b in zip(before, _slots(after)))
             for before, after in ((master0, state.master), (params0, state.params))]
    print(f"  moved after {TRAIN_STEPS} steps: {moved[0]} of {len(master0)} master slots, "
          f"{moved[1]} of {len(params0)} bf16 param slots (every leaf, layer by layer)")
    check(moved[0] == len(master0) and moved[1] == len(params0),
          "a parameter did not move")

    # attention's backward alone: the flash op's recompute through
    # attention_ref and its gradients, at one layer's shape, times the layers
    del state, master0, params0
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(6)
    hd = cfg.resolved_head_dim
    q, k, v = (torch.randn(batch, TRAIN_SEQ, n, hd, generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2).requires_grad_()
               for n in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
    # the bf16 kernel at the step's attention shape against attention_ref,
    # one sequence at a time (its fp32 scores are 1.3 GB a sequence)
    with torch.no_grad():
        out = flash_attention_fwd(q, k, v, causal=True)
        rows = [_close_rows(out[i:i + 1], attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                        causal=True), BF16_TOL)
                for i in range(batch)]
    flash_err = max(r[0] for r in rows)
    print(f"  flash_attention_fwd at q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal "
          f"against attention_ref: max abs error {flash_err:.3e}, worst row "
          f"{max(r[1] for r in rows):.3e} of its max |ref| (tol {BF16_TOL})")
    check(all(r[2] for r in rows), f"flash disagrees with attention_ref at the train "
                                   f"step's shape: worst row {max(r[1] for r in rows)} > "
                                   f"{BF16_TOL}")
    out = flash_attention(q, k, v, causal=True)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    bwd_ms = _time_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True),
                      reps=3, warmup=1)
    bwd_step_ms = bwd_ms * cfg.num_layers
    print(f"  attention's backward (recompute through attention_ref, fp32 scores, in "
          f"pieces of 8 heads): {bwd_ms:.2f} ms a layer at q {tuple(q.shape)}, "
          f"{bwd_step_ms:.1f} ms a step ({cfg.num_layers} layers), "
          f"{100 * bwd_step_ms / (warm_s * 1e3):.1f}% of the warm step")
    del q, k, v, out, g
    return {"batch": batch, "peak_gb": peak_gb, "warm_ms": warm_s * 1e3, "tok_s": tok_s,
            "busy_ms": busy_ms, "profiled_ms": times[-1] * 1e3, "launches": launches,
            "attn_bwd_ms_step": bwd_step_ms, "first_loss": metrics[0]["loss"],
            "state_gb": state_gb, "flash_max_abs_err": flash_err, "train_cfg": train_cfg}


def _train_dot_flops(cfg, b, s):
    """The products of one captured train step (see tests/test_torch_train.py):
    per layer the projections 4 times (forward, recompute, two gradients)
    less the down projection's recompute, 10 attention products, and the
    head 4 times."""
    from repro_torch.models.layers import pad_vocab
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    n = b * s
    proj = 2 * n * d * (h + 2 * kv) * hd + 2 * n * h * hd * d + 3 * 2 * n * d * cfg.d_ff
    down = 2 * n * cfg.d_ff * d
    att = 2 * b * h * s * s * hd
    return cfg.num_layers * (4 * proj - down + 10 * att) + 4 * 2 * n * d * pad_vocab(cfg.vocab_size)


def train_sim_phase(train):
    """Phase 10's view of the training path: the full-width train step at
    the batch phase 15 ran, captured from abstract inputs (fake tensors on
    the card: nothing is allocated) and simulated on the ``h100`` spec,
    beside the measured warm step."""
    import torch
    from repro_torch import config as C
    from repro_torch.core import H100, Simulator
    from repro_torch.core.capture import capture_bundle
    from repro_torch.lenet_repro import summary_lines
    from repro_torch.runtime.steps import train_bundle
    cfg = C.get(TRAIN_ARCH).full
    b = train["batch"]
    phase(f"16. capture + simulate the full-width {TRAIN_ARCH} train step (h100), beside "
          f"the measured one")
    rc = _train_cfg(cfg, b, **train["train_cfg"])
    t0 = time.perf_counter()
    cap = capture_bundle(train_bundle(rc), name="train", device="cuda")
    cap_s = time.perf_counter() - t0
    m = cap.module
    dot_flops = sum(sc * m.op_flops(c, o)["mxu"] for o, c, sc in m.walk_entry())
    want = _train_dot_flops(cfg, b, TRAIN_SEQ)
    n_flash = sum(n.target is torch.ops.repro_torch.flash_attention.default
                  for n in cap.graph.graph.nodes)
    t0 = time.perf_counter()
    rep = Simulator(hw=H100).performance(cap)
    sim_s = time.perf_counter() - t0
    print(f"  captured: {len(m.comp(m.entry).ops)} ops in {cap_s:.1f}s, {n_flash} flash "
          f"nodes, dot FLOPs {dot_flops:.4e} (analytic {want:.4e}); simulated in "
          f"{sim_s:.1f}s")
    for line in summary_lines(f"{TRAIN_ARCH} train b{b} s{TRAIN_SEQ}", rep):
        print(line)
    secs = rep.summary()["total_seconds"]
    print(f"  modeled train step {secs * 1e3:.1f} ms against {train['warm_ms']:.1f} ms "
          f"measured warm ({secs * 1e3 / train['warm_ms']:.2f}x)")
    check(dot_flops == want, f"the train capture counts {dot_flops} dot FLOPs, expected {want}")
    check(n_flash == 2 * cfg.num_layers, f"{n_flash} flash nodes, expected "
                                         f"{2 * cfg.num_layers}")
    check(secs > 0 and math.isfinite(secs), f"bad simulated train step {secs}")
    return {"sim_ms": secs * 1e3, "capture_s": cap_s, "ops": len(m.comp(m.entry).ops)}


# the fp32 step with the kernel against the step with attention_ref in its
# place, at full width (2 layers): relative to the plain step's loss, grad
# norm and whole gradient (read from the first moment: after one step m is
# (1 - beta1) times the clipped gradient), and to the norm of its update of
# the master weights.  AdamW's first step moves a weight by lr * g / (|g| +
# eps): where |g| is near eps (most weights here: the clipped gradient of
# 0.94 B weights has norm 1) the update follows small differences of g, and
# a weight whose g lies within its rounding of zero moves by up to 2 lr
# between two correct runs (3.35e-3 of the update's norm on an H100).  So
# the whole update has the loose limit, and the tight one holds it where it
# is lr * sign(g) within 0.1%: |g| >= 1e3 eps, with the runs' gradients
# within an eighth of each other, which must be nearly every such weight.
# There the two updates of a weight differ by at most 1.1e-4 lr (the eps
# term: 1e-3 * (1/8) / (1 + 1/8)) and one ulp of the master it lands on
# (about 1e-5 lr), so within 2e-4 of the update's norm.  Every kernel call
# of the step is held to attention_ref on its own inputs, row by row,
# within F32_TOL as in phase 5
WITNESS_LOSS_TOL, WITNESS_GNORM_TOL = 1e-4, 1e-3
WITNESS_UPDATE_TOL, WITNESS_SIGN_UPDATE_TOL, WITNESS_MIN_HELD = 1e-2, 2e-4, 0.99


def train_witness_phase():
    """Correctness at full width: 2 layers of qwen1.5-4b FULL in fp32, one
    train step at seq 4096 twice from the same weights and batch, once
    through the kernel and once with attention_ref answering every flash
    call (the plain witness, the recompute in the backward included)."""
    import dataclasses
    import gc

    import torch
    from repro_torch import config as C
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime.steps import init_train_state, train_bundle
    cfg = dataclasses.replace(C.get(TRAIN_ARCH).full, num_layers=2, dtype="float32")
    phase(f"17. {TRAIN_ARCH} FULL width, 2 layers, fp32: one train step through the "
          f"kernel against one with attention_ref in its place")
    rc = _train_cfg(cfg, 1, warmup_steps=1, total_steps=100)
    batch = shard_batch(next(batches_for(cfg, rc.shape, seed=2)), "cuda")
    flat = lambda tree: torch.cat([t.reshape(-1) for t in tree_leaves(tree)])
    runs = []
    for plain in (False, True):
        state = init_train_state(rc, seed=0, device="cuda")
        before = flat(state.master)
        launches = flash_attention_fwd.launches
        probe = _flash_probe(plain=plain, tol=F32_TOL)
        with probe:
            state, m = train_bundle(rc).fn(state, batch)
        torch.cuda.synchronize()
        if not plain:
            rows = probe.rows
        update = flat(state.master) - before
        runs.append(({k: float(v) for k, v in m.items()}, update, flat(state.m),
                     flash_attention_fwd.launches - launches))
        del state, before
        gc.collect()
        torch.cuda.empty_cache()
    (mk, uk, gk, lk), (mp, up, gp, lp) = runs
    sign = gp.abs() >= 1e3 * rc.train.eps * (1 - rc.train.beta1)
    held = sign & ((gk - gp).abs() * 8 <= gp.abs())
    share = float(held.sum() / sign.sum())
    rel = {"loss": abs(mk["loss"] - mp["loss"]) / abs(mp["loss"]),
           "grad_norm": abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"],
           "grad": float((gk - gp).norm() / gp.norm()),
           "update": float((uk - up).norm() / up.norm()),
           "sign_update": float((uk - up)[held].norm() / up[held].norm())}
    print(f"  kernel: loss {mk['loss']:.6f}, grad_norm {mk['grad_norm']:.6f}, {lk} flash "
          f"launches, each held to attention_ref on its inputs: worst row "
          f"{max(r[1] for r in rows):.3e} (tol {F32_TOL}); attention_ref: loss "
          f"{mp['loss']:.6f}, grad_norm {mp['grad_norm']:.6f}, {lp} launches")
    print(f"  relative differences: loss {rel['loss']:.2e} (tol {WITNESS_LOSS_TOL}), "
          f"grad_norm {rel['grad_norm']:.2e} and gradient {rel['grad']:.2e} (tol "
          f"{WITNESS_GNORM_TOL}), master update {rel['update']:.2e} of its norm (tol "
          f"{WITNESS_UPDATE_TOL}), largest difference "
          f"{float((uk - up).abs().max()) / mk['lr']:.2e} lr; where |g| >= 1e3 eps "
          f"({float(sign.float().mean()):.3e} of the weights) "
          f"{rel['sign_update']:.2e} (tol {WITNESS_SIGN_UPDATE_TOL}) over the {share:.7f} "
          f"of them with the gradients within an eighth (at least {WITNESS_MIN_HELD})")
    check(lk == 2 * cfg.num_layers and lp == 0 and len(rows) == lk,
          f"flash launches: {lk} with the kernel ({len(rows)} probed), {lp} in the plain "
          f"witness")
    check(all(r[2] for r in rows), "a flash call of the fp32 step disagrees with "
                                   "attention_ref on its inputs")
    check(rel["loss"] <= WITNESS_LOSS_TOL and rel["grad_norm"] <= WITNESS_GNORM_TOL
          and rel["grad"] <= WITNESS_GNORM_TOL and rel["update"] <= WITNESS_UPDATE_TOL
          and rel["sign_update"] <= WITNESS_SIGN_UPDATE_TOL and share >= WITNESS_MIN_HELD,
          f"the kernel's fp32 train step disagrees with the plain one: {rel}, the "
          f"gradients within an eighth for {share} of the weights with |g| >= 1e3 eps")
    rel["held"] = share
    del runs, uk, up, gk, gp, sign, held, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rel


def trainer_phase():
    """The trainer on the card: the qwen1.5-4b smoke config, 6 steps with a
    checkpoint every 2 and one injected NodeFailure at step 3, so checkpoint,
    restore and continue all run on cuda; then ``python -m
    repro_torch.launch.train --smoke`` as a user runs it."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch import config as C
    from repro_torch.checkpoint.store import list_steps
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.runtime.failure import FailurePlan
    from repro_torch.runtime.trainer import Trainer
    phase(f"18. the trainer on the card: {TRAIN_ARCH} smoke, a failure, restore, continue")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        rc = C.RunConfig(model=C.get(TRAIN_ARCH).smoke,
                         shape=C.ShapeConfig("smoke_train", 64, 4, "train"), mesh=C.SMOKE_MESH,
                         train=C.TrainConfig(total_steps=6, warmup_steps=2, checkpoint_every=2,
                                             keep_checkpoints=2, learning_rate=1e-3,
                                             checkpoint_dir=os.path.join(tmp, "trainer")))
        flash_attention_fwd.launches = 0
        report = Trainer(rc, use_mesh=False, failure_plan=FailurePlan(failures={3: 1}),
                         device="cuda").train()
        steps = list_steps(rc.train.checkpoint_dir)
        print(f"  Trainer: {report.steps_done} steps, {report.restarts} restart, "
              f"{report.checkpoints} checkpoints (kept: {steps}), losses "
              f"{[round(x, 4) for x in report.losses]}, flash launches "
              f"{flash_attention_fwd.launches}")
        check(report.restarts == 1 and report.steps_done >= 6 and steps[-1] == 6,
              f"the trainer did not restore and finish: {report}")
        check(all(math.isfinite(x) for x in report.losses), "a trainer loss is not finite")
        check(flash_attention_fwd.launches > 0, "the trainer never launched flash")
        env = dict(os.environ, PYTHONPATH=str(SRC))
        cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                              TRAIN_ARCH, "--smoke", "--steps", "4", "--ckpt-dir",
                              os.path.join(tmp, "cli")],
                             capture_output=True, text=True, env=env, timeout=600)
        print(f"  python -m repro_torch.launch.train --arch {TRAIN_ARCH} --smoke --steps 4: "
              f"{cli.stdout.strip()}")
        check(cli.returncode == 0 and cli.stdout.startswith("done: steps=4"),
              f"launch.train failed: {cli.stderr[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()


def _start_nccl_group():
    """A one-rank NCCL default process group on this card, its store on a
    free local TCP port, with a timeout."""
    import datetime
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 1, True, timeout=datetime.timedelta(seconds=120))
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))


def _leaf_rel(a, b):
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


# the sharded smoke step against the plain one from the same state (fp32):
# the loss and the grad norm within MESH_TOL (relative); each leaf of the
# new params, master, m and v within MESH_STATE_TOL of the leaf's largest
# magnitude (on a (1, 1) mesh both run the same kernels in the same order)
MESH_TOL = 1e-5
MESH_STATE_TOL = 1e-6
# the sharded trainer's steps on qwen1.5-4b FULL (the first is cold)
MESH_STEPS = 3


def mesh_phase(train):
    """The distributed layer on the card (one rank: NCCL takes one rank a
    card): the sharded smoke step against the plain one, qwen1.5-4b FULL
    through ``Trainer(use_mesh=True)``, compression and the pipeline."""
    import dataclasses
    import gc
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch import config as C
    from repro_torch.data.synthetic import batches_for
    from repro_torch.distributed.compression import (compressed_psum_mean,
                                                     dequantize_int8, quantize_int8)
    from repro_torch.distributed.mesh import build_mesh
    from repro_torch.distributed.pipeline import pipeline_apply
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.store import restore_resharded, save
    from repro_torch.distributed.sharding import place
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import build_model
    from repro_torch.optim import TrainState, abstract_state, tree_leaves
    from repro_torch.runtime.steps import run_rules, init_train_state, train_bundle
    from repro_torch.runtime.trainer import Trainer
    phase("22. the distributed layer on the card: a one-rank NCCL group, a (1, 1) mesh")
    gc.collect()
    torch.cuda.empty_cache()
    _start_nccl_group()
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        mesh = build_mesh(C.SMOKE_MESH, device="cuda")
        print(f"  build_mesh: {mesh}, backend {dist.get_backend()}")

        # the sharded smoke step against the plain one, from the same state
        cfg = dataclasses.replace(C.get(SERVE_ARCH).smoke, dtype="float32")
        rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("smoke_train", 64, 4, "train"),
                         mesh=C.SMOKE_MESH,
                         train=C.TrainConfig(warmup_steps=2, learning_rate=1e-3))
        model = build_model(cfg)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in next(batches_for(cfg, rc.shape, seed=0)).items()}
        plain = init_train_state(rc, seed=0, device="cuda")
        sharded = init_train_state(rc, seed=0, device="cuda", mesh=mesh)
        _, batch_axes = model.train_input_specs(rc.shape)
        plain, pm = train_bundle(rc).fn(plain, batch)
        sharded, sm = train_bundle(rc, mesh).fn(
            sharded, place(batch, batch_axes, run_rules(rc, model), mesh))
        state_errs = {}
        for part in ("params", "master", "m", "v"):
            raw = rel = 0.0
            pairs = list(zip(tree_leaves(getattr(sharded, part)),
                             tree_leaves(getattr(plain, part))))
            for a, b in pairs:
                d = float((a.full_tensor() - b).abs().max())
                raw = max(raw, d)
                rel = max(rel, d / max(float(b.abs().max()), 1e-30))
            state_errs[part] = {"max_abs": raw, "rel": rel, "leaves": len(pairs)}
        loss_err = abs(float(sm["loss"]) - float(pm["loss"])) / abs(float(pm["loss"]))
        gn_err = abs(float(sm["grad_norm"]) - float(pm["grad_norm"])) / float(pm["grad_norm"])
        print(f"  {SERVE_ARCH} smoke step, fp32, sharded against plain: loss "
              f"{float(sm['loss']):.6f} / {float(pm['loss']):.6f} (rel {loss_err:.2e}), grad "
              f"norm rel {gn_err:.2e} (tol {MESH_TOL}); new state, worst max abs (of a leaf's "
              f"scale) over each part's leaves: " + ", ".join(
                  f"{k} {v['max_abs']:.3e} ({v['rel']:.2e}, {v['leaves']})"
                  for k, v in state_errs.items()) + f" (tol {MESH_STATE_TOL})")
        check(loss_err <= MESH_TOL and gn_err <= MESH_TOL
              and all(v["rel"] <= MESH_STATE_TOL for v in state_errs.values()),
              "the sharded smoke step disagrees with the plain one")
        out["smoke"] = {"loss_rel": loss_err, "grad_norm_rel": gn_err, "state": state_errs}

        # the sharded state saved (rank 0 writes, no leaf gathered on the
        # device) and restored resharded onto the mesh
        dleaves = [x for part in sharded[1:] for x in tree_leaves(part)
                   if isinstance(x, DTensor)]
        largest = max(x.to_local().numel() * x.element_size() for x in dleaves)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        save(os.path.join(tmp, "s"), 1, sharded)
        torch.cuda.synchronize()
        save_extra = torch.cuda.max_memory_allocated() - base
        like = abstract_state(model.abstract())
        back = TrainState(*restore_resharded(os.path.join(tmp, "s"), 1, like,
                                             train_bundle(rc, mesh).in_shardings[0]))
        same = all(torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
                   for pa, pb in zip(sharded[1:], back[1:])
                   for a, b in zip(tree_leaves(pa), tree_leaves(pb)))
        print(f"  checkpoint of the sharded smoke state: {len(dleaves)} DTensor leaves, the "
              f"device's peak rose {save_extra} B while saving (the largest shard {largest} B); "
              f"restored resharded, every shard equal: {same}")
        check(save_extra <= largest and same and int(back.step) == int(sharded.step),
              "the sharded checkpoint grew the device's memory past a shard, or did not "
              "restore")
        out["save"] = {"device_extra_bytes": save_extra, "largest_shard_bytes": largest}
        del plain, sharded, batch, back

        # compression and the pipeline on the card
        gen = torch.Generator(device="cuda").manual_seed(8)
        x = torch.randn(4096, 1024, generator=gen, device="cuda") * 3
        q, sc = quantize_int8(x)
        qc, scc = quantize_int8(x.cpu())
        exact_q = bool(torch.equal(q.cpu(), qc)) and float(sc) == float(scc)
        mean = compressed_psum_mean(x, mesh, "data")
        mean_err = float((mean - dequantize_int8(q, sc)).abs().max())
        ws = torch.randn(1, 64, 64, generator=gen, device="cuda") * 0.3
        xm = torch.randn(6, 2, 64, generator=gen, device="cuda")
        fn = lambda w, xb: torch.tanh(xb @ w)
        pipe_err = float((pipeline_apply(fn, ws, xm, mesh=mesh, axis="data")
                          - fn(ws[0], xm)).abs().max())
        print(f"  quantize_int8 on the card bit-exact with the CPU: {exact_q}; "
              f"compressed_psum_mean over the NCCL group against the dequantized tensor: "
              f"max abs {mean_err:.2e}; pipeline_apply at S = 1, M = 6 against the stage: "
              f"max abs {pipe_err:.2e}")
        check(exact_q and mean_err == 0.0 and pipe_err == 0.0,
              "compression or the pipeline disagrees on the card")
        out.update(quantize_exact=exact_q, psum_err=mean_err, pipeline_err=pipe_err)

        # qwen1.5-4b FULL through the trainer's mesh path, largest batch first
        full = C.get(TRAIN_ARCH).full
        batch_size = train["batch"]
        while True:
            rc = C.RunConfig(
                model=full, shape=C.ShapeConfig("train_4k_cut", TRAIN_SEQ, batch_size, "train"),
                mesh=C.SMOKE_MESH,
                # no checkpoints: the state is 63 GB
                train=C.TrainConfig(total_steps=MESH_STEPS, warmup_steps=2, checkpoint_every=0,
                                    checkpoint_dir=os.path.join(tmp, "c")))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            flash_attention_fwd.launches = 0
            base_bytes = torch.cuda.memory_allocated()
            trainer = Trainer(rc, use_mesh=True, device="cuda")
            try:
                t0 = time.perf_counter()
                report = trainer.train()
                torch.cuda.synchronize()
                break
            except torch.cuda.OutOfMemoryError:
                del trainer
                print(f"  batch {batch_size}: out of memory; one less")
                batch_size -= 1
                check(batch_size > 0, "qwen1.5-4b FULL does not fit at batch 1 on the mesh")
        wall = time.perf_counter() - t0
        peak_bytes = torch.cuda.max_memory_allocated()
        peak_gb = peak_bytes / 1e9
        times = trainer._step_times
        warm_ms = times[1] * 1e3
        flash_per_step = flash_attention_fwd.launches / MESH_STEPS
        print(f"  Trainer(use_mesh=True), {TRAIN_ARCH} FULL, seq {TRAIN_SEQ}, batch "
              f"{batch_size} (reduced: train_4k's {C.TRAIN_4K.global_batch} cut to "
              f"{batch_size}, the largest that fits): losses "
              f"{[round(x, 4) for x in report.losses]}, {wall:.1f}s in all")
        print(f"  step times {[round(t * 1e3, 1) for t in times]} ms; warm step "
              f"{warm_ms:.1f} ms beside phase 15's {train['warm_ms']:.1f} ms (batch "
              f"{train['batch']}, no mesh); peak {peak_gb:.2f} GB beside phase 15's "
              f"{train['peak_gb']:.2f} GB; {flash_per_step:.0f} flash launches a step "
              f"(phase 15: {train['launches']['flash_attention'] / TRAIN_STEPS:.0f})")
        check(report.steps_done == MESH_STEPS and all(math.isfinite(x) for x in report.losses),
              f"the sharded trainer did not run {MESH_STEPS} finite steps: {report}")
        check(flash_per_step == 2 * full.num_layers,
              f"flash launched {flash_per_step} times a step on the mesh, expected "
              f"{2 * full.num_layers} (a forward and a recompute a layer)")
        out.update(batch=batch_size, warm_ms=warm_ms, step_ms=[t * 1e3 for t in times],
                   peak_gb=peak_gb, run_peak_bytes=peak_bytes - base_bytes,
                   flash_per_step=flash_per_step,
                   flash_launches=flash_attention_fwd.launches, losses=report.losses,
                   phase15_warm_ms=train["warm_ms"], phase15_peak_gb=train["peak_gb"])
        del trainer, report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return out


#: the dry-run cells phase 23 runs on the host: (arch, shape)
DRYRUN_CELLS = (("llama3-8b", "decode_32k"), ("dbrx-132b", "train_4k"))
#: the dry-run's memory record of phase 22's qwen1.5-4b step (traced on a
#: one-rank fake group, the same (1, 1) mesh, batch and seq) against the
#: card's peak in phase 22: the traced per-device bytes within this share
DRYRUN_MEM_TOL = 0.15
_DRYRUN_WITNESS = r"""
import json, sys
from repro_torch import config as C
from repro_torch.distributed.mesh import build_mesh
from repro_torch.launch import dryrun as D
arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
D.start_fake_group(1)
rc = C.RunConfig(model=C.get(arch).full, shape=C.ShapeConfig("train_4k_cut", seq, batch, "train"),
                 mesh=C.SMOKE_MESH, train=C.TrainConfig(warmup_steps=2))
rec = D.record(rc, build_mesh(C.SMOKE_MESH, device="cpu"))
print(json.dumps({"memory": rec["memory"], "trace_s": rec["trace_s"],
                  "extrapolated_from": rec.get("extrapolated_from")}))
"""


def dryrun_phase(meshed):
    """``python -m repro_torch.launch.dryrun`` on the 256-rank production
    mesh, as subprocesses on the host (a fake process group: no device),
    and the dry-run's memory record of phase 22's step held to the card."""
    import os
    import shutil
    phase("23. python -m repro_torch.launch.dryrun on the (16, 16) mesh (host)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = {}
    t0 = time.perf_counter()
    # the cells and the witness side by side: each is one process on one core
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                               arch, "--shape", shape], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for arch, shape in DRYRUN_CELLS]
    witness = subprocess.Popen([sys.executable, "-c", _DRYRUN_WITNESS, TRAIN_ARCH,
                                str(TRAIN_SEQ), str(meshed["batch"])], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, env=env)
    try:
        for (arch, shape), proc in zip(DRYRUN_CELLS, procs):
            stdout, stderr = proc.communicate(timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0 and "dry-run OK" in stdout,
                  f"dry-run {arch} {shape} failed: {stdout[-1500:]} {stderr[-1500:]}")
            art = ROOT / "experiments" / "dryrun_torch" / f"{arch}.{shape}.16x16.json"
            d = json.loads(art.read_text())
            (ROOT / "chiprun_out").mkdir(exist_ok=True)
            shutil.copy(art, ROOT / "chiprun_out" / f"dryrun_{arch}.{shape}.json")
            by_kind = {k: v["bytes"] for k, v in d["collectives"]["by_kind"].items()}
            how = (f", extended from layers x microbatches {d['extrapolated_from']}"
                   if "extrapolated_from" in d else ", traced whole")
            print(f"  {arch} {shape}{how}: {d['num_devices']} ranks, per-device "
                  f"{d['memory']['per_device_bytes'] / 2**30:.3f} GiB (params "
                  f"{d['memory']['param_bytes'] / 2**30:.3f}, temporaries "
                  f"{d['memory']['temp_bytes'] / 2**30:.3f}), collectives "
                  f"{d['collectives']['count']} ops, {d['collectives']['total_bytes']:.4e} bytes "
                  f"a device, by kind {json.dumps(by_kind)}; engine ({d['engine_hw']}) "
                  f"{d['engine']['total_seconds']:.4f} s; trace {d['trace_s']:.1f} s, done "
                  f"{wall:.1f} s into the phase")
            check(d["num_devices"] == 256 and d["ir_totals"]["mxu_flops"] > 0
                  and d["collectives"]["total_bytes"] > 0 and d["engine"]["total_seconds"] > 0,
                  f"dry-run {arch} {shape}: an empty record")
            out[f"{arch}.{shape}"] = {"per_device_gib": d["memory"]["per_device_bytes"] / 2**30,
                                      "memory": d["memory"], "collective_bytes": by_kind,
                                      "engine_s": d["engine"]["total_seconds"],
                                      "trace_s": d["trace_s"], "wall_s": wall}
        stdout, stderr = witness.communicate(timeout=600)
        check(witness.returncode == 0,
              f"the dry-run of phase 22's step failed: {stdout[-1500:]} {stderr[-1500:]}")
    finally:
        for proc in (*procs, witness):
            proc.kill()
    w = json.loads(stdout.strip().splitlines()[-1])
    traced = w["memory"]["per_device_bytes"]
    peak = meshed["run_peak_bytes"]
    print(f"  witness: the dry-run's record of phase 22's {TRAIN_ARCH} FULL step (seq "
          f"{TRAIN_SEQ}, batch {meshed['batch']}, a (1, 1) mesh, extended from "
          f"{w['extrapolated_from']}): per-device {traced / 1e9:.3f} GB (arguments "
          f"{w['memory']['argument_bytes'] / 1e9:.3f}, temporaries "
          f"{w['memory']['temp_bytes'] / 1e9:.3f}, outputs {w['memory']['output_bytes'] / 1e9:.3f}"
          f", aliased {w['memory']['alias_bytes'] / 1e9:.3f}) against the card's peak "
          f"{peak / 1e9:.3f} GB over what was allocated before phase 22's trainer: ratio {traced / peak:.4f} (tol {DRYRUN_MEM_TOL})")
    check(abs(traced / peak - 1) <= DRYRUN_MEM_TOL,
          "the dry-run's memory record of phase 22's step is off the card's peak")
    out["witness"] = {"traced_bytes": traced, "card_peak_bytes": peak,
                      "ratio": traced / peak, **w}
    return out


# the debugger's tolerance for one fp32 LeNet step against float64: both the
# absolute and the relative error (to the node's largest output) must exceed
# their bound for a node to diverge
DEBUG_RTOL, DEBUG_ATOL = 1e-4, 1e-6


def analysis_phase(lenet):
    """Section V's views of the LeNet step and the section III-D debugger on
    the card: the phase analysis and its reconciliation, the legacy vision
    view's camping index, ``first_divergence`` of one training step (the
    hand kernels on the card against float64 on the CPU) clean and with one
    planted bf16 rounding, and the analysis CLI's JSON."""
    import os

    import repro_torch.models.lenet as lenet_mod
    from repro_torch import lenet_repro
    from repro_torch.core import H100, Simulator, first_divergence
    from repro_torch.models.lenet import sgd_step
    phase("14. phase analysis, vision and the differential debugger")
    ar, rep = lenet["analysis"], lenet["report"]
    err = ar.reconcile()
    print(f"  analyze: {len(ar.phases)} phases, bucket reconciliation {err * 100:.4f}%")
    check(err < 0.01 and len(ar.phases) >= 2, "phase analysis of the LeNet step failed")
    vr = Simulator(hw=H100).vision(rep)
    print(f"  vision: camping index {vr.camping_index:.3f} over {len(vr.buckets)} "
          f"buckets, {len(vr.phases)} phases")
    check(math.isfinite(vr.camping_index) and vr.camping_index >= 1.0 - 1e-9,
          f"bad camping index {vr.camping_index}")

    model, args = lenet["model"], lenet["step_args"]

    def step(p, x, y):
        return sgd_step(model, p, x, y, lenet_repro.LR)

    t0 = time.perf_counter()
    div = first_divergence(step, args, rtol=DEBUG_RTOL, atol=DEBUG_ATOL)
    print(f"  first_divergence, one LeNet-full step on the card vs float64 on the CPU "
          f"(rtol {DEBUG_RTOL}, atol {DEBUG_ATOL}): {div or 'none'} "
          f"({time.perf_counter() - t0:.1f}s)")
    check(div is None, f"the clean step diverges: {div}")
    # plant: fc2's product takes its inputs rounded to bf16
    orig, calls = lenet_mod.matmul, []

    def planted(a, b, **kw):
        calls.append(1)
        if len(calls) == 2:
            a, b = a.bfloat16().float(), b.bfloat16().float()
        return orig(a, b, **kw)

    lenet_mod.matmul = planted
    try:
        div = first_divergence(step, args, rtol=DEBUG_RTOL, atol=DEBUG_ATOL)
    finally:
        lenet_mod.matmul = orig
    print(f"  planted (fc2's inputs rounded to bf16): {div}")
    f1 = model.cfg.fc_dims[0]
    check(div is not None and div.primitive == "aten._to_copy.default"
          and div.out_dtypes == ("bfloat16",) and div.out_shapes == [(lenet_repro.BATCH, f1)],
          f"the planted rounding was not found at fc2's input: {div}")

    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "lenet", "--full",
                          "--hw", "h100", "--json", "-"], capture_output=True, text=True,
                         env=env, timeout=600)
    check(cli.returncode == 0, f"the analysis CLI failed: {cli.stderr[-2000:]}")
    doc = json.loads(cli.stdout[cli.stdout.rindex("\n{\n") + 1:])
    print(f"  python -m repro_torch.analysis lenet --full --hw h100 --json -: "
          f"{len(doc['phases'])} phases, reconcile {doc['reconcile_max_rel_error']:.2e}, "
          f"modeled step {doc['summary']['total_seconds'] * 1e3:.3f} ms")
    check(doc["hw"] == "h100" and doc["reconcile_max_rel_error"] < 0.01,
          "the analysis CLI's JSON does not reconcile")


# the model families of the reference beyond dense, served FULL on the same
# requests as llama3-8b (batch 4, 2048-token prompts, 16 new tokens):
# qwen3-moe-30b-a3b (phase 19) and the other four that fit one card (phase
# 20); dbrx-132b FULL (263 GB of bf16 weights) needs four, so every new
# arch's smoke config is served too (phase 21)
MOE_ARCH = "qwen3-moe-30b-a3b"
FAMILY_ARCHS = ("zamba2-7b", "internvl2-2b", "rwkv6-1.6b", "seamless-m4t-large-v2")
SMOKE_ARCHS = (MOE_ARCH, "dbrx-132b", "internvl2-2b", "zamba2-7b", "rwkv6-1.6b",
               "seamless-m4t-large-v2")
# the MoE witness's layer, and the 2-layer fp32 witness's batch and length
MOE_LAYER, WITNESS_BATCH, WITNESS_LEN = 24, 2, 128


def _flash_per_prefill(cfg):
    """The flash op's calls in one prefill: one per self-attention layer,
    one per shared-block application for the hybrid, none for RWKV6, and for
    the encoder-decoder one per encoder layer and two per decoder layer
    (self and cross)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family in ("encdec", "audio"):
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def _serve_full(arch, smoke=False):
    """``arch`` served through ``launch.serve.run`` (bf16, random weights
    from seed 0) on the llama3-8b requests, every kernel's count set to 0
    just before and read just after; then a warm repeat of the same
    requests (prefill ms, decode tok/s, peak memory, which must stay under
    the card's), the flash launches of one prefill, and a profile of one
    prefill and of four decode steps (the device's busy share)."""
    import gc

    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.kernels.winograd import winograd_conv, winograd_tiles
    from repro_torch.launch import serve
    from repro_torch.runtime.server import Server, ServeStats
    from repro_torch.runtime.steps import decode_step, prefill_step
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 1e9
    kerns = {"tiled_matmul": tiled_matmul, "winograd_conv": winograd_conv,
             "winograd_tiles": winograd_tiles, "flash_attention": flash_attention_fwd}
    for kern in kerns.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.run(arch, smoke=smoke, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                    max_new=SERVE_NEW, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kerns.items()}
    peak_first = torch.cuda.max_memory_allocated() / 1e9
    server, model, params, requests = res["server"], res["model"], res["params"], res["requests"]
    cfg, tokens = model.cfg, res["tokens"]
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    check(tokens.shape[0] == SERVE_BATCH and 1 <= tokens.shape[1] <= SERVE_NEW
          and 0 <= tokens.min() and tokens.max() < cfg.vocab_size,
          f"{arch}: generated tokens {tokens.shape}, in [{tokens.min()}, {tokens.max()}]")
    check(launches["flash_attention"] >= _flash_per_prefill(cfg),
          f"{arch}: flash launched {launches['flash_attention']} times, expected >= "
          f"{_flash_per_prefill(cfg)}")

    torch.cuda.reset_peak_memory_stats()
    server.stats = ServeStats()
    server.generate(requests, max_new_tokens=SERVE_NEW)
    warm = server.stats
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(max(peak, peak_first) < card_gb,
          f"{arch}: peak memory {max(peak, peak_first):.2f} GB passes the card's {card_gb:.2f}")
    window = {}
    flash_attention_fwd.launches = 0
    busy = _profile("prefill", lambda: prefill_step(model, params, requests), 1, top=6,
                    window=window)
    per_prefill = flash_attention_fwd.launches
    check(per_prefill == _flash_per_prefill(cfg),
          f"{arch}: {per_prefill} flash launches a prefill, expected {_flash_per_prefill(cfg)}")
    _, cache = prefill_step(model, params, requests)
    state = {"cache": Server._grow_cache(cache, 4)}
    del cache
    last = res["prompts"][:, -1:]

    def one_decode():
        state["cache"] = decode_step(model, params, state["cache"], {"token": last})[1]

    dwindow = {}
    dbusy = _profile("decode step", one_decode, 4, top=6, window=dwindow)
    del state
    steps = max(warm.tokens_out // SERVE_BATCH, 1)
    out = {"arch": arch, "weights_gb": weights_gb, "first_call_s": first_s,
           "prefill_ms": warm.prefill_s * 1e3, "decode_tok_per_s": warm.decode_tok_per_s,
           "decode_step_ms": warm.decode_s * 1e3 / steps,
           "peak_gb": peak, "peak_first_call_gb": peak_first, "launches": launches,
           "flash_per_prefill": per_prefill, "prefill_busy_ms": busy,
           "prefill_window_ms": window.get("ms"), "decode_busy_ms": dbusy,
           "decode_window_ms": dwindow.get("ms")}
    share = (f"{100 * busy / window['ms']:.1f}%" if busy and window.get("ms")
             else "not measured")
    print(f"  {arch}{' smoke' if smoke else ' FULL'} ({cfg.family}, {cfg.num_layers} layers, "
          f"d {cfg.d_model}, {weights_gb:.2f} GB of {cfg.dtype} weights; {before:.2f} GB in "
          f"use before): first call {first_s:.1f} s, launches {json.dumps(launches)}; warm: "
          f"prefill {out['prefill_ms']:.1f} ms (device busy {share}), decode "
          f"{out['decode_tok_per_s']:.1f} tok/s ({out['decode_step_ms']:.2f} ms a step), "
          f"peak memory {peak:.2f} GB ({peak_first:.2f} GB in the first call, init "
          f"included; the card holds {card_gb:.2f}); flash {per_prefill} a prefill; "
          f"{CARD}")
    return out, res


def _probe_prefill(arch, res, decode=False):
    """The flash kernel held to attention_ref on every call of one served
    prefill (and, with ``decode``, of a decode step after it), by mask and
    shape."""
    from repro_torch.runtime.server import Server
    from repro_torch.runtime.steps import decode_step, prefill_step
    model, params, requests = res["model"], res["params"], res["requests"]
    probe = _flash_probe(plain=False)
    with probe:
        _, cache = prefill_step(model, params, requests)
        if decode:
            decode_step(model, params, Server._grow_cache(cache, 1),
                        {"token": res["prompts"][:, -1:]})
    del cache
    kinds = {}
    for (qs, ks, causal), row in zip(probe.shapes, probe.rows):
        b, h, s, d = qs
        key = (f"h{h} kv{ks[1]} s={s} t={ks[2]} d{d} "
               f"{'causal' if causal else 'non-causal'}")
        kinds.setdefault(key, []).append(row)
    for key, rows in kinds.items():
        print(f"  {arch} flash on the served q, k, v, {len(rows)} calls at {key}: max_abs_err "
              f"{max(r[0] for r in rows):.3e}, worst row {max(r[1] for r in rows):.3e} "
              f"(tol {BF16_TOL})")
        check(all(r[2] for r in rows),
              f"flash disagrees with attention_ref on {arch}'s calls at {key}")
    return {k: max(r[1] for r in v) for k, v in kinds.items()}


def _moe_plain(p, cfg, x, cap):
    """An independent plain version of ``moe_ffn`` in fp32, token by token:
    the router's top-k with renormalized gates; per sequence and expert, the
    first ``cap`` (token, choice) pairs in token-major order are kept (the
    rank of a pair among its expert's pairs is a running count); each kept
    pair adds its gate times its expert's SwiGLU of the token.  Returns
    (out (b, s, d) fp32, kept (b, s, k) bool)."""
    import torch
    import torch.nn.functional as F
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    gates, idx = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    onehot = F.one_hot(idx.reshape(b, s * k), e)                  # token-major pairs
    rank = (onehot.cumsum(1) - onehot).mul(onehot).sum(-1)        # pairs before, same expert
    kept = (rank < cap).reshape(b, s, k)
    out = torch.zeros((b, s, d), dtype=torch.float32, device=x.device)
    xf = x.float()
    for ex in range(e):
        bi, ti, ci = torch.nonzero((idx == ex) & kept, as_tuple=True)
        if not len(bi):
            continue
        xt = xf[bi, ti]
        y = (F.silu(xt @ p["w_gate"][ex].float()) * (xt @ p["w_up"][ex].float())
             ) @ p["w_down"][ex].float()
        out.index_put_((bi, ti), gates[bi, ti, ci, None] * y, accumulate=True)
    return out, kept


def moe_serve_phase():
    """Phase A: qwen3-moe-30b-a3b FULL (48 layers, 128 experts of d_ff 768,
    top-8; 32 query heads over 4 kv heads, the flash kernel's first GQA
    group of 8) in bf16 through ``launch.serve.run``; the flash kernel held
    to attention_ref on every layer's served q, k, v; ``moe_ffn`` of one
    layer's served input held to an independent plain version in fp32 (the
    kept sets equal, the outputs within BF16_TOL of each row's scale); then
    its first 2 layers at full width, upcast to fp32, on the card against
    the port's CPU path on the same weights, and decode against prefill at
    no-drop capacity."""
    import dataclasses
    import gc

    import torch
    from repro_torch import config as C
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime.steps import prefill_step
    phase(f"19. main path: serve {MOE_ARCH} FULL, batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
          f"{SERVE_NEW} new tokens; flash, MoE and fp32 witnesses")
    out, res = _serve_full(MOE_ARCH)
    cfg, model, params = res["model"].cfg, res["model"], res["params"]
    expert_gb = sum(t.numel() * t.element_size() for key, t in params["layers"]["moe"].items()
                    if key != "router") / 1e9
    bound_ms = expert_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    out["expert_gb"], out["decode_bound_ms"] = expert_gb, bound_ms
    print(f"  decode reads every expert's weights a step (no-drop: one slot per sequence "
          f"and expert): {expert_gb:.2f} GB, at least {bound_ms:.2f} ms at 3.35 TB/s; "
          f"measured {out['decode_step_ms']:.2f} ms a step")
    out["flash_worst"] = _probe_prefill(MOE_ARCH, res)

    # moe_ffn on one layer's served input against the plain version
    orig, seen = moe_mod.moe_ffn, []

    def record(p, c, x, capacity_factor=moe_mod.CAPACITY_FACTOR, **kw):
        if len(seen) == MOE_LAYER:
            seen.append(x.clone())
        else:
            seen.append(None)
        return orig(p, c, x, capacity_factor=capacity_factor, **kw)

    moe_mod.moe_ffn = record
    try:
        prefill_step(model, params, res["requests"])
    finally:
        moe_mod.moe_ffn = orig
    x = seen[MOE_LAYER]
    p_l = {k: v[MOE_LAYER] for k, v in params["layers"]["moe"].items()}
    cap = moe_mod._capacity(x.shape[1], cfg, model.moe_capacity)
    slot = moe_mod.route(p_l, cfg, x, cap)[3]
    kept = (slot < cfg.num_experts * cap).reshape(x.shape[:2] + (cfg.experts_per_token,))
    want, want_kept = _moe_plain(p_l, cfg, x, cap)
    dropped = int((~want_kept).sum())
    # as served (bf16): the whole output's relative error; in fp32 (the
    # layer's weights and input upcast): every row within F32_TOL of its own
    y, _ = orig(p_l, cfg, x, capacity_factor=model.moe_capacity)
    rel_bf16 = float((y.float() - want).norm() / want.norm())
    y32, _ = orig(_upcast(p_l), dataclasses.replace(cfg, dtype="float32"), x.float(),
                  capacity_factor=model.moe_capacity)
    err, worst, ok = _close_rows(y32, want, F32_TOL)
    print(f"  moe_ffn on layer {MOE_LAYER}'s served input {tuple(x.shape)} bf16, capacity "
          f"{cap} (factor {model.moe_capacity}): {dropped} of {want_kept.numel()} (token, "
          f"choice) pairs dropped; kept sets equal: {bool(torch.equal(kept, want_kept))}; "
          f"against the fp32 plain version: bf16 output relative error {rel_bf16:.3e} (tol "
          f"{BF16_TOL}); fp32 output max_abs_err {err:.3e}, worst row {worst:.3e} of its "
          f"max |ref| (tol {F32_TOL})")
    check(bool(torch.equal(kept, want_kept)),
          "moe_ffn keeps other (token, choice) pairs than the plain version")
    check(dropped > 0, "the served prefill dropped no token at capacity 1.25")
    check(rel_bf16 <= BF16_TOL, f"moe_ffn (bf16) disagrees with the plain version: {rel_bf16}")
    check(ok, f"moe_ffn (fp32) disagrees with the plain version: worst row {worst}")
    out["moe_witness"] = {"dropped": dropped, "pairs": want_kept.numel(),
                          "bf16_rel_err": rel_bf16, "fp32_max_abs_err": err,
                          "fp32_worst_row": worst}
    # the served model's first 2 layers (with its embedding, final norm and
    # head) at full width, upcast to fp32
    params2 = _upcast(dict(params, layers=_first_layers(params["layers"], 2)))
    del res, model, params, seen, x, y, y32, want, p_l
    gc.collect()
    torch.cuda.empty_cache()

    # 2 layers at full width in fp32: the card against the CPU, and decode
    # against prefill at no-drop capacity
    cfg2 = dataclasses.replace(C.get(MOE_ARCH).full, num_layers=2, dtype="float32")
    model2 = build_model(cfg2)
    tokens = make_prompts(cfg2, WITNESS_BATCH, WITNESS_LEN, torch.device("cuda"))
    logits, cache = prefill_step(model2, params2, {"tokens": tokens})
    params_cpu = _to_cpu(params2)
    t0 = time.perf_counter()
    logits_cpu, cache_cpu = prefill_step(model2, params_cpu, {"tokens": tokens.cpu()})
    cpu_s = time.perf_counter() - t0
    rel = {"logits": _rel(logits.cpu(), logits_cpu)}
    for key in ("k", "v"):
        for layer in range(2):
            rel[f"{key}{layer}"] = _rel(cache[key][layer].cpu(), cache_cpu[key][layer])
    del params_cpu, cache, cache_cpu
    model2.moe_capacity = 0.0
    rel_decode, _ = _decode_vs_prefill(model2, params2, tokens)
    model2.moe_capacity = moe_mod.CAPACITY_FACTOR
    rel_decode_drop, _ = _decode_vs_prefill(model2, params2, tokens)
    print(f"  {MOE_ARCH} 2 layers full width fp32, prefill of {WITNESS_BATCH} x {WITNESS_LEN}: "
          f"the card against the CPU ({cpu_s:.1f} s there), relative error: last logits "
          f"{rel['logits']:.3e}, K cache {rel['k0']:.3e} / {rel['k1']:.3e}, V cache "
          f"{rel['v0']:.3e} / {rel['v1']:.3e} (layer 0 / 1; tol {F32_TOL}); decode of the last token after a prefill of the rest against the "
          f"whole prefill: {rel_decode:.3e} at no-drop capacity (tol {F32_TOL}), "
          f"{rel_decode_drop:.3e} at 1.25 (not checked: dropped tokens differ)")
    check(all(v <= F32_TOL for v in rel.values()),
          f"the card's fp32 prefill disagrees with the CPU's: {rel}")
    check(rel_decode <= F32_TOL, f"decode disagrees with prefill at no-drop: {rel_decode}")
    out["fp32_witness"] = dict(rel, decode_vs_prefill=rel_decode,
                               decode_vs_prefill_at_1_25=rel_decode_drop)
    del model2, params2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _first_layers(tree, n):
    """The first ``n`` layers of a stacked (L, ...) parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def families_serve_phase():
    """Phase B: zamba2-7b, internvl2-2b (256 frontend rows), rwkv6-1.6b and
    seamless-m4t-large-v2 (1024 frames) FULL in bf16 through
    ``launch.serve.run`` on the same requests, each freed before the next;
    the flash kernel held to attention_ref on every call of a served
    prefill (and, for seamless, of a decode step's cross-attention)."""
    import gc

    import torch
    phase(f"20. main path: serve {', '.join(FAMILY_ARCHS)} FULL, batch {SERVE_BATCH}, prompt "
          f"{SERVE_PROMPT}, {SERVE_NEW} new tokens")
    outs = {}
    for arch in FAMILY_ARCHS:
        out, res = _serve_full(arch)
        if out["flash_per_prefill"]:
            # the encoder-decoder's decode runs the cross-attention too
            out["flash_worst"] = _probe_prefill(
                arch, res, decode=res["model"].cfg.family in ("encdec", "audio"))
        outs[arch] = out
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return outs


def smoke_serve_phase():
    """Phase C: every new arch's smoke config (head_dim 16) served on the
    card, in this process through ``launch.serve.run`` with the flash calls
    held to attention_ref, and as ``python -m repro_torch.launch.serve
    --arch <arch> --smoke`` in one process each, all at once."""
    import os

    import torch
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch import serve
    phase(f"21. serve the smoke configs of {', '.join(SMOKE_ARCHS)} on the card")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {arch: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve",
                                     "--arch", arch, "--smoke"], env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for arch in SMOKE_ARCHS}
    outs = {}
    try:
        for arch in SMOKE_ARCHS:
            flash_attention_fwd.launches = 0
            res = serve.run(arch, smoke=True, device="cuda")
            launches = flash_attention_fwd.launches
            torch.cuda.synchronize()
            cfg, tokens = res["model"].cfg, res["tokens"]
            check(tokens.shape[0] == 4 and launches >= _flash_per_prefill(cfg),
                  f"{arch} smoke: flash {launches} launches, tokens {tokens.shape}")
            worst = _probe_prefill(f"{arch} smoke", res) if launches else {}
            outs[arch] = {"flash_launches": launches, "flash_worst": worst}
        for arch, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            line = stdout.strip().splitlines()[-1] if stdout.strip() else ""
            print(f"  python -m repro_torch.launch.serve --arch {arch} --smoke: rc "
                  f"{proc.returncode}: {line}")
            check(proc.returncode == 0 and line.startswith("generated (4, 16) tokens"),
                  f"launch.serve --arch {arch} --smoke failed: {stderr[-2000:]}")
            outs[arch]["cli"] = line
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


# the fleet layers (phases 24-26): the reference CLI's default trace
# (synthetic:poisson, 40 jobs at 1 job/s, seed 0: the lenet, llama3-8b and
# qwen3-moe-30b classes) on four H100 slots, each class's smoke train step
# captured on cuda fake tensors
FLEET_DEVICES = "4xh100"
FLEET_FAILURES = "mtbf:120,mttr:10"
FLEET_CHECKPOINT = "every:30"
VALIDATE_FIXTURE = ROOT / "tests" / "data" / "alibaba_fixture"


def _run_all(cmds, timeout=600):
    """Run the commands (name -> argv) at once from the repository root;
    return name -> (returncode, stdout, stderr, seconds).  Every process
    is killed at the end, whatever happens."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True, env=env, cwd=str(ROOT))
             for k, argv in cmds.items()}
    out = {}
    try:
        for k, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=timeout)
            out[k] = (proc.returncode, stdout, stderr, time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _fleet_commands():
    """Every independent command of phases 24-26 (name -> argv); they run
    all at once, beside phase 24's work in this process."""
    out_dir = ROOT / "chiprun_out" / "fleet"
    out_dir.mkdir(parents=True, exist_ok=True)
    cli = [sys.executable, "-m", "repro_torch.cluster", "--cost", "capture", "--devices",
           FLEET_DEVICES]
    return {
        "plain": cli + ["--json", str(out_dir / "cluster.json")],
        "faults": cli + ["--failures", FLEET_FAILURES, "--checkpoint", FLEET_CHECKPOINT,
                         "--json", str(out_dir / "cluster_faults.json")],
        "obs": cli + ["--timelapse", str(out_dir / "cluster_timelapse.json"), "--doctor",
                      "--validate", "--manifest", str(out_dir / "cluster_manifest.json")],
        "quickstart": [sys.executable, "-m", "repro_torch.cluster_quickstart", "--capture"],
        "analysis": [sys.executable, "-m", "repro_torch.analysis", "lenet", "--full",
                     "--timelapse", "-", "--doctor", "--manifest",
                     str(out_dir / "lenet_manifest_A.json"), "--spans", "-"],
        "doctor_lenet": [sys.executable, "-m", "repro_torch.obs", "doctor", "lenet", "--hw",
                         "h100"],
        "doctor_camping": [sys.executable, "-m", "repro_torch.obs", "doctor", "camping",
                           "--expect-top", "hbm-channel-camping"],
        "validate": [sys.executable, "-m", "repro_torch.validate", "--trace",
                     str(VALIDATE_FIXTURE), "--policy", "sjf", "--json",
                     str(out_dir / "validate.json")],
    }


def cluster_phase():
    """Phase 24: ``python -m repro_torch.cluster --cost capture --devices
    4xh100`` on the default trace, plain, with failures and checkpoints, and
    with the time-lapse, doctor, validate and manifest outputs, and
    ``python -m repro_torch.cluster_quickstart --capture`` (one process
    each, all at once); meanwhile the same plain run in this process, each
    class's capture and simulation timed (host seconds: the capture traces
    the step on fake tensors, nothing runs on the card)."""
    from repro_torch.cluster import ClusterSim, Fleet, make_policy, synthetic_trace
    from repro_torch.cluster.devices import CostModel, captured_modules
    from repro_torch.validate.queueing import validate_cluster
    phase(f"24. the fleet: python -m repro_torch.cluster --cost capture --devices {FLEET_DEVICES} "
          f"(40 jobs; capture on cuda fake tensors; host time, {CARD})")
    import threading
    out_dir = ROOT / "chiprun_out" / "fleet"
    runs = _fleet_commands()
    results = {}
    worker = threading.Thread(target=lambda: results.update(_run_all(runs)))
    worker.start()
    try:
        trace = synthetic_trace("synthetic:poisson", n_jobs=40, rate_jobs_per_s=1.0, seed=0)
        build = captured_modules(trace, device="cuda")
        capture_s = {}

        def timed(job_class):
            t0 = time.perf_counter()
            module = build(job_class)
            capture_s[job_class] = time.perf_counter() - t0
            return module
        cost = CostModel(timed)
        fleet = Fleet.from_spec(FLEET_DEVICES)
        hw = fleet.slots[0].hw
        classes = {}
        for jc in sorted({j.job_class for j in trace.jobs}):
            t0 = time.perf_counter()
            rep = cost.report(jc, hw)
            sim_s = time.perf_counter() - t0 - capture_s[jc]
            classes[jc] = {"capture_s": capture_s[jc], "simulate_s": sim_s,
                           "step_s": rep.total_seconds, "peak_hbm_bytes": rep.peak_hbm_bytes}
            print(f"  {jc}: capture {capture_s[jc]:.2f} s, simulation {sim_s:.3f} s (host); "
                  f"simulated step {rep.total_seconds * 1e3:.4f} ms on {hw.name}, peak HBM "
                  f"{rep.peak_hbm_bytes / 2**20:.2f} MiB")
            check(rep.total_seconds > 0 and rep.peak_hbm_bytes > 0, f"{jc}: an empty report")
        t0 = time.perf_counter()
        rep = ClusterSim(fleet, cost, make_policy("fifo")).run(trace)
        events_s = time.perf_counter() - t0
        s = rep.summary()
        busy = rep.reconcile_busy()
        print(f"  in process (each class priced first): makespan_s {s['makespan_s']:.6f}, goodput "
              f"{s['goodput_fraction']:.6f}, cache_hit_rate {s['cache_hit_rate']:.6f}, "
              f"reconcile_busy() {busy:.3e}; event loop {events_s:.3f} s (host)")
        check(busy <= 0.01, f"the fleet's busy time does not reconcile: {busy}")
        vrep = validate_cluster(rep)
    finally:
        worker.join()     # every process ends before the phase does
    check(set(results) == set(runs), "a fleet CLI did not finish")
    for name, (rc, stdout, stderr, wall) in results.items():
        print(f"  {' '.join(runs[name][2:])}: rc {rc}, collected {wall:.1f} s into the phase")
    rc, stdout, stderr, _ = results["plain"]
    check(rc == 0, f"the cluster CLI failed: {stderr[-2000:]}")
    doc = json.loads((out_dir / "cluster.json").read_text())
    cs = doc["summary"]
    print(f"  the CLI's run: makespan_s {cs['makespan_s']:.6f}, goodput "
          f"{cs['goodput_fraction']:.6f}, cache_hit_rate {cs['cache_hit_rate']:.6f}, "
          f"reconcile_busy() {doc['reconcile_busy_rel_error']:.3e}")
    # the same run but for the cache counters: this process priced each
    # class once before its run (3 more hits)
    counters = {"cache_hits", "cache_hit_rate"}
    mine = json.loads(json.dumps(s))
    check({k: v for k, v in cs.items() if k not in counters}
          == {k: v for k, v in mine.items() if k not in counters}
          and doc["reconcile_busy_rel_error"] <= 0.01,
          "the CLI's run is not the in-process run, or does not reconcile")
    rc, stdout, stderr, _ = results["faults"]
    check(rc == 0, f"the cluster CLI with failures failed: {stderr[-2000:]}")
    f = json.loads((out_dir / "cluster_faults.json").read_text())
    fs = f["summary"]
    print(f"  with --failures {FLEET_FAILURES} --checkpoint {FLEET_CHECKPOINT}: makespan_s "
          f"{fs['makespan_s']:.6f}, goodput {fs['goodput_fraction']:.6f}, cache_hit_rate "
          f"{fs['cache_hit_rate']:.6f}, reconcile_busy() {f['reconcile_busy_rel_error']:.3e}, "
          f"{fs['device_failures']} device failures, {fs['recoveries']} recoveries")
    check(f["reconcile_busy_rel_error"] <= 0.01 and fs["device_failures"] > 0,
          "the faulted fleet does not reconcile, or saw no failure")
    rc, stdout, stderr, _ = results["obs"]
    failed = [c.name for c in vrep.checks if not c.ok]
    print(f"  --validate: {'PASSED' if vrep.passed else 'FAILED'} in process, failed checks "
          f"{failed}, CLI rc {rc}")
    # every conservation identity holds; the M/G/k band (an approximation) is
    # reported as it comes, and the CLI's exit code must agree with it
    check(set(failed) <= {"mgk-queueing-delay"} and rc == (0 if vrep.passed else 1),
          f"the fleet's identities fail ({failed}) or the CLI disagrees (rc {rc}): "
          f"{stderr[-1500:]}")
    check("doctor:" in stdout, "the cluster CLI printed no doctor table")
    man = json.loads((out_dir / "cluster_manifest.json").read_text())
    lapse = json.loads((out_dir / "cluster_timelapse.json").read_text())
    check(man["kind"] == "cluster" and lapse["num_intervals"] == 64,
          "the cluster manifest or time-lapse is malformed")
    rc, stdout, stderr, _ = results["quickstart"]
    print(f"  python -m repro_torch.cluster_quickstart --capture: rc {rc}: "
          f"{stdout.strip().splitlines()[-1] if stdout.strip() else ''}")
    check(rc == 0, f"the cluster quickstart failed: {stderr[-2000:]}")
    return {"classes": classes, "summary": cs, "reconcile_busy": busy,
            "faults_summary": fs, "validate_failed": failed,
            "wall_s": {k: v[3] for k, v in results.items()}, "results": results}


def obs_phase(results):
    """Phase 25: ``python -m repro_torch.analysis lenet --full --timelapse -
    --doctor --manifest A --spans -`` on the card; ``python -m
    repro_torch.obs diff`` of that manifest with itself (exit 0) and with a
    copy with one number changed (exit 3, the reference's code for a
    divergence); ``obs doctor lenet --hw h100`` (a capture on the card) and
    ``obs doctor camping --expect-top hbm-channel-camping`` (run beside
    phase 24)."""
    phase(f"25. obs on the paper path: analysis --timelapse/--doctor/--manifest/--spans, obs "
          f"diff, obs doctor (host time, {CARD})")
    out_dir = ROOT / "chiprun_out" / "fleet"
    a, b = out_dir / "lenet_manifest_A.json", out_dir / "lenet_manifest_B.json"
    rc, stdout, stderr, analysis_s = results["analysis"]
    print(f"  python -m repro_torch.analysis lenet --full --timelapse - --doctor --manifest A "
          f"--spans -: rc {rc}, collected {analysis_s:.1f} s into phase 24")
    check(rc == 0, f"the analysis CLI with the obs flags failed: {stderr[-2000:]}")
    check("doctor: lenet" in stdout and '"reconcile_max_rel_error"' in stdout
          and '"traceEvents"' in stdout, "the analysis CLI's obs outputs are missing")
    man = json.loads(a.read_text())
    check(man["kind"] == "engine" and man["config"]["hw"] == "h100",
          f"the manifest is malformed: {list(man)}")
    changed = dict(man, metrics=dict(man["metrics"]))
    changed["metrics"]["total_seconds"] *= 1.5
    b.write_text(json.dumps(changed))
    rest = _run_all({
        "diff_same": [sys.executable, "-m", "repro_torch.obs", "diff", str(a), str(a)],
        "diff_changed": [sys.executable, "-m", "repro_torch.obs", "diff", str(a), str(b)]})
    rest.update({k: results[k] for k in ("doctor_lenet", "doctor_camping")})
    for name, (rc, stdout, stderr, wall) in rest.items():
        print(f"  obs {name}: rc {rc}, {wall:.1f} s")
    check(rest["diff_same"][0] == 0, f"obs diff A A: {rest['diff_same'][2][-1500:]}")
    check(rest["diff_changed"][0] == 3, f"obs diff A B: {rest['diff_changed'][2][-1500:]}")
    rc, stdout, stderr, _ = rest["doctor_lenet"]
    check(rc == 0 and "doctor:" in stdout, f"obs doctor lenet: {stderr[-1500:]}")
    print("  " + "\n  ".join(stdout.strip().splitlines()[:4]))
    check(rest["doctor_camping"][0] == 0, f"obs doctor camping: {rest['doctor_camping'][2][-1500:]}")
    return {"analysis_s": analysis_s, "codes": {k: v[0] for k, v in rest.items()}}


def validate_phase(results):
    """Phase 26: ``python -m repro_torch.validate`` on the committed Alibaba
    fixture under SJF (run beside phase 24), held to what the reference's
    ``test_fixture_passes_under_sjf`` holds: utilization at most 0.7, both
    Little's-law residuals under 1%, the M/G/k delay ungated within 25%, and
    every check passed."""
    phase(f"26. python -m repro_torch.validate --trace tests/data/alibaba_fixture --policy sjf "
          f"(host time, {CARD})")
    out = ROOT / "chiprun_out" / "fleet" / "validate.json"
    rc, stdout, stderr, wall = results["validate"]
    print(f"  rc {rc}, {wall:.1f} s: {stdout.strip().splitlines()[0] if stdout.strip() else ''}")
    check(rc == 0, f"validate failed: {stdout[-1500:]} {stderr[-1500:]}")
    doc = json.loads(out.read_text())
    by = {c["name"]: c for c in doc["checks"]}
    mgk = by["mgk-queueing-delay"]
    print(f"  utilization {doc['summary']['utilization']:.6f}; littles-law-system "
          f"{by['littles-law-system']['residual']:.3e}, littles-law-queue "
          f"{by['littles-law-queue']['residual']:.3e}, mgk-queueing-delay "
          f"{mgk['residual']:.6f} (gated {mgk['gated']})")
    check(doc["summary"]["utilization"] <= 0.7 and by["littles-law-system"]["residual"] < 0.01
          and by["littles-law-queue"]["residual"] < 0.01 and not mgk["gated"]
          and mgk["residual"] < 0.25 and doc["passed"], "the fixture fails its checks")
    return {"wall_s": wall, "mgk_residual": mgk["residual"],
            "utilization": doc["summary"]["utilization"]}


#: phase 27: the LeNet-full steps run graphed and eager from one state
JIT_LENET_STEPS = 10
#: phase 27's fallback, should the graphed and eager logits differ: the
#: llama3-8b smoke config in fp32, graphed against eager, relative
JIT_F32_TOL = 1e-5


def _first_logits(server, params, prompts, vocab):
    """The prefill's last-token logits and the first decode step's, through
    the server's compiled steps (copies: the graphs' outputs are overwritten
    by their next replay)."""
    lp, cache = server._prefill(params, {"tokens": prompts.clone()})
    lp = lp.clone()
    cache = server._decode_cache(cache, SERVE_NEW)
    tok = lp[:, -1, :vocab].float().argmax(-1)
    ld, _ = server._decode(params, cache, {"token": tok[:, None]})
    return lp, ld.clone()


def _smoke_fp32_graphed_vs_eager():
    """The largest relative gap between the llama3-8b smoke config's
    graphed and eager first logits, in fp32."""
    import dataclasses

    from repro_torch import config as C
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.runtime.jit import disable_jit
    from repro_torch.runtime.server import Server
    cfg = dataclasses.replace(C.get(SERVE_ARCH).smoke, dtype="float32")
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("serve", 48, 4, "prefill"))
    params = build_model(cfg).init(seed=serve.PARAM_SEED, device="cuda")
    prompts = serve.make_prompts(cfg, 4, 32, "cuda")
    server = Server(rc, params)
    graphed = _first_logits(server, params, prompts, cfg.vocab_size)
    with disable_jit():
        eager = _first_logits(server, params, prompts, cfg.vocab_size)
    return max(_rel(g, e) for g, e in zip(graphed, eager))


def _decode_busy(server, params, prompts, label):
    """A profile of four decode steps through the server's decode step
    after one prefill: (device busy ms a step, host window ms a step)."""
    lp, cache = server._prefill(params, {"tokens": prompts.clone()})
    state = {"cache": server._decode_cache(cache, SERVE_NEW)}
    tok = {"token": prompts[:, -1:].clone()}

    def one_decode():
        state["cache"] = server._decode(params, state["cache"], tok)[1]

    window = {}
    busy = _profile(label, one_decode, 4, top=4, window=window)
    return busy, window.get("ms")


def jit_phase(moe):
    """Phase 27: the compiled steps (``StepBundle.jit``,
    ``repro_torch.runtime.jit``: a CUDA graph a shape) against the same
    steps under ``disable_jit``.  llama3-8b FULL serving: the same tokens,
    and the prefill's last logits and the first decode step's bit for bit;
    warm prefill ms, decode tok/s and the device's busy share of a decode
    step in both modes; the flash launches inside the prefill's graph.  The
    LeNet-full step: ``JIT_LENET_STEPS`` graphed steps against as many
    eager ones from the same params and batches, bit for bit after each;
    warm step ms and busy share in both modes; the ``tiled_matmul``
    launches inside the graph.  qwen3-moe-30b-a3b FULL: phase 19 served it
    graphed; its peak beside the eager 63.59 GB of PR 17."""
    import contextlib
    import gc
    import itertools

    import torch
    from repro_torch import lenet_repro
    from repro_torch.launch import serve
    from repro_torch.runtime.jit import disable_jit
    from repro_torch.runtime.server import ServeStats
    phase(f"27. compiled steps (CUDA graphs) against eager: {SERVE_ARCH} FULL serving, the "
          f"LeNet-full step, {MOE_ARCH} FULL's peak")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve.run(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                    max_new=SERVE_NEW, device="cuda")
    server, params, prompts = res["server"], res["params"], res["prompts"]
    cfg = res["model"].cfg
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    req = {"tokens": prompts}
    graphed = server.generate(req, max_new_tokens=SERVE_NEW)
    with disable_jit():
        eager = server.generate(req, max_new_tokens=SERVE_NEW)
    check(graphed.shape == eager.shape and (graphed == eager).all()
          and (graphed == res["tokens"]).all(),
          f"{SERVE_ARCH}: graphed tokens differ from eager ones")
    gl = _first_logits(server, params, prompts, cfg.vocab_size)
    with disable_jit():
        el = _first_logits(server, params, prompts, cfg.vocab_size)
    bit_equal = all(torch.equal(g, e) for g, e in zip(gl, el))
    gaps = [_rel(g, e) for g, e in zip(gl, el)]
    print(f"  {SERVE_ARCH} FULL: tokens graphed == eager ({graphed.shape}); the prefill's last "
          f"logits and the first decode step's bit-equal: {bit_equal} (relative gaps "
          f"{gaps[0]:.3e}, {gaps[1]:.3e})")
    out = {"card": CARD, "tokens_equal": True, "logits_bit_equal": bit_equal,
           "logit_gaps": gaps, "peak_gb": peak_gb}
    if not bit_equal:
        rel32 = _smoke_fp32_graphed_vs_eager()
        print(f"  not bit-equal: the smoke config in fp32, graphed against eager, relative "
              f"{rel32:.3e} (tol {JIT_F32_TOL})")
        check(rel32 <= JIT_F32_TOL, f"graphed logits {rel32} off the eager ones in fp32")
        out["smoke_fp32_gap"] = rel32
    flash_in_graph = server._prefill.last.launches["flash_attention_fwd"]
    check(flash_in_graph == cfg.num_layers,
          f"the prefill graph holds {flash_in_graph} flash launches, expected {cfg.num_layers}")
    for mode, ctx in (("graphed", contextlib.nullcontext), ("eager", disable_jit)):
        with ctx():
            for _ in range(2):                 # the second call is timed
                server.stats = ServeStats()
                server.generate(req, max_new_tokens=SERVE_NEW)
            busy, window = _decode_busy(server, params, prompts, f"{mode} decode step")
        share = f"{100 * busy / window:.1f}%" if busy and window else "not measured"
        out[mode] = {"prefill_ms": server.stats.prefill_s * 1e3,
                     "decode_tok_per_s": server.stats.decode_tok_per_s,
                     "decode_busy_ms": busy, "decode_window_ms": window}
        print(f"  {SERVE_ARCH} FULL {mode}, warm: prefill {out[mode]['prefill_ms']:.1f} ms, "
              f"decode {out[mode]['decode_tok_per_s']:.1f} tok/s, a decode step's device "
              f"busy {share}; {CARD}")
    out["flash_in_prefill_graph"] = flash_in_graph
    print(f"  flash launches inside the prefill's graph: {flash_in_graph}; peak memory "
          f"{peak_gb:.2f} GB over the first call (weights drawn on the card included)")
    del res, server, params, prompts, req
    gc.collect()
    torch.cuda.empty_cache()

    model = lenet_repro.new_model("cuda")
    batches = list(itertools.islice(lenet_repro.device_batches(model, seed=2),
                                    JIT_LENET_STEPS))
    step = lenet_repro.compiled_step(model)
    pg = {k: v.clone() for k, v in model.param_dict().items()}
    pe = {k: v.clone() for k, v in model.param_dict().items()}
    for i, (x, y) in enumerate(batches):
        with disable_jit():
            pe, loss_e, _ = step(pe, x, y)
        pg, loss_g, _ = step(pg, x, y)
        check(torch.equal(loss_g, loss_e) and all(torch.equal(pg[k], pe[k]) for k in pe),
              f"the graphed LeNet step's params differ from the eager step's after step {i}")
    mm_in_graph = step.last.launches["tiled_matmul"]
    check(mm_in_graph == 3 * len(LENET_FWD) - 1,
          f"the LeNet step's graph holds {mm_in_graph} tiled_matmul launches")
    print(f"  LeNet-full: {JIT_LENET_STEPS} graphed steps against {JIT_LENET_STEPS} eager "
          f"ones from the same params and batches: params and loss bit-equal after each; "
          f"tiled_matmul launches inside the graph: {mm_in_graph}")
    out["lenet"] = {"steps_bit_equal": JIT_LENET_STEPS, "tiled_matmul_in_graph": mm_in_graph}
    for mode, ctx in (("graphed", contextlib.nullcontext), ("eager", disable_jit)):
        state = {"p": pg, "i": 0}

        def one_step():
            x, y = batches[state["i"] % len(batches)]
            state["i"] += 1
            state["p"] = step(state["p"], x, y)[0]

        with ctx():
            ms = _time_ms(one_step, reps=10, warmup=3)
            window = {}
            busy = _profile(f"{mode} LeNet step", one_step, 5, top=4, window=window)
        pg = state["p"]
        share = (f"{100 * busy / window['ms']:.1f}%" if busy and window.get("ms")
                 else "not measured")
        out["lenet"][mode] = {"step_ms": ms, "busy_ms": busy, "window_ms": window.get("ms")}
        print(f"  LeNet-full {mode} step, warm: {ms:.3f} ms (CUDA events, mean of 10), "
              f"device busy {share}; {CARD}")
    del step, model, batches, pg, pe
    gc.collect()
    torch.cuda.empty_cache()

    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    moe_peak = max(moe["peak_gb"], moe["peak_first_call_gb"])
    print(f"  {MOE_ARCH} FULL served graphed (phase 19): peak {moe['peak_first_call_gb']:.2f} GB "
          f"over the first call (init, warm-up and capture included), {moe['peak_gb']:.2f} GB "
          f"warm, beside 63.59 GB eager (PR 17); the card holds {card_gb:.2f} GB")
    check(moe_peak < card_gb, f"{MOE_ARCH} graphed peaks at {moe_peak:.2f} GB")
    out["moe_peak_gb"] = {"first_call": moe["peak_first_call_gb"], "warm": moe["peak_gb"]}
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: FAIL: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        import torch
        name, idle = device_phase()
        build_phase()
        mm_err = matmul_phase()
        wino_errs = winograd_phase()
        flash_err = flash_phase()
        launches, pps, lenet = main_path_phase()
        kernels = timing_phase(launches, pps, mm_err, wino_errs)
        step = step_phase()
        res, serve_launches = serve_phase()
        serve_sim = serve_sim_phase(res)
        kernels.append(flash_timing_phase(serve_launches, flash_err))
        correlation = correlation_phase(lenet, step, res, serve_sim)
        power = power_phase(lenet, step, res, serve_sim, idle)
        gemma = res["gemma"]
        del res, serve_sim
        analysis_phase(lenet)
        train = train_phase()
        train["sim"] = train_sim_phase(train)
        train["witness"] = train_witness_phase()
        trainer_phase()
        families = {MOE_ARCH: moe_serve_phase()}
        families.update(families_serve_phase())
        smokes = smoke_serve_phase()
        meshed = mesh_phase(train)
        dryrun = dryrun_phase(meshed)
        fleet = {"cluster": cluster_phase()}
        results = fleet["cluster"].pop("results")
        fleet.update(obs=obs_phase(results), validate=validate_phase(results))
        graphs = jit_phase(families[MOE_ARCH])
        kernels[0]["launches_in_graph"] = {
            "one LeNet-full step": graphs["lenet"]["tiled_matmul_in_graph"]}
        flash = kernels[-1]
        flash["launches_by_path"] = {
            f"serve {SERVE_ARCH} FULL": serve_launches["flash_attention"],
            f"serve {GEMMA_ARCH} FULL": gemma["launches"],
            f"train {TRAIN_ARCH} FULL ({TRAIN_STEPS} steps)":
                train["launches"]["flash_attention"]}
        for arch, out in families.items():
            flash["launches_by_path"][f"serve {arch} FULL"] = out["launches"]["flash_attention"]
            flash["launches_by_path"][f"one {arch} FULL prefill"] = out["flash_per_prefill"]
        for arch, out in smokes.items():
            flash["launches_by_path"][f"serve {arch} smoke"] = out["flash_launches"]
        flash["launches_by_path"][f"train {TRAIN_ARCH} FULL on the (1, 1) mesh, Trainer "
                                  f"({MESH_STEPS} steps, batch {meshed['batch']}, local_map)"] = \
            meshed["flash_launches"]
        flash["attention_backward_ms_per_train_step"] = train["attn_bwd_ms_step"]
        flash["launches_in_graph"] = {f"one {SERVE_ARCH} FULL prefill":
                                      graphs["flash_in_prefill_graph"]}
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_analysis.json").write_text(json.dumps(
            {"correlation": correlation, "power": power, "gemma": gemma, "train": train,
             "families": families, "smoke": smokes, "mesh": meshed, "dryrun": dryrun,
             "fleet": fleet, "graphs": graphs},
            indent=1, default=str))
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
