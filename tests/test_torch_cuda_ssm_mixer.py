"""The Mamba2 mixer kernels (``csrc/ssm_mixer.cu``) on the card, each
against the plain chain it replaces (``models/ssm.py``'s steps) run in fp32
on the same inputs.

Every test here needs an NVIDIA GPU and ``nvcc``, is marked ``cuda``, and
skips without a card.  The file imports no ``jax``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_ssm_mixer.py

Limits: each output is rounded once from fp32, so it lies within half a
unit in the last place of the fp32 chain's value (2^-8 of it in bf16,
2^-11 in fp16), plus 1e-5 of it for the fp32 arithmetic's own differences
(``__expf`` in SiLU, ``rsqrtf``, the order of the norm's sums) and 1e-6 of
the largest value for fp16's subnormals; dA, in fp32 throughout, 1e-5.  And
over each whole output the kernels are no further from the fp32 chain than
the 16-bit plain chain, which rounds three to five times.
"""
import dataclasses

import pytest
import torch

from repro_torch import config as C
from repro_torch.kernels.ssd_scan.kernel import readable
from repro_torch.kernels.ssd_scan.ops import positions_major
from repro_torch.kernels.ssm_mixer import (scan_inputs, ssm_conv_in, ssm_conv_in_op,
                                           ssm_gated_norm, ssm_gated_norm_op)
from repro_torch.models import ssm

HALF_ULP = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
DTYPES = [torch.bfloat16, torch.float16]
#: (b, s, d_inner, groups, n): the published Zamba2's widths (d 3,584) at
#: 256 positions and 300 (off 8), HybridLM's smoke widths (d 64, one group
#: of 16: rows of 290 channels, off 16 bytes), and prompts shorter than the
#: conv's window
SHAPES = [(2, 256, 7168, 2, 64), (2, 300, 7168, 2, 64), (2, 300, 128, 1, 16),
          (3, 77, 128, 1, 16), (1, 5, 256, 2, 16), (2, 2, 128, 1, 16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cfg(d_inner, n):
    return dataclasses.replace(C.get("zamba2-7b").smoke, d_model=d_inner // 2, ssm_state=n,
                               norm_eps=1e-5)


def _layer(b, s, d_inner, groups, n, dtype, seed=0):
    """The in_proj output at unit scale and a layer's mixer parameters:
    Mamba2's decays and steps, random conv weights, D and gammas."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    heads, ch = d_inner // 64, d_inner + 2 * groups * n

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    params = {"conv_w": 0.5 * randn(4, ch), "conv_b": 0.1 * randn(ch),
              "dt_bias": torch.log(torch.expm1(0.001 + 0.1 * rand(heads))),
              "a_log": torch.log(1 + 15 * rand(heads)), "d_skip": 1 + 0.1 * randn(heads),
              "norm": 0.1 * randn(d_inner)}
    zxbcdt = randn(b, s, d_inner + ch + heads).to(dtype)
    return zxbcdt, {k: v.to(dtype) for k, v in params.items()}


def _within_one_rounding(got, want, dtype):
    got, want = got.float(), want.float()
    tol = (HALF_ULP[dtype] + 1e-5) * want.abs() + 1e-6 * want.abs().max()
    return bool(((got - want).abs() <= tol).all())


def _no_further(got, plain, want):
    """The kernel's output no further from the fp32 chain than the 16-bit
    plain chain's, over the whole tensor."""
    return float((got.float() - want).norm()) <= float((plain.float() - want).norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,d_inner,groups,n", SHAPES)
def test_conv_in_matches_the_fp32_chain(cuda, b, s, d_inner, groups, n, dtype):
    """xdt, B and C (through the views the scan gets, read as they lie),
    xh and dA against the model's plain conv and dt steps in fp32; the
    decode cache's raw rows bit for bit; the padding zeros.  One launch."""
    zxbcdt, params = _layer(b, s, d_inner, groups, n, dtype, seed=s)
    cfg = _cfg(d_inner, n)
    keys = ("conv_w", "conv_b", "dt_bias", "a_log")
    before = ssm_conv_in.launches
    xbc, dA, xh, tail = ssm_conv_in_op(zxbcdt, *(params[k] for k in keys), d_inner)
    torch.cuda.synchronize()
    assert ssm_conv_in.launches == before + 1
    views = scan_inputs(xbc, dA, d_inner, groups)
    assert all(readable(t) and positions_major(t) is t for t in (views[0], views[2], views[3]))
    assert bool((xbc[..., s:] == 0).all())
    p32 = {k: v.float() for k, v in params.items()}
    _, xh32, xdt32, dA32, B32, C32, raw = ssm._mixer_inputs(p32, cfg, zxbcdt.float(), groups)
    _, xh16, xdt16, _, B16, C16, _ = ssm._mixer_inputs(params, cfg, zxbcdt, groups)
    for got, plain, want in ((views[0], xdt16, xdt32), (views[2], B16, B32),
                             (views[3], C16, C32), (xh, xh16.flatten(-2), xh32.flatten(-2))):
        assert _no_further(got, plain, want)
    for got, want in ((views[0], xdt32), (views[2], B32), (views[3], C32),
                      (xh, xh32.flatten(-2))):
        assert got.shape == want.shape and _within_one_rounding(got, want, dtype)
    assert bool(((views[1] - dA32).abs() <= 1e-5 * dA32.abs() + 1e-7).all())
    assert torch.equal(tail, raw[:, -3:].to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,d_inner,groups,n", SHAPES)
def test_gated_norm_matches_the_fp32_chain(cuda, b, s, d_inner, groups, n, dtype):
    """(y + D xh) silu(z), normed by group, against the model's plain skip,
    gate and norm in fp32.  One launch."""
    zxbcdt, params = _layer(b, s, d_inner, groups, n, dtype, seed=s + 1)
    heads = d_inner // 64
    gen = torch.Generator(device="cuda").manual_seed(s)
    y = torch.randn(b, s, heads, 64, generator=gen, device="cuda").to(dtype)
    xh = torch.randn(b, s, d_inner, generator=gen, device="cuda").to(dtype)
    cfg = _cfg(d_inner, n)
    before = ssm_gated_norm.launches
    out = ssm_gated_norm_op(y, xh, zxbcdt, params["d_skip"], params["norm"], groups,
                            cfg.norm_eps)
    torch.cuda.synchronize()
    assert ssm_gated_norm.launches == before + 1
    p32 = {k: v.float() for k, v in params.items()}
    want = ssm._mixer_gate(p32, cfg, y.float(), xh.float().unflatten(-1, (heads, 64)),
                           zxbcdt[..., :d_inner].float(), groups)
    assert (out.dtype, out.shape) == (dtype, want.shape)
    assert _within_one_rounding(out, want, dtype)
    plain = ssm._mixer_gate(params, cfg, y, xh.unflatten(-1, (heads, 64)),
                            zxbcdt[..., :d_inner], groups)
    assert _no_further(out, plain, want)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [2, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_calls_give_the_same_bits(cuda, dtype, groups):
    """Eight calls of each kernel on the same inputs give the first's
    bits, at the published Zamba2's widths in two groups and in one (the
    norm's sum over 896 vectors a group)."""
    zxbcdt, params = _layer(2, 300, 7168, groups, 64, dtype)
    args = (zxbcdt, params["conv_w"], params["conv_b"], params["dt_bias"], params["a_log"], 7168)
    first = ssm_conv_in_op(*args)
    for _ in range(7):
        assert all(torch.equal(a, b) for a, b in zip(first, ssm_conv_in_op(*args)))
    y = torch.randn(2, 300, 112, 64, device="cuda").to(dtype)
    gate = (y, first[2], zxbcdt, params["d_skip"], params["norm"], groups, 1e-5)
    out = ssm_gated_norm_op(*gate)
    for _ in range(7):
        assert torch.equal(ssm_gated_norm_op(*gate), out)


def _smoke(arch, dtype="bfloat16"):
    from repro_torch.models import build_model
    cfg = dataclasses.replace(C.get(arch).smoke, dtype=dtype)
    model = build_model(cfg)
    return cfg, model


def _upcast(tree):
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


@pytest.mark.cuda
@pytest.mark.parametrize("s", [320, 300])
@pytest.mark.parametrize("arch", ["zamba2-7b", "zamba2-7b-instruct"])
def test_a_16_bit_prefill_through_the_kernels_against_the_plain_prefill(cuda, arch, s,
                                                                       monkeypatch):
    """The smoke configs' bf16 logits through the kernels (one launch of
    each a layer) and through the plain code, each against the plain code
    in fp32 on the same weights: the kernels no further off, up to a
    quarter more for the rounding's luck over seven layers."""
    cfg, model = _smoke(arch)
    params = model.init(seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, s), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(s))
    before = ssm_conv_in.launches, ssm_gated_norm.launches
    with torch.no_grad():
        got, _ = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        assert (ssm_conv_in.launches - before[0], ssm_gated_norm.launches - before[1]) == (
            cfg.num_layers, cfg.num_layers)
        cfg32, model32 = _smoke(arch, "float32")
        want, _ = model32.prefill(_upcast(params), {"tokens": tokens})
        monkeypatch.setattr(ssm, "mixer_route", lambda *a: "plain")
        plain, _ = model.prefill(params, {"tokens": tokens})
    assert bool(torch.isfinite(got.float()).all())
    gap = float((got.float() - want).norm() / want.norm())
    plain_gap = float((plain.float() - want).norm() / want.norm())
    assert gap <= 1.25 * plain_gap, (gap, plain_gap)


@pytest.mark.cuda
def test_a_captured_prefill_counts_both_launchers_once_a_layer_at_each_replay(cuda):
    """zamba2-7b-instruct's smoke prefill compiled: the capture holds one
    launch of each kernel a layer, each replay adds them, and the replay
    gives the eager call's bits."""
    from repro_torch.runtime.jit import disable_jit, jit
    from repro_torch.runtime.steps import prefill_step
    cfg, model = _smoke("zamba2-7b-instruct")
    params = model.init(seed=0, device="cuda")
    step = jit(lambda p, batch: prefill_step(model, p, batch))
    layers = cfg.num_layers
    for i in range(3):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 300), device="cuda",
                                         generator=torch.Generator(device="cuda").manual_seed(i))}
        with disable_jit():
            want, _ = step(params, batch)
        before = ssm_conv_in.launches, ssm_gated_norm.launches
        got, _ = step(params, batch)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        if i == 2:   # a replay
            assert (step.last.launches["ssm_conv_in"],
                    step.last.launches["ssm_gated_norm"]) == (layers, layers)
            assert (ssm_conv_in.launches - before[0],
                    ssm_gated_norm.launches - before[1]) == (layers, layers)
