"""The port's CUDA kernels on the card, against their plain versions.

Every kernel test here needs an NVIDIA GPU and ``nvcc`` (the kernels have
no CPU mode), is marked ``cuda``, and skips without a card.  The file
imports no ``jax``, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance, of the output's largest magnitude: fp32 1e-4 and bf16 2e-2 (the
kernel sums in another order than the library; over K = 100,352 terms the
error grows with the output), Winograd 1e-4 (fp32) and 2e-2 (bf16) against
its plain version and 4e-4 against the direct conv (the transforms add
roundings of their own), flash attention 2e-3 (fp32) and 2e-2 (bf16), as
the reference kernel tests hold the Pallas kernel.  fp16: 1.2e-3 in all
three, a little over one fp16 ulp (2**-10) of the scale, which a kernel
that accumulates in fp32 and rounds once stays within; the one test here
that runs without a card shows that the plain version on operands rounded
to bf16 misses that limit at these shapes, so a kernel that took a bf16
route would fail it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS, attention_lse_ref,
                                                 attention_ref, flash_attention,
                                                 flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.tiled_matmul import BLOCK_CONFIGS, matmul, matmul_ref, tiled_matmul
from repro_torch.kernels.tiled_matmul.kernel import split_k_plan
from repro_torch.kernels.winograd import (conv3x3_ref, conv3x3_winograd,
                                          conv3x3_winograd_ref, filter_transform,
                                          winograd_conv, winograd_tiles,
                                          winograd_tiles_ref)
from repro_torch.kernels.winograd.kernel import kernel_smem_bytes, smem_bytes

MM_SHAPES = [(128, 128, 128), (200, 300, 150), (64, 512, 32), (257, 129, 65),
             (100352, 25, 6), (25, 100352, 6),
             (100, 30, 50),     # K smaller than block_k
             (64, 5000, 32)]    # 16 K-splits of 5 slabs, the last one ragged
# the reference's test shapes, the section V case study and a ResNet-50
# conv2_x layer at batch 32
WINO_CASES = [(1, 8, 4, 8), (2, 14, 8, 16), (1, 13, 3, 5), (1, 10, 64, 64),
              (64, 28, 16, 32), (32, 56, 64, 64)]
#: every kernel takes the three float dtypes the reference kernels are run in
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, *shape, device):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _err(out, ref):
    return float((out.float() - ref.float()).abs().max()), \
        max(1.0, float(ref.float().abs().max()))


#: fp16: a little over one fp16 ulp of the scale (see the module's docstring)
F16_TOL = 1.2e-3


def _tol(dtype):
    return {torch.float32: 1e-4, torch.float16: F16_TOL}.get(dtype, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_matmul_kernel(cuda, m, k, n, dtype):
    a = _randn(4, m, k, device=cuda).to(dtype)
    b = _randn(5, k, n, device=cuda).to(dtype)
    before = tiled_matmul.launches
    out = tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (m, n)
    err, scale = _err(out, matmul_ref(a, b))
    assert err <= _tol(dtype) * scale


# the weight gradients of conv1 and conv2 (LeNet-full, batch 128) as the
# backward hands them in: A^T is a transposed view (a 100- and a 600-byte
# row stride), dY is contiguous
SPLIT_K_GRADS = [(100352, 25, 6), (12800, 150, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SPLIT_K_GRADS, ids=["dw0", "dw1"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiled_matmul_split_k_weight_gradients(cuda, m, k, n, dtype):
    a = _randn(4, m, k, device=cuda).to(dtype)
    dy = _randn(5, m, n, device=cuda).to(dtype)
    assert split_k_plan(k, n, m, 64, 64, 64,
                        torch.cuda.get_device_properties(cuda).multi_processor_count) >= 2
    before = tiled_matmul.launches
    out = tiled_matmul(a.t(), dy)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1      # one per product, whatever the splits
    err, scale = _err(out, matmul_ref(a.t(), dy))
    assert err <= _tol(dtype) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,transposed", [(100352, 25, 6, True), (12800, 150, 16, True),
                                              (64, 5000, 32, False), (100, 30, 50, False)])
def test_tiled_matmul_repeats_bit_for_bit(cuda, m, k, n, transposed):
    """The splits are summed in a fixed order, without atomics."""
    if transposed:
        a, b = _randn(4, m, k, device=cuda).t(), _randn(5, m, n, device=cuda)
    else:
        a, b = _randn(4, m, k, device=cuda), _randn(5, k, n, device=cuda)
    first = tiled_matmul(a, b)
    for _ in range(3):
        assert torch.equal(tiled_matmul(a, b), first)


@pytest.mark.cuda
@pytest.mark.parametrize("block", BLOCK_CONFIGS)
def test_tiled_matmul_block_sweep(cuda, block):
    a, b = _randn(4, 256, 256, device=cuda), _randn(5, 256, 256, device=cuda)
    out = tiled_matmul(a, b, block_m=block[0], block_n=block[1], block_k=block[2])
    err, scale = _err(out, matmul_ref(a, b))
    assert err <= 1e-4 * scale


@pytest.mark.cuda
def test_tiled_matmul_op_gradient_runs_the_kernel(cuda):
    """The op's backward (dA = dY B^T, dB = A^T dY) launches the same kernel
    on transposed views, without copies."""
    a = _randn(1, 300, 70, device=cuda).requires_grad_()
    b = _randn(2, 70, 40, device=cuda).requires_grad_()
    g = _randn(3, 300, 40, device=cuda)
    before = tiled_matmul.launches
    (matmul(a, b) * g).sum().backward()
    assert tiled_matmul.launches == before + 3
    ea, sa = _err(a.grad, g @ b.detach().t())
    eb, sb = _err(b.grad, a.detach().t() @ g)
    assert ea <= 1e-4 * sa and eb <= 1e-4 * sb


@pytest.mark.cuda
def test_tiled_matmul_refuses_what_it_does_not_take(cuda):
    a = _randn(1, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        tiled_matmul(a.double(), a.double())
    with pytest.raises(TypeError):
        tiled_matmul(a.half(), a.bfloat16())
    with pytest.raises(ValueError):
        tiled_matmul(a, a[:4])
    with pytest.raises(ValueError):
        tiled_matmul(a, a.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,cin,cout", WINO_CASES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_winograd_kernel(cuda, b, hw, cin, cout, padding, dtype):
    """The fused conv against its plain version in its own dtype (and, in
    fp32, against the direct conv), and the tiles entry against
    winograd_tiles_ref."""
    x = _randn(6, b, hw, hw, cin, device=cuda).to(dtype)
    w = _randn(7, 3, 3, cin, cout, device=cuda).to(dtype)
    before = (winograd_conv.launches, winograd_tiles.launches)
    out = conv3x3_winograd(x, w, padding)
    torch.cuda.synchronize()
    assert (winograd_conv.launches, winograd_tiles.launches) == (before[0] + 1, before[1])
    assert out.dtype == dtype
    u = filter_transform(w, dtype)
    ref = conv3x3_winograd_ref(x, u, padding)
    assert out.shape == ref.shape
    err, scale = _err(out, ref)
    assert err <= _tol(dtype) * scale
    if dtype == torch.float32:
        err, scale = _err(out, conv3x3_ref(x, w, padding))
        assert err <= 4e-4 * scale
    tiles = _randn(8, b, 3, 4, 4, 4, cin, device=cuda).to(dtype)
    u = _randn(9, 4, 4, cin, cout, device=cuda).to(dtype)
    y = winograd_tiles(tiles, u)
    assert winograd_tiles.launches == before[1] + 1 and y.dtype == dtype
    err, scale = _err(y, winograd_tiles_ref(tiles, u))
    assert err <= _tol(dtype) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("view", ["channel_slice", "transposed", "shifted"])
def test_winograd_conv_takes_strided_x(cuda, dtype, view):
    """x with a unit channel stride but other strides of its own: a slice
    of wider pixels (16-byte rows), a spatial transpose, and a slice one
    channel in (rows off a 16-byte boundary)."""
    big = _randn(10, 2, 13, 15, 40, device=cuda).to(dtype)
    x = {"channel_slice": big[..., :32], "transposed": big[..., :32].transpose(1, 2),
         "shifted": big[..., 1:33]}[view]
    assert not x.is_contiguous() and x.stride(3) == 1
    u = filter_transform(_randn(11, 3, 3, 32, 24, device=cuda), dtype)
    for padding in ("SAME", "VALID"):
        out = winograd_conv(x, u, padding)
        err, scale = _err(out, conv3x3_winograd_ref(x, u, padding))
        assert err <= _tol(dtype) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_winograd_repeats_bit_for_bit(cuda, dtype):
    """No atomics and no sum across blocks."""
    x = _randn(12, 8, 28, 28, 64, device=cuda).to(dtype)
    u = filter_transform(_randn(13, 3, 3, 64, 64, device=cuda), dtype)
    first = winograd_conv(x, u, "SAME")
    tiles = _randn(14, 8, 14, 14, 4, 4, 64, device=cuda).to(dtype)
    first_t = winograd_tiles(tiles, u)
    for _ in range(3):
        assert torch.equal(winograd_conv(x, u, "SAME"), first)
        assert torch.equal(winograd_tiles(tiles, u), first_t)


@pytest.mark.cuda
def test_winograd_plan_matches_the_compiled_kernel(cuda):
    for dtype in DTYPES:
        for image in (True, False):
            assert kernel_smem_bytes(dtype, image) == smem_bytes(dtype, image)


@pytest.mark.cuda
def test_winograd_op_gradient(cuda):
    """Forward through the fused kernel, backward recomputed through the
    plain version: the gradients of the direct conv."""
    x = _randn(15, 2, 9, 9, 3, device=cuda).requires_grad_()
    w = _randn(16, 3, 3, 3, 5, device=cuda).requires_grad_()
    g = _randn(17, 2, 9, 9, 5, device=cuda)
    before = winograd_conv.launches
    (conv3x3_winograd(x, w, "SAME") * g).sum().backward()
    assert winograd_conv.launches == before + 1
    xr, wr = (t.detach().clone().requires_grad_() for t in (x, w))
    (conv3x3_ref(xr, wr, "SAME") * g).sum().backward()
    for mine, ref in ((x.grad, xr.grad), (w.grad, wr.grad)):
        err, scale = _err(mine, ref)
        assert err <= 4e-4 * scale


@pytest.mark.cuda
def test_winograd_refuses_what_it_does_not_take(cuda):
    tiles = _randn(1, 1, 2, 2, 4, 4, 8, device=cuda)
    u = _randn(2, 4, 4, 8, 16, device=cuda)
    x = _randn(3, 1, 6, 6, 8, device=cuda)
    launches = (winograd_conv.launches, winograd_tiles.launches)
    with pytest.raises(TypeError):
        winograd_tiles(tiles.double(), u.double())
    with pytest.raises(TypeError):
        winograd_conv(x.double(), u.double())
    with pytest.raises(TypeError):
        winograd_conv(x.half(), u.bfloat16())
    with pytest.raises(TypeError):
        winograd_conv(x, u.bfloat16())
    with pytest.raises(ValueError):
        winograd_tiles(tiles, u[:, :, :4])
    with pytest.raises(ValueError):
        winograd_conv(x, u[:, :, :4].contiguous())
    with pytest.raises(ValueError):
        winograd_tiles(tiles.transpose(1, 2), u)
    with pytest.raises(ValueError, match="channel stride"):
        winograd_conv(x.transpose(2, 3), u[:, :, :6].contiguous())
    with pytest.raises(ValueError):
        winograd_conv(x, u.cpu())
    with pytest.raises(ValueError):
        winograd_conv(x, u, "FULL")
    with pytest.raises(ValueError):
        winograd_conv(x[:, :2], u, "VALID")
    assert (winograd_conv.launches, winograd_tiles.launches) == launches


# GQA groups 1, 2, 4 and 8 over head dims 16, 32, 64, 112, 128 and 256;
# lengths on and off the 16-bit kernel's 128-row tiles (and d 256's 64-key
# tiles)
FLASH_SHAPES = [(1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
                (1, 4, 4, 384, 64), (2, 8, 2, 200, 128), (1, 4, 2, 77, 64),
                (1, 8, 8, 77, 128), (1, 8, 1, 1, 32), (1, 16, 4, 2000, 128),
                (2, 4, 2, 200, 16), (1, 4, 4, 77, 16), (1, 4, 2, 300, 112),
                (2, 8, 8, 128, 112), (1, 4, 2, 300, 256), (2, 16, 8, 256, 256),
                (1, 2, 1, 77, 256)]
# windows of 64 and 200 cross the 128-key tiles' edges
FLASH_MASKS = [(True, 0, 0.0), (True, 64, 0.0), (False, 0, 0.0), (True, 0, 30.0),
               (False, 64, 30.0), (True, 200, 0.0)]


def _flash_tol(dtype):
    return {torch.float32: 2e-3, torch.float16: F16_TOL}.get(dtype, 2e-2)


def _to_bf16(*xs):
    return [x.bfloat16().half() for x in xs]


@pytest.mark.parametrize("kind,shape,padding",
                         [("mm", s, None) for s in MM_SHAPES]
                         + [("wino", c, p) for c in WINO_CASES for p in ("SAME", "VALID")]
                         + [("tiles", c, None) for c in WINO_CASES]
                         + [("flash", s, None) for s in FLASH_SHAPES])
def test_the_fp16_limit_rejects_operands_rounded_to_bf16(kind, shape, padding):
    """On the CPU, with the fp16 kernel tests' own inputs: the plain version
    on operands rounded to bf16 misses the fp16 limit (flash: with the
    causal mask), so the card tests can tell an fp16 route from a bf16 one."""
    cpu, f16 = torch.device("cpu"), torch.float16
    if kind == "mm":
        m, k, n = shape
        a, b = _randn(4, m, k, device=cpu).half(), _randn(5, k, n, device=cpu).half()
        out, ref = matmul_ref(*_to_bf16(a, b)), matmul_ref(a, b)
    elif kind == "wino":
        b, hw, cin, cout = shape
        x = _randn(6, b, hw, hw, cin, device=cpu).half()
        w = _randn(7, 3, 3, cin, cout, device=cpu).half()
        xb, wb = _to_bf16(x, w)
        out = conv3x3_winograd_ref(xb, filter_transform(wb, f16), padding)
        ref = conv3x3_winograd_ref(x, filter_transform(w, f16), padding)
    elif kind == "tiles":
        b, hw, cin, cout = shape
        tiles = _randn(8, b, 3, 4, 4, 4, cin, device=cpu).half()
        u = _randn(9, 4, 4, cin, cout, device=cpu).half()
        out, ref = winograd_tiles_ref(*_to_bf16(tiles, u)), winograd_tiles_ref(tiles, u)
    else:
        q, k, v = _flash_inputs(*shape, dtype=f16, device=cpu)
        out, ref = attention_ref(*_to_bf16(q, k, v)), attention_ref(q, k, v)
    err, scale = _err(out, ref)
    assert err > F16_TOL * scale


def _flash_inputs(b, h, kv, s, d, t=None, dtype=torch.float32, device=None):
    t = s if t is None else t
    return [_randn(seed, *shape, device=device).to(dtype) for seed, shape in
            ((11, (b, h, s, d)), (12, (b, kv, t, d)), (13, (b, kv, t, d)))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window,softcap", FLASH_MASKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel(cuda, b, h, kv, s, d, causal, window, softcap, dtype):
    q, k, v = _flash_inputs(b, h, kv, s, d, dtype=dtype, device=cuda)
    before = flash_attention_fwd.launches
    out = flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    err, scale = _err(out, attention_ref(q, k, v, causal=causal, window=window,
                                         softcap=softcap))
    assert err <= _flash_tol(dtype) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("s,t", [(200, 200), (256, 200), (128, 200), (1, 300), (77, 77),
                                 (1, 1), (2000, 2000), (77, 333)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 16, 112, 256])
def test_flash_attention_ragged(cuda, s, t, causal, window, dtype, d):
    """Ragged s != t, masked in the kernel: held to attention_ref (the
    reference wrapper's unmasked pads are wrong for causal s > t)."""
    q, k, v = _flash_inputs(1, 4, 2, s, d, t=t, dtype=dtype, device=cuda)
    out = flash_attention(q, k, v, causal=causal, window=window)
    err, scale = _err(out, attention_ref(q, k, v, causal=causal, window=window))
    assert err <= _flash_tol(dtype) * scale


@pytest.mark.cuda
def test_flash_attention_takes_the_models_layout(cuda):
    """(b, s, heads, d) activations go in as transposed views, without
    copies; the output is laid out like q."""
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in
               _flash_inputs(2, 32, 8, 300, 128, dtype=torch.bfloat16, device=cuda))
    out = flash_attention_fwd(q, k, v, causal=True)
    assert out.stride() == q.stride()
    err, scale = _err(out, attention_ref(q, k, v, causal=True))
    assert err <= 2e-2 * scale


@pytest.mark.cuda
def test_flash_attention_op_gradient(cuda):
    """Forward through the kernel, backward recomputed through attention_ref
    (fp32: the backward kernel takes 16-bit inputs only)."""
    q, k, v = (x.requires_grad_() for x in _flash_inputs(1, 4, 2, 128, 64, device=cuda))
    g = _randn(14, 1, 4, 128, 64, device=cuda)
    before, before_bwd = flash_attention_fwd.launches, flash_attention_bwd.launches
    (flash_attention(q, k, v, causal=True, window=64) * g).sum().backward()
    assert flash_attention_fwd.launches == before + 1
    assert flash_attention_bwd.launches == before_bwd
    refs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    (attention_ref(*refs, causal=True, window=64) * g).sum().backward()
    for mine, ref in zip((q, k, v), refs):
        err, scale = _err(mine.grad, ref.grad)
        assert err <= 2e-3 * scale


#: the backward kernel against autograd through attention_ref in fp32, of
#: each gradient's largest magnitude: the kernel rounds P and dS to the
#: input's 16-bit type before their products (as the forward rounds P), and
#: each gradient once, every rounding within half an ulp and their errors
#: partly cancelling over the keys or queries summed, so the limit is four
#: ulps of the type at the scale (bf16 4 * 2**-8, fp16 4 * 2**-11).  On the
#: H100 the worst of 22 cases read 6.0e-3 and 6.2e-4; rounding the fp32
#: gradients alone reads up to 3.6e-3 and 3.7e-4.
BWD_TOL = {torch.bfloat16: 4 * 2.0 ** -8, torch.float16: 4 * 2.0 ** -11}
#: (b, h, kv, s, t, d, causal, window, softcap)
BWD_CASES = ([(1, 20, 20, 4096, 4096, 128, True, 0, 0.0),   # a qwen1.5-4b training layer
              (1, 8, 1, 512, 512, 128, True, 0, 0.0),       # GQA group 8
              (1, 4, 4, 333, 333, 64, True, 100, 0.0),      # a window
              (1, 4, 2, 200, 280, 64, False, 0, 30.0),      # the softcap, ragged s < t
              (1, 4, 2, 280, 200, 112, True, 50, 20.0),     # ragged s > t, window, softcap
              (1, 4, 2, 200, 100, 32, True, 64, 0.0)]       # rows 163.. see no key
             + [(2, 4, 2, 300, 300, d, True, 0, 0.0) for d in BWD_HEAD_DIMS])


def _bwd_inputs(b, h, kv, s, t, d, dtype, device):
    """q, k, v as the model's (b, s, heads, d) views, and an output gradient."""
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in _flash_inputs(b, h, kv, s, d, t=t, dtype=dtype, device=device))
    return q, k, v, _randn(17, b, h, s, d, device=device).to(dtype)


def _ref_grads(q, k, v, g, mask):
    qr, kr, vr = (x.detach().float().requires_grad_() for x in (q, k, v))
    return torch.autograd.grad(attention_ref(qr, kr, vr, **mask), (qr, kr, vr), g.float())


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "b{}h{}kv{}s{}t{}d{}-{}-w{}-c{}".format(*c))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_backward_kernel_matches_autograd_through_attention_ref(cuda, case, dtype):
    """The op's backward on 16-bit CUDA tensors is one call of the kernel
    (three launches), held to attention_ref's fp32 gradients (``BWD_TOL``)."""
    b, h, kv, s, t, d, causal, window, softcap = case
    mask = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, g = _bwd_inputs(b, h, kv, s, t, d, dtype, cuda)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = flash_attention_bwd.launches
    mine = torch.autograd.grad(flash_attention(q, k, v, **mask), (q, k, v), g)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    for name, a, want in zip("qkv", mine, _ref_grads(q, k, v, g, mask)):
        err, _ = _err(a, want)
        scale = float(want.abs().max())
        assert a.dtype == dtype and err <= BWD_TOL[dtype] * scale, (name, err / scale)


@pytest.mark.cuda
def test_flash_backward_gives_the_same_bits_twice_and_refuses_what_it_does_not_take(cuda):
    """No atomics: two calls on the same inputs agree bit for bit.  fp32
    and d 256 are not compiled (nor the forward's log-sum-exp store at d
    256); the forward's log-sum-exp is that of attention_ref's scores."""
    q, k, v, g = _bwd_inputs(1, 8, 2, 1000, 1000, 128, torch.bfloat16, cuda)
    lse = torch.empty(1, 8, 1000, device=cuda)
    out = flash_attention_fwd(q, k, v, causal=True, lse=lse)
    assert float((lse - attention_lse_ref(q, k, causal=True)).abs().max()) < 1e-4
    first = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    second = flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    f32 = [x.float() for x in (q, k, v, out)]
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        flash_attention_bwd(*f32, lse, g.float(), causal=True)
    with pytest.raises(TypeError, match="log-sum-exp"):
        flash_attention_fwd(*f32[:3], causal=True, lse=lse)
    q2, k2, v2, g2 = _bwd_inputs(1, 2, 2, 64, 64, 256, torch.bfloat16, cuda)
    lse2 = torch.empty(1, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="log-sum-exp"):
        flash_attention_fwd(q2, k2, v2, lse=lse2)
    out2 = flash_attention_fwd(q2, k2, v2)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(q2, k2, v2, out2, lse2, g2)


@pytest.mark.cuda
def test_flash_backward_d256_keeps_the_recompute(cuda):
    """At d 256 the op keeps the plain backward, and the forward no
    log-sum-exp."""
    q, k, v, g = _bwd_inputs(1, 4, 2, 200, 200, 256, torch.bfloat16, cuda)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = flash_attention_bwd.launches
    mine = torch.autograd.grad(flash_attention(q, k, v, causal=True), (q, k, v), g)
    assert flash_attention_bwd.launches == before
    for a, want in zip(mine, _ref_grads(q, k, v, g, dict(causal=True))):
        err, _ = _err(a, want)
        assert err <= BWD_TOL[torch.bfloat16] * float(want.abs().max())


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q, k, v = _flash_inputs(1, 4, 2, 64, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="head_dim"):   # not compiled
        flash_attention_fwd(*_flash_inputs(1, 4, 2, 64, 80, device=cuda))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k[:, :1].expand(1, 3, 64, 64), v[:, :1].expand(1, 3, 64, 64))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v.cpu())
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention_fwd(q.transpose(2, 3), k, v)


@pytest.mark.cuda
def test_flash_attention_bf16_refuses_what_tma_cannot_read(cuda):
    """bf16 and fp16 read q, k and v through TMA: a base off a 16-byte
    boundary or a byte stride that is not a multiple of 16 raises; fp32
    takes both."""
    _, k, v = _flash_inputs(1, 4, 2, 64, 64, device=cuda)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        shifted = _randn(15, 1, 4, 64, 72, device=cuda).to(dtype)[..., 1:65]
        padded = _randn(16, 1, 4, 64, 68, device=cuda).to(dtype)[..., :64]
        kd, vd = k.to(dtype), v.to(dtype)
        for q, match in ((shifted, "16-byte aligned"), (padded, "multiple of 16 bytes")):
            if dtype != torch.float32:
                before = flash_attention_fwd.launches
                with pytest.raises(ValueError, match=match):
                    flash_attention_fwd(q, kd, vd)
                assert flash_attention_fwd.launches == before
            else:
                err, scale = _err(flash_attention_fwd(q, kd, vd), attention_ref(q, kd, vd))
                assert err <= 2e-3 * scale


@pytest.mark.cuda
def test_card_reference_attributes_every_kernel(cuda):
    """The card's own kernel times for a captured LeNet step: every kernel
    of the profile under a captured node, the per-class sums within 1% of
    the profile's device total, the same kernels a run, name by name, as
    the graph called as it is in a profile of its own,
    every class present in the simulation, and the hand kernel's time in
    ``dot``."""
    from collections import Counter
    from repro_torch import config as C
    from repro_torch.core import H100, Simulator, card_reference
    from repro_torch.core.correlate import profile_runs
    from repro_torch.models.lenet import LeNet, sgd_step
    cfg = C.get("lenet").smoke
    model = LeNet(cfg, conv_algo="gemm", device=cuda)
    x = _randn(20, 16, cfg.image_hw, cfg.image_hw, cfg.image_c, device=cuda)
    y = torch.arange(16, device=cuda) % cfg.num_classes
    params = model.param_dict()
    sim = Simulator(hw=H100)
    cap = sim.capture(lambda p, a, b: sgd_step(model, p, a, b, 0.05), params, x, y)
    before = tiled_matmul.launches
    ref = card_reference(cap, params, x, y, n=2)
    assert tiled_matmul.launches > before
    assert ref.clock == "device" and not ref.unattributed
    items, _ = profile_runs(lambda: cap.graph(params, x, y), 2, cuda=True)
    alone = {k: v / 2 for k, v in Counter(it[2] for it in items).items()}
    assert ref.counts == alone
    assert abs(sum(ref.values()) - ref.profile_seconds) <= 0.01 * ref.profile_seconds
    assert ref["dot"] > 0
    cr = sim.correlate(cap, ref)
    simulated = {r.kernel for r in cr.rows if r.sim_seconds > 0}
    assert {c for c, t in ref.items() if t > 0} <= simulated


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One qwen1.5-4b smoke train step in fp32 on the card (the flash kernel
    at d 16, forward and recompute) against the same step on the CPU (its
    plain version), from the same weights and batch: the loss and grad norm
    within 1e-5, every gradient leaf within 1e-4 of its scale, and the
    master's update within 1e-2 of its norm.  Not the master weight by
    weight: AdamW's first step moves each by about lr * sign(g), so a weight
    whose gradient lies within its rounding of zero moves the other way."""
    import dataclasses

    from repro_torch import config as C
    from repro_torch.models import build_model
    from repro_torch.optim import init_state, tree_leaves, tree_map
    from repro_torch.runtime.steps import loss_and_grads, train_bundle
    cfg = dataclasses.replace(C.get("qwen1.5-4b").smoke, dtype="float32")
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("t", 40, 2, "train"), mesh=C.SMOKE_MESH,
                     train=C.TrainConfig(warmup_steps=1, learning_rate=1e-3))
    model = build_model(cfg)
    cpu_params = model.init(seed=0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 41)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        batch = {"tokens": tok[:, :-1].to(dev), "labels": tok[:, 1:].to(dev)}
        # copies: the update writes the params in place
        params = tree_map(lambda t: t.to(dev, copy=True), cpu_params)
        grads = tree_map(torch.zeros_like, params)
        loss_and_grads(model, params, batch, grads)
        state = init_state(params)
        before = torch.cat([t.reshape(-1).cpu() for t in tree_leaves(state.master)])
        launches = flash_attention_fwd.launches
        state, m = train_bundle(rc).fn(state, batch)
        update = torch.cat([t.reshape(-1).cpu() for t in tree_leaves(state.master)]) - before
        out[str(dev)] = (m, grads, update, flash_attention_fwd.launches - launches)
    (mc, gc, uc, lc), (mg, gg, ug, lg) = out["cpu"], out["cuda"]
    assert lc == 0 and lg == 2 * cfg.num_layers
    for key in ("loss", "grad_norm"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-5 * abs(float(mc[key]))
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        err, scale = _err(a.cpu(), b)
        assert err <= 1e-4 * scale
    assert float((ug - uc).norm()) <= 1e-2 * float(uc.norm())


@pytest.mark.cuda
def test_pipeline_places_batches_on_the_card(cuda):
    from repro_torch.data.pipeline import DataPipeline
    src = [{"tokens": np.full((2, 5), i, np.int32)} for i in range(3)]
    data = DataPipeline(iter(src), cuda)
    got = list(data)
    data.close()
    assert [b["tokens"].device.type for b in got] == ["cuda"] * 3
    assert [int(b["tokens"][1, 4]) for b in got] == [0, 1, 2]


@pytest.mark.cuda
def test_jit_replays_the_eager_lenet_step_bit_for_bit(cuda):
    """The paper's step compiled (a CUDA graph: 14 ``tiled_matmul``
    launches, autograd, the params donated) against the same step eager,
    from one set of params and batches: equal bit for bit after each step.
    The first call of a signature runs eagerly, the second captures; a
    batch of another size is a second signature, captured at its second
    call.  Every call counts the launches it makes: the first call's own,
    and a replay the graph's."""
    from repro_torch import config as C
    from repro_torch.models.lenet import LeNet, sgd_step
    from repro_torch.runtime.jit import disable_jit, jit
    cfg = C.get("lenet").full
    model = LeNet(cfg, conv_algo="gemm", device=cuda, seed=0)
    step = jit(lambda p, x, y: sgd_step(model, p, x, y, 0.05), donate=(0,))

    def batch(n, seed):
        x = _randn(seed, n, cfg.image_hw, cfg.image_hw, cfg.image_c, device=cuda)
        y = torch.from_numpy(np.random.default_rng(seed).integers(0, 10, n)).to(cuda)
        return x, y

    graphed = {k: v.clone() for k, v in model.param_dict().items()}
    eager = {k: v.clone() for k, v in model.param_dict().items()}
    before = tiled_matmul.launches
    for i in range(3):
        x, y = batch(32, i)
        with disable_jit():
            eager, loss_e, _ = step(eager, x, y)
        graphed, loss_g, _ = step(graphed, x, y)
        assert len(step.graphs) == min(i, 1)
        assert torch.equal(loss_g, loss_e)
        for k in eager:
            assert torch.equal(graphed[k], eager[k]), (i, k)
    assert step.last.launches["tiled_matmul"] == 14
    assert tiled_matmul.launches - before == 3 * 14 + 3 * 14
    first = step.last
    for i in range(2):
        x, y = batch(16, 7 + i)
        graphed, _, _ = step(graphed, x, y)
    assert len(step.graphs) == 2 and step.last is not first


@pytest.mark.cuda
def test_graphed_train_step_matches_eager_with_the_rate_moving(cuda):
    """The qwen1.5-4b smoke train step (fp32) through ``train_bundle(rc).jit()``
    and under ``disable_jit``, from one state and one set of batches, over
    4 steps (eager, captured, two replays) while the rate warms up and
    decays: every metric and every leaf of the new state bit for bit."""
    import dataclasses

    from repro_torch import config as C
    from repro_torch.data.synthetic import batches_for
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime.jit import disable_jit
    from repro_torch.runtime.steps import init_train_state, train_bundle
    cfg = dataclasses.replace(C.get("qwen1.5-4b").smoke, dtype="float32")
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("t", 64, 4, "train"), mesh=C.SMOKE_MESH,
                     train=C.TrainConfig(warmup_steps=2, total_steps=10, learning_rate=1e-3))
    data = batches_for(cfg, rc.shape, 0)
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in next(data).items()}
               for _ in range(4)]
    step = train_bundle(rc).jit()
    graphed, eager = init_train_state(rc, 0, cuda), init_train_state(rc, 0, cuda)
    lrs = []
    for i, b in enumerate(batches):
        with disable_jit():
            eager, me = step(eager, b)
        graphed, mg = step(graphed, b)
        for k in me:
            assert torch.equal(mg[k], me[k]), (i, k)
        for pg, pe in zip(graphed, eager):
            for a, e in zip(tree_leaves(pg), tree_leaves(pe)):
                assert torch.equal(a, e), i
        lrs.append(float(mg["lr"]))
    assert len(step.graphs) == 1 and len(set(lrs)) == 4
    assert step.last.launches["flash_attention_fwd"] == 2 * cfg.num_layers


@pytest.mark.cuda
def test_a_signatures_first_call_copies_no_donated_state(cuda):
    """A step that donates a 1 GB state: its first call (eager), the
    capture and a replay together peak under 1.5 times the state."""
    from repro_torch.runtime.jit import jit

    def fn(state, x):
        for t in state.values():
            t.add_(x.mean())
        return state, (x * 2).sum()

    state = {k: torch.zeros(1 << 27, device=cuda) for k in ("w", "m")}
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    step = jit(fn, donate=(0,))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        state, total = step(state, torch.full((1024,), float(i + 1), device=cuda))
    assert float(state["w"][0]) == 6.0 and float(total) == 2 * 3 * 1024
    assert len(step.graphs) == 1
    assert torch.cuda.max_memory_allocated() - base < 0.5 * nbytes


@pytest.mark.cuda
def test_a_capture_holds_with_the_pipeline_prefetching(cuda):
    """Five compiled steps, each captured while the data pipeline's worker
    pins and copies the next batches: every capture holds, and every
    replay reads its own batch."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.runtime.jit import jit

    def fn(w, batch):
        x = batch["x"]
        for _ in range(64):          # a capture of some length
            x = x * 1.0
        w.add_(1.0)
        return w, x[:, 0].sum()

    rows = 1 << 12
    src = ({"x": np.full((rows, 1024), i, np.float32)} for i in range(10 ** 6))
    data = DataPipeline(src, cuda, prefetch=2)
    try:
        seen = 0
        for _ in range(5):
            step = jit(fn, donate=(0,))
            w = torch.zeros((), device=cuda)
            for i in range(4):
                w, s = step(w, next(data))
                assert float(s) == rows * seen and float(w) == i + 1
                seen += 1
            assert len(step.graphs) == 1
    finally:
        data.close()


@pytest.mark.cuda
def test_graphed_trainer_restores_and_matches_eager(cuda, tmp_path):
    """The ``Trainer`` (its step compiled) on the qwen1.5-4b smoke config
    in fp32 through a failure at step 3 and a restore from the step-2
    checkpoint, against the same run under ``disable_jit``: the same
    losses, bit for bit."""
    import dataclasses

    from repro_torch import config as C
    from repro_torch.runtime.failure import FailurePlan
    from repro_torch.runtime.jit import disable_jit
    from repro_torch.runtime.trainer import Trainer
    cfg = dataclasses.replace(C.get("qwen1.5-4b").smoke, dtype="float32")
    reports = []
    for mode in ("graphed", "eager"):
        rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("t", 64, 4, "train"), mesh=C.SMOKE_MESH,
                         train=C.TrainConfig(total_steps=6, warmup_steps=2, checkpoint_every=2,
                                             keep_checkpoints=2, learning_rate=1e-3,
                                             checkpoint_dir=str(tmp_path / mode)))
        trainer = Trainer(rc, use_mesh=False, failure_plan=FailurePlan(failures={3: 1}),
                          device=cuda)
        if mode == "graphed":
            reports.append(trainer.train())
        else:
            with disable_jit():
                reports.append(trainer.train())
    graphed, eager = reports
    assert graphed.restarts == eager.restarts == 1 and graphed.steps_done == 7
    assert graphed.losses == eager.losses


@pytest.mark.cuda
def test_server_serves_graphed_as_eager(cuda):
    """The llama3-8b smoke config served through the compiled steps and
    under ``disable_jit``: the same tokens, and one prefill and one decode
    graph (flash launched once a layer in the prefill's)."""
    from repro_torch import config as C
    from repro_torch.models import build_model
    from repro_torch.runtime.jit import disable_jit
    from repro_torch.runtime.server import Server
    cfg = C.get("llama3-8b").smoke
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("p", 32, 2, "prefill"))
    params = build_model(cfg).init(seed=0, device=cuda)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 32))).long().to(cuda)}
    server = Server(rc, params)
    graphed = [server.generate(batch, max_new_tokens=6) for _ in range(2)]
    with disable_jit():
        eager = Server(rc, params).generate(batch, max_new_tokens=6)
    np.testing.assert_array_equal(graphed[0], eager)
    np.testing.assert_array_equal(graphed[1], eager)
    assert len(server._prefill.graphs) == len(server._decode.graphs) == 1
    assert server._prefill.last.launches["flash_attention_fwd"] == cfg.num_layers
