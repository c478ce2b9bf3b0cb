"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode), is marked ``cuda``, and skips without a card.  The file imports no
``jax``, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: fp32 1e-4 and bf16 2e-2 of the output's largest magnitude (the
kernel sums in another order than the library; over K = 100,352 terms the
error grows with the output), Winograd 1e-4 (fp32) and 2e-2 (bf16) against
its plain version and 4e-4 against the direct conv (the transforms add
roundings of their own), flash attention 2e-3 (fp32) and
2e-2 (bf16) of the output's largest magnitude, as the reference kernel tests
hold the Pallas kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                 flash_attention_fwd)
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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_matmul_kernel(cuda, m, k, n, dtype):
    a = _randn(4, m, k, device=cuda).to(dtype)
    b = _randn(5, k, n, device=cuda).to(dtype)
    before = tiled_matmul.launches
    out = tiled_matmul(a, b)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (m, n)
    err, scale = _err(out, matmul_ref(a, b))
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-4) * scale


# the weight gradients of conv1 and conv2 (LeNet-full, batch 128) as the
# backward hands them in: A^T is a transposed view (a 100- and a 600-byte
# row stride), dY is contiguous
SPLIT_K_GRADS = [(100352, 25, 6), (12800, 150, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SPLIT_K_GRADS, ids=["dw0", "dw1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-4) * scale


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
        tiled_matmul(a.half(), a.half())
    with pytest.raises(ValueError):
        tiled_matmul(a, a[:4])
    with pytest.raises(ValueError):
        tiled_matmul(a, a.cpu())


def _wino_tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,cin,cout", WINO_CASES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    assert err <= _wino_tol(dtype) * scale
    if dtype == torch.float32:
        err, scale = _err(out, conv3x3_ref(x, w, padding))
        assert err <= 4e-4 * scale
    tiles = _randn(8, b, 3, 4, 4, 4, cin, device=cuda).to(dtype)
    u = _randn(9, 4, 4, cin, cout, device=cuda).to(dtype)
    y = winograd_tiles(tiles, u)
    assert winograd_tiles.launches == before[1] + 1 and y.dtype == dtype
    err, scale = _err(y, winograd_tiles_ref(tiles, u))
    assert err <= _wino_tol(dtype) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
        assert err <= _wino_tol(dtype) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    for dtype in (torch.float32, torch.bfloat16):
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
        winograd_conv(x.half(), u.half())
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


# GQA groups 1, 2, 4 and 8 over head dims 32, 64 and 128; lengths on and off
# the bf16 kernel's 128-row tiles
FLASH_SHAPES = [(1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
                (1, 4, 4, 384, 64), (2, 8, 2, 200, 128), (1, 4, 2, 77, 64),
                (1, 8, 8, 77, 128), (1, 8, 1, 1, 32), (1, 16, 4, 2000, 128)]
# windows of 64 and 200 cross the 128-key tiles' edges
FLASH_MASKS = [(True, 0, 0.0), (True, 64, 0.0), (False, 0, 0.0), (True, 0, 30.0),
               (False, 64, 30.0), (True, 200, 0.0)]


def _flash_inputs(b, h, kv, s, d, t=None, dtype=torch.float32, device=None):
    t = s if t is None else t
    return [_randn(seed, *shape, device=device).to(dtype) for seed, shape in
            ((11, (b, h, s, d)), (12, (b, kv, t, d)), (13, (b, kv, t, d)))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window,softcap", FLASH_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, b, h, kv, s, d, causal, window, softcap, dtype):
    q, k, v = _flash_inputs(b, h, kv, s, d, dtype=dtype, device=cuda)
    before = flash_attention_fwd.launches
    out = flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    err, scale = _err(out, attention_ref(q, k, v, causal=causal, window=window,
                                         softcap=softcap))
    assert err <= (2e-2 if dtype == torch.bfloat16 else 2e-3) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("s,t", [(200, 200), (256, 200), (128, 200), (1, 300), (77, 77),
                                 (1, 1), (2000, 2000), (77, 333)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_ragged(cuda, s, t, causal, window, dtype):
    """Ragged s != t, masked in the kernel: held to attention_ref (the
    reference wrapper's unmasked pads are wrong for causal s > t)."""
    q, k, v = _flash_inputs(1, 4, 2, s, 64, t=t, dtype=dtype, device=cuda)
    out = flash_attention(q, k, v, causal=causal, window=window)
    err, scale = _err(out, attention_ref(q, k, v, causal=causal, window=window))
    assert err <= (2e-2 if dtype == torch.bfloat16 else 2e-3) * scale


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
    """Forward through the kernel, backward recomputed through attention_ref."""
    q, k, v = (x.requires_grad_() for x in _flash_inputs(1, 4, 2, 128, 64, device=cuda))
    g = _randn(14, 1, 4, 128, 64, device=cuda)
    before = flash_attention_fwd.launches
    (flash_attention(q, k, v, causal=True, window=64) * g).sum().backward()
    assert flash_attention_fwd.launches == before + 1
    refs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    (attention_ref(*refs, causal=True, window=64) * g).sum().backward()
    for mine, ref in zip((q, k, v), refs):
        err, scale = _err(mine.grad, ref.grad)
        assert err <= 2e-3 * scale


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q, k, v = _flash_inputs(1, 4, 2, 64, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(*_flash_inputs(1, 4, 2, 64, 256, device=cuda))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k[:, :1].expand(1, 3, 64, 64), v[:, :1].expand(1, 3, 64, 64))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v.cpu())
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention_fwd(q.transpose(2, 3), k, v)


@pytest.mark.cuda
def test_flash_attention_bf16_refuses_what_tma_cannot_read(cuda):
    """bf16 reads q, k and v through TMA: a base off a 16-byte boundary or a
    byte stride that is not a multiple of 16 raises; fp32 takes both."""
    _, k, v = _flash_inputs(1, 4, 2, 64, 64, device=cuda)
    for dtype in (torch.bfloat16, torch.float32):
        shifted = _randn(15, 1, 4, 64, 72, device=cuda).to(dtype)[..., 1:65]
        padded = _randn(16, 1, 4, 64, 68, device=cuda).to(dtype)[..., :64]
        kd, vd = k.to(dtype), v.to(dtype)
        for q, match in ((shifted, "16-byte aligned"), (padded, "multiple of 16 bytes")):
            if dtype == torch.bfloat16:
                before = flash_attention_fwd.launches
                with pytest.raises(ValueError, match=match):
                    flash_attention_fwd(q, kd, vd)
                assert flash_attention_fwd.launches == before
            else:
                err, scale = _err(flash_attention_fwd(q, kd, vd), attention_ref(q, kd, vd))
                assert err <= 2e-3 * scale
