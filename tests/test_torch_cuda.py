"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU
mode), is marked ``cuda``, and skips without a card.  The file imports no
``jax``, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: fp32 1e-4 and bf16 2e-2 of the output's largest magnitude (the
kernel sums in another order than the library; over K = 100,352 terms the
error grows with the output), Winograd 4e-4 against the direct conv (the
transforms add roundings of their own).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.tiled_matmul import BLOCK_CONFIGS, matmul, matmul_ref, tiled_matmul
from repro_torch.kernels.winograd import (conv3x3_ref, conv3x3_winograd,
                                          winograd_tiles, winograd_tiles_ref)

MM_SHAPES = [(128, 128, 128), (200, 300, 150), (64, 512, 32), (257, 129, 65),
             (100352, 25, 6), (25, 100352, 6)]
WINO_CASES = [(1, 8, 4, 8), (2, 14, 8, 16), (1, 13, 3, 5), (1, 10, 64, 64),
              (64, 28, 16, 32)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,cin,cout", WINO_CASES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_winograd_kernel(cuda, b, hw, cin, cout, padding):
    x = _randn(6, b, hw, hw, cin, device=cuda)
    w = _randn(7, 3, 3, cin, cout, device=cuda)
    before = winograd_tiles.launches
    out = conv3x3_winograd(x, w, padding)
    torch.cuda.synchronize()
    assert winograd_tiles.launches == before + 1
    err, scale = _err(out, conv3x3_ref(x, w, padding))
    assert err <= 4e-4 * scale
    tiles = _randn(8, b, 3, 4, 4, 4, cin, device=cuda)
    u = _randn(9, 4, 4, cin, cout, device=cuda)
    err, scale = _err(winograd_tiles(tiles, u), winograd_tiles_ref(tiles, u))
    assert err <= 1e-4 * scale


@pytest.mark.cuda
def test_winograd_refuses_what_it_does_not_take(cuda):
    tiles = _randn(1, 1, 2, 2, 4, 4, 8, device=cuda)
    u = _randn(2, 4, 4, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        winograd_tiles(tiles.double(), u.double())
    with pytest.raises(ValueError):
        winograd_tiles(tiles, u[:, :, :4])
    with pytest.raises(ValueError):
        winograd_tiles(tiles.transpose(1, 2), u)
