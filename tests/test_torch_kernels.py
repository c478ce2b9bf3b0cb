"""The port's kernels on the CPU (their plain versions, through the same ops
and autograd rules the card runs) against the reference package's Pallas
kernels in interpret mode, at the shapes of the reference kernel tests plus
a 64-channel Winograd case.  Inputs are made with numpy from a seed and
handed to both packages.

Tolerances: fp32 1e-4 (sums in another order; the reference kernel tests
use the same), bf16 2e-2 (one bf16 rounding of the output), Winograd 2e-4
(the F(2x2,3x3) transforms add roundings of their own, as in the reference
kernel tests).  The kernels themselves, which run only on the card, are
tested in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tiled_matmul import matmul as jax_matmul
from repro.kernels.tiled_matmul import matmul_ref as jax_matmul_ref
from repro.kernels.winograd import conv3x3_ref as jax_conv3x3_ref
from repro.kernels.winograd import conv3x3_winograd as jax_conv3x3_winograd
from repro.kernels.winograd import winograd_tiles as jax_winograd_tiles
from repro_torch.kernels.tiled_matmul import BLOCK_CONFIGS, matmul, matmul_ref
from repro_torch.kernels.winograd import (conv3x3_ref, conv3x3_winograd,
                                          winograd_tiles_ref)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    """The same numpy array as a torch and a jax array of one dtype."""
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    if dtype == "bfloat16":
        return t.bfloat16(), j.astype(jnp.bfloat16)
    return t, j


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


MM_SHAPES = [(128, 128, 128), (200, 300, 150), (64, 512, 32), (257, 129, 65)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(m, k, n, dtype):
    a, ja = _both(_randn(4, m, k), dtype)
    b, jb = _both(_randn(5, k, n), dtype)
    out = matmul(a, b)
    assert out.dtype == a.dtype and tuple(out.shape) == (m, n)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(out), _np(jax_matmul(ja, jb)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(matmul_ref(a, b)), _np(jax_matmul_ref(ja, jb)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("block", [c for c in BLOCK_CONFIGS if c != (128, 128, 128)])
def test_matmul_block_sweep(block):
    bm, bn, bk = block
    a, ja = _both(_randn(4, 256, 256), "float32")
    b, jb = _both(_randn(5, 256, 256), "float32")
    out = matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
    ref = jax_matmul(ja, jb, block_m=bm, block_n=bn, block_k=bk)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-4)


def test_matmul_gradient_matches_jax():
    a_np, b_np, g_np = _randn(1, 33, 17), _randn(2, 17, 9), _randn(3, 33, 9)
    a = torch.from_numpy(a_np).requires_grad_()
    b = torch.from_numpy(b_np).requires_grad_()
    (matmul(a, b) * torch.from_numpy(g_np)).sum().backward()
    ga, gb = jax.grad(lambda x, y: jnp.sum(jnp.dot(x, y) * g_np),
                      argnums=(0, 1))(a_np, b_np)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-5)


WINO_CASES = [(1, 8, 4, 8), (2, 14, 8, 16), (1, 13, 3, 5), (1, 10, 64, 64)]


@pytest.mark.parametrize("b,hw,cin,cout", WINO_CASES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_winograd_conv_matches_pallas(b, hw, cin, cout, padding):
    x_np, w_np = _randn(6, b, hw, hw, cin), _randn(7, 3, 3, cin, cout)
    x, w = torch.from_numpy(x_np), torch.from_numpy(w_np)
    out = conv3x3_winograd(x, w, padding)
    ref = jax_conv3x3_winograd(jnp.asarray(x_np), jnp.asarray(w_np), padding)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        _np(conv3x3_ref(x, w, padding)),
        _np(jax_conv3x3_ref(jnp.asarray(x_np), jnp.asarray(w_np), padding)),
        rtol=2e-4, atol=2e-4)


def test_winograd_tiles_ref_matches_pallas_kernel():
    tiles_np, u_np = _randn(8, 2, 3, 4, 4, 4, 16), _randn(9, 4, 4, 16, 64)
    out = winograd_tiles_ref(torch.from_numpy(tiles_np), torch.from_numpy(u_np))
    ref = jax_winograd_tiles(jnp.asarray(tiles_np), jnp.asarray(u_np))
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-4)


def test_winograd_gradient_matches_direct_conv():
    x_np, w_np, g_np = _randn(1, 2, 9, 9, 3), _randn(2, 3, 3, 3, 5), _randn(3, 2, 9, 9, 5)
    x = torch.from_numpy(x_np).requires_grad_()
    w = torch.from_numpy(w_np).requires_grad_()
    (conv3x3_winograd(x, w, "SAME") * torch.from_numpy(g_np)).sum().backward()
    gx, gw = jax.grad(lambda a, b: jnp.sum(jax_conv3x3_ref(a, b, "SAME") * g_np),
                      argnums=(0, 1))(x_np, w_np)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), rtol=2e-4, atol=2e-4)
