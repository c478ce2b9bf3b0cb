"""The port's kernels on the CPU (their plain versions, through the same ops
and autograd rules the card runs) against the reference package's Pallas
kernels in interpret mode, at the shapes of the reference kernel tests plus
a 64-channel Winograd case.  Inputs are made with numpy from a seed and
handed to both packages.

Tolerances: fp32 1e-4 (sums in another order; the reference kernel tests
use the same), bf16 2e-2 (one bf16 rounding of the output), Winograd 2e-4
(the F(2x2,3x3) transforms add roundings of their own, as in the reference
kernel tests).  The fused Winograd kernel's block indexing is walked in
plain PyTorch, and its tensor-core arithmetic (3xTF32 for fp32, a bf16
hi/lo split of V for bf16) emulated in numpy against an fp64 direct conv:
1e-4 (fp32) and 2e-2 (bf16) of the output's largest magnitude.  The kernels themselves, which run only on the card, are
tested in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.kernels.tiled_matmul import matmul as jax_matmul
from repro.kernels.tiled_matmul import matmul_ref as jax_matmul_ref
from repro.kernels.winograd import conv3x3_ref as jax_conv3x3_ref
from repro.kernels.winograd import conv3x3_winograd as jax_conv3x3_winograd
from repro.kernels.winograd import winograd_tiles as jax_winograd_tiles
from repro_torch.kernels.tiled_matmul import BLOCK_CONFIGS, matmul, matmul_ref
from repro_torch.kernels.winograd import (conv3x3_ref, conv3x3_winograd,
                                          filter_transform, winograd_plan,
                                          winograd_tiles_ref)
from repro_torch.kernels.winograd.kernel import COUT_PER_BLOCK
from repro_torch.kernels.winograd.ref import AT, BT, G


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
    """Through the ``repro_torch::conv3x3_winograd`` op, whose backward
    recomputes through the plain version."""
    x_np, w_np, g_np = _randn(1, 2, 9, 9, 3), _randn(2, 3, 3, 3, 5), _randn(3, 2, 9, 9, 5)
    x = torch.from_numpy(x_np).requires_grad_()
    w = torch.from_numpy(w_np).requires_grad_()
    traced = make_fx(lambda a, b: conv3x3_winograd(a, b, "SAME"))(x, w)
    assert [n.target for n in traced.graph.nodes].count(
        torch.ops.repro_torch.conv3x3_winograd.default) == 1
    (conv3x3_winograd(x, w, "SAME") * torch.from_numpy(g_np)).sum().backward()
    gx, gw = jax.grad(lambda a, b: jnp.sum(jax_conv3x3_ref(a, b, "SAME") * g_np),
                      argnums=(0, 1))(x_np, w_np)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw), rtol=2e-4, atol=2e-4)


def _walk_plan(x, u, padding):
    """The fused kernel's indexing in plain PyTorch: every block of
    ``winograd_plan`` gathers its halo box from x with zeros outside the
    image, cuts its patch's tiles out of the box, and writes the outputs
    that lie inside (b, oh, ow) for its cout block."""
    b, H, W, cin = x.shape
    cout = u.shape[-1]
    plan = winograd_plan(b, H, W, cin, cout, padding)
    (r, c), (hh, hw) = plan.patch, plan.halo
    y = torch.full((b, plan.oh, plan.ow, cout), float("nan"))
    for i in range(plan.grid):
        img, ti0, tj0, co0, r0, c0 = plan.block(i)
        halo = torch.zeros(hh, hw, cin)
        ys = slice(max(r0, 0), min(r0 + hh, H))
        xs = slice(max(c0, 0), min(c0 + hw, W))
        halo[ys.start - r0:ys.stop - r0, xs.start - c0:xs.stop - c0] = x[img, ys, xs]
        tiles = halo.unfold(0, 4, 2).unfold(1, 4, 2).permute(0, 1, 3, 4, 2)  # (r, c, 4, 4, cin)
        cos = slice(co0, min(co0 + COUT_PER_BLOCK, cout))
        out = winograd_tiles_ref(tiles[None].contiguous(), u[..., cos].contiguous())[0]
        out = out.permute(0, 2, 1, 3, 4).reshape(2 * r, 2 * c, -1)
        oy, ox = 2 * ti0, 2 * tj0
        ny, nx = min(2 * r, plan.oh - oy), min(2 * c, plan.ow - ox)
        y[img, oy:oy + ny, ox:ox + nx, cos] = out[:ny, :nx]
    assert not y.isnan().any()      # every output written
    return y


@pytest.mark.parametrize("b,hw,cin,cout", WINO_CASES + [(2, 28, 8, 40)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_winograd_plan_walk_matches_pallas(b, hw, cin, cout, padding):
    x_np, w_np = _randn(6, b, hw, hw, cin), _randn(7, 3, 3, cin, cout)
    u = filter_transform(torch.from_numpy(w_np), torch.float32)
    out = _walk_plan(torch.from_numpy(x_np), u, padding)
    ref = jax_conv3x3_winograd(jnp.asarray(x_np), jnp.asarray(w_np), padding)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)


def _tf32(a):
    """float32 -> TF32 (10 mantissa bits) by masking the low 13 mantissa
    bits, as the kernel splits and as the tensor core reads an fp32 operand."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _round_bf16(a):
    """float32 -> bfloat16, to nearest even, kept in float32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    bits = bits + ((bits >> 16) & 1) + np.uint32(0x7FFF)
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def _np_tiles(x, padding):
    if padding == "SAME":
        x = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    H, W = x.shape[1:3]
    oh, ow = H - 2, W - 2
    th, tw = (oh + 1) // 2, (ow + 1) // 2
    x = np.pad(x, ((0, 0), (0, 2 * th + 2 - H), (0, 2 * tw + 2 - W), (0, 0)))
    i = np.arange(th)[:, None] * 2 + np.arange(4)
    j = np.arange(tw)[:, None] * 2 + np.arange(4)
    tiles = x[:, i][:, :, :, j].transpose(0, 1, 3, 2, 4, 5)   # (b, th, tw, 4, 4, cin)
    return tiles, oh, ow


def _emulated_conv(x, u, padding, products):
    """The kernel's arithmetic in numpy float32: V = B^T d B, the 16
    positions' products as ``products(v, u)`` gives them, Y = A^T M A."""
    tiles, oh, ow = _np_tiles(x, padding)
    v = np.einsum("ij,btujkc,lk->btuilc", BT, tiles, BT).astype(np.float32)
    m = sum(np.einsum("btuilc,ilcf->btuilf", a, b).astype(np.float32)
            for a, b in products(v, u))
    y = np.einsum("ij,btujkf,lk->btuilf", AT, m, AT)
    b, th, tw = y.shape[:3]
    return y.transpose(0, 1, 3, 2, 4, 5).reshape(b, 2 * th, 2 * tw, -1)[:, :oh, :ow]


def _direct_conv_f64(x, w, padding):
    x = x.astype(np.float64)
    if padding == "SAME":
        x = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    oh, ow = x.shape[1] - 2, x.shape[2] - 2
    return sum(x[:, dy:dy + oh, dx:dx + ow] @ w[dy, dx].astype(np.float64)
               for dy in range(3) for dx in range(3))


def _three_tf32(v, u):
    """a_lo*b_hi, a_hi*b_lo, a_hi*b_hi: the fp32 kernel's three products,
    with hi = tf32(a) and lo = a - hi, read as TF32 by the tensor core."""
    vh, uh = _tf32(v), _tf32(u)
    vl, ul = _tf32(v - vh), _tf32(u - uh)
    return [(vl, uh), (vh, ul), (vh, uh)]


def _split_bf16(v, u):
    """V split into bf16 hi + lo against a U that is already bf16."""
    vh = _round_bf16(v)
    return [(_round_bf16(v - vh), u), (vh, u)]


@pytest.mark.parametrize("b,hw,cin,cout", WINO_CASES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_winograd_tensor_core_split_keeps_the_precision(b, hw, cin, cout, padding):
    """3xTF32 stays within 1e-4 of the output's scale of an fp64 direct
    conv, where one TF32 product would not; the bf16 hi/lo split of V, on
    bf16 x and U, within 2e-2."""
    x, w = _randn(6, b, hw, hw, cin), _randn(7, 3, 3, cin, cout)
    ref = _direct_conv_f64(x, w, padding)
    scale = max(1.0, float(np.abs(ref).max()))
    u = np.einsum("ij,jkcf,lk->ilcf", G, w, G).astype(np.float32)
    out = _emulated_conv(x, u, padding, _three_tf32)
    assert float(np.abs(out - ref).max()) <= 1e-4 * scale
    one = _emulated_conv(x, u, padding, lambda v, u: [(_tf32(v), _tf32(u))])
    assert float(np.abs(one - ref).max()) > 1e-4 * scale
    xb, wb = _round_bf16(x), _round_bf16(w)
    ub = _np(filter_transform(torch.from_numpy(wb).bfloat16(), torch.bfloat16))
    out = _round_bf16(_emulated_conv(xb, ub, padding, _split_bf16))
    ref = _direct_conv_f64(xb, wb, padding)
    assert float(np.abs(out - ref).max()) <= 2e-2 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("b,hw,cin,cout", [(2, 14, 8, 16)] + WINO_CASES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_winograd_bf16_op_matches_pallas_bit_for_bit(b, hw, cin, cout, padding):
    """On the CPU the conv op's plain path in bf16 and the reference wrapper
    in bf16 (Pallas in interpret mode) give the same bits."""
    x, jx = _both(_randn(6, b, hw, hw, cin), "bfloat16")
    w, jw = _both(_randn(7, 3, 3, cin, cout), "bfloat16")
    out = conv3x3_winograd(x, w, padding)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), _np(jax_conv3x3_winograd(jx, jw, padding)))
