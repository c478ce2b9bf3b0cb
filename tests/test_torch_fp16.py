"""fp16 through the port's three kernel ops on the CPU (their plain
versions, which compute in fp32 and cast back) against the reference
package's Pallas kernels in fp16, run in interpret mode as the reference
kernel tests run them.  Inputs are made with numpy from a seed and handed
to both packages.

Tolerance: rtol = atol = 2e-2 of fp16, as the reference kernel tests hold
their 16-bit cases.  The kernels themselves take fp16 on the card
(``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.tiled_matmul import matmul as jax_matmul
from repro.kernels.winograd import conv3x3_winograd as jax_conv3x3_winograd
from repro.kernels.winograd import winograd_tiles as jax_winograd_tiles
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.tiled_matmul import matmul, matmul_ref
from repro_torch.kernels.winograd import (conv3x3_winograd, conv3x3_winograd_ref,
                                          filter_transform, winograd_tiles_ref)

TOL = 2e-2


def _both(seed, *shape):
    """The same numpy draw as an fp16 torch tensor and an fp16 jax array."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).half(), jnp.asarray(x).astype(jnp.float16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (257, 129, 65), (64, 512, 32)])
def test_matmul_fp16_matches_pallas(m, k, n):
    a, ja = _both(4, m, k)
    b, jb = _both(5, k, n)
    out = matmul(a, b)
    assert out.dtype == torch.float16
    ref = jax_matmul(ja, jb)
    assert ref.dtype == jnp.float16
    for mine in (out, matmul_ref(a, b)):
        np.testing.assert_allclose(_np(mine), _np(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,hw,cin,cout", [(1, 8, 4, 8), (2, 14, 8, 16), (1, 13, 3, 5)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_winograd_fp16_matches_pallas(b, hw, cin, cout, padding):
    x, jx = _both(6, b, hw, hw, cin)
    w, jw = _both(7, 3, 3, cin, cout)
    out = conv3x3_winograd(x, w, padding)
    assert out.dtype == torch.float16
    ref = jax_conv3x3_winograd(jx, jw, padding)
    assert ref.dtype == jnp.float16 and tuple(out.shape) == ref.shape
    plain = conv3x3_winograd_ref(x, filter_transform(w, torch.float16), padding)
    for mine in (out, plain):
        np.testing.assert_allclose(_np(mine), _np(ref), rtol=TOL, atol=TOL)


def test_winograd_tiles_fp16_matches_pallas():
    tiles, jt = _both(8, 2, 3, 4, 4, 4, 16)
    u, ju = _both(9, 4, 4, 16, 32)
    out = winograd_tiles_ref(tiles, u)
    ref = jax_winograd_tiles(jt, ju)
    assert out.dtype == torch.float16 and ref.dtype == jnp.float16
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,h,kv,s,d", [(1, 4, 2, 256, 64), (1, 8, 1, 128, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_attention_fp16_matches_pallas(b, h, kv, s, d, causal, window):
    q, jq = _both(11, b, h, s, d)
    k, jk = _both(12, b, kv, s, d)
    v, jv = _both(13, b, kv, s, d)
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.float16
    jax_out = jax_flash_attention(jq, jk, jv, causal, window, 0.0, 128, 128)
    jax_ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert jax_out.dtype == jnp.float16
    for mine in (out, attention_ref(q, k, v, causal=causal, window=window)):
        np.testing.assert_allclose(_np(mine), _np(jax_out), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_np(mine), _np(jax_ref), rtol=TOL, atol=TOL)
