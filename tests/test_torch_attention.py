"""The port's flash-attention op on the CPU (its plain version, through the
same op and autograd rule the card runs) against the reference package's
Pallas kernel in interpret mode and its ``attention_ref``, on the grid of
the reference kernel tests.  Inputs are made with numpy from a seed and
handed to both packages.

Tolerances: rtol = atol = 2e-3 in fp32 and 2e-2 in bf16, as the reference
kernel tests hold the Pallas kernel.  At ragged s = t = 200 the port is held
to ``attention_ref`` only: the reference wrapper pads k/v without masking
the pads, which is wrong for causal s > t (ROADMAP C); the port masks
ragged ends instead of padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                 flash_attention_fwd)
from repro_torch.kernels.flash_attention.kernel import check_rows_see_a_key
from repro_torch.kernels.flash_attention.ops import first_keyless_row, with_keyless_rows

SHAPES = [(1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
          (1, 4, 4, 384, 64)]
MASKS = [(True, 0), (True, 64), (False, 0)]


def _qkv(b, h, kv, s, d, t=None, dtype="float32", seed=1):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d))]
    tq = [torch.from_numpy(a) for a in arrs]
    jq = [jnp.asarray(a) for a in arrs]
    if dtype == "bfloat16":
        tq = [x.bfloat16() for x in tq]
        jq = [x.astype(jnp.bfloat16) for x in jq]
    return tq, jq


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,h,kv,s,d", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_matches_pallas_and_ref(b, h, kv, s, d, causal, window):
    (q, k, v), (jq, jk, jv) = _qkv(b, h, kv, s, d)
    before = flash_attention_fwd.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention_fwd.launches == before   # CPU: the plain version
    ref = attention_ref(q, k, v, causal=causal, window=window)
    jax_out = jax_flash_attention(jq, jk, jv, causal, window, 0.0, 128, 128)
    jax_ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    for mine in (out, ref):
        np.testing.assert_allclose(_np(mine), _np(jax_out), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(_np(mine), _np(jax_ref), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes(dtype):
    (q, k, v), (jq, jk, jv) = _qkv(1, 4, 2, 256, 64, dtype=dtype)
    out = flash_attention(q, k, v, causal=True)
    assert out.dtype == q.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    for want in (jax_flash_attention(jq, jk, jv, True, 0, 0.0, 128, 128),
                 jax_attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(_np(out), _np(want), rtol=tol, atol=tol)


def test_flash_softcap():
    (q, k, v), (jq, jk, jv) = _qkv(1, 2, 2, 128, 32)
    out = flash_attention(q, k, v, causal=True, softcap=30.0)
    want = jax_flash_attention(jq, jk, jv, True, 0, 30.0, 128, 128)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-3, atol=2e-3)
    want = jax_attention_ref(jq, jk, jv, causal=True, softcap=30.0)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("s,t", [(200, 200), (256, 200), (128, 200)])
def test_flash_ragged_matches_ref(causal, window, s, t):
    (q, k, v), (jq, jk, jv) = _qkv(1, 4, 2, s, 64, t=t)
    out = flash_attention(q, k, v, causal=causal, window=window)
    want = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-3, atol=2e-3)


def test_flash_grad_matches_jax_grad_of_ref():
    (q, k, v), (jq, jk, jv) = _qkv(1, 2, 1, 128, 32)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    flash_attention(q, k, v, causal=True, window=64, softcap=30.0).sum().backward()
    grads = jax.grad(lambda *a: jax_attention_ref(
        *a, causal=True, window=64, softcap=30.0).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    for mine, want in zip((q.grad, k.grad, v.grad), grads):
        np.testing.assert_allclose(_np(mine), _np(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s,t,window,causal", [(4, 0, 0, True), (200, 100, 64, True),
                                               (200, 100, 64, False), (40, 8, 4, True)])
def test_rows_without_a_key_are_refused(s, t, window, causal):
    """The kernel refuses query rows that see no key (it has nothing to
    give them); the op gives them attention_ref's value, the mean of v
    (zeros at t = 0), as the reference does: on the CPU through
    attention_ref, on the card by a write after the kernel
    (``with_keyless_rows``, run here with a stand-in for the kernel that
    refuses such rows as it does; on the card by chip_smoke.py phase 5)."""
    with pytest.raises(ValueError, match="see no key"):
        check_rows_see_a_key(s, t, window)
    first = first_keyless_row(s, t, window)
    check_rows_see_a_key(first, t, window)
    assert first < s
    (q, k, v), (jq, jk, jv) = _qkv(1, 4, 2, s, 32, t=t)
    out = flash_attention(q, k, v, causal=causal, window=window)
    want = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-3, atol=2e-3)

    def kernel(q, k, v, **mask):
        check_rows_see_a_key(q.shape[2], k.shape[2], mask["window"])
        return attention_ref(q, k, v, **mask)

    mine = with_keyless_rows(q, k, v, causal=causal, window=window, softcap=0.0,
                             kernel=kernel)
    np.testing.assert_allclose(_np(mine), _np(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(out[:, :, first:]), np.broadcast_to(
        _np(v).mean(axis=2, keepdims=True).repeat(2, axis=1) if t else 0.0,
        out[:, :, first:].shape), rtol=1e-5, atol=1e-6)


def test_flash_keeps_the_callers_layout():
    """The model hands (b, s, heads, d) activations in as head-major views;
    the op's result has q's shape."""
    (q, k, v), (jq, jk, jv) = _qkv(2, 4, 2, 64, 32)
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=True)
    assert tuple(out.shape) == tuple(q.shape)
    np.testing.assert_allclose(_np(out), _np(jax_attention_ref(jq, jk, jv)),
                               rtol=2e-3, atol=2e-3)
