"""The flash kernel at the published Zamba2's head dim, 224, with its
scores' scale, (224 / 2) ** -0.5, on the card; and the default scale, the
one every other model takes.

Every test here needs an NVIDIA GPU and ``nvcc``, is marked ``cuda``, and
skips without a card.  The file imports no ``jax``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_zamba2.py

Limits, of the output's largest magnitude, as ``test_torch_cuda.py`` holds
the kernel: 2e-2 for bf16, 1.2e-3 for fp16, 2e-3 for fp32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                 flash_attention_bwd, flash_attention_fwd)

ZAMBA2_SCALE = (224 / 2) ** -0.5
TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2, torch.float16: 1.2e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, kv, s, t, d, dtype, device):
    """q, k, v as the model's (b, s, heads, d) views, head-major."""
    out = []
    for seed, shape in ((21, (b, s, h, d)), (22, (b, t, kv, d)), (23, (b, t, kv, d))):
        x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        out.append(torch.from_numpy(x).to(device=device, dtype=dtype).transpose(1, 2))
    return out


def _err(out, ref):
    return float((out.float() - ref.float()).abs().max()), \
        max(1.0, float(ref.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("s,t,dtype", [
    (s, t, dtype) for s, t in [(300, 300), (77, 77), (200, 333), (4088, 4088)]
    for dtype in (torch.bfloat16, torch.float16, torch.float32)
    if s < 1000 or dtype != torch.float32])   # the fp32 kernel at the short lengths
def test_flash_d224_with_the_zamba2_scale(cuda, s, t, dtype):
    """d 224 (padded to the d-256 boxes, 64-key tiles), causal, at lengths
    off the 128-row and 64-key tiles, against attention_ref at the same
    scale; one launch a call."""
    q, k, v = _inputs(1 if s > 1000 else 2, 8, 8, s, t, 224, dtype, cuda)
    before = flash_attention_fwd.launches
    out = flash_attention(q, k, v, causal=True, scale=ZAMBA2_SCALE)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    err, scale = _err(out, attention_ref(q.float(), k.float(), v.float(), causal=True,
                                         scale=ZAMBA2_SCALE))
    assert err <= TOL[dtype] * scale
    # the scale is taken: the default one gives another output
    assert _err(out, flash_attention(q, k, v, causal=True))[0] > TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_the_default_scale_is_one_over_root_d_bit_for_bit(cuda, dtype):
    """At d 128 the default passes the kernel 1 / sqrt(d), as every call
    before the scale existed did: the same bits as that scale given."""
    q, k, v = _inputs(2, 8, 2, 300, 300, 128, dtype, cuda)
    assert torch.equal(flash_attention_fwd(q, k, v, causal=True),
                       flash_attention_fwd(q, k, v, causal=True, scale=1.0 / 128 ** 0.5))


@pytest.mark.cuda
def test_flash_d224_keeps_the_recompute_backward(cuda):
    """At d 224 the op differentiates attention_ref (no backward kernel is
    compiled there), at the given scale."""
    q, k, v = (x.detach().requires_grad_() for x in _inputs(1, 4, 4, 200, 200, 224,
                                                             torch.bfloat16, cuda))
    g = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3)
                    ).to(torch.bfloat16)
    before = flash_attention_bwd.launches
    mine = torch.autograd.grad(flash_attention(q, k, v, causal=True, scale=ZAMBA2_SCALE),
                               (q, k, v), g)
    assert flash_attention_bwd.launches == before
    ref = [x.detach().float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref, causal=True, scale=ZAMBA2_SCALE), ref,
                               g.float())
    for a, w in zip(mine, want):
        err, scale = _err(a, w)
        assert err <= 4 * 2.0 ** -8 * float(w.abs().max())
