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
from repro_torch.kernels.flash_attention import (attention_lse_ref, attention_ref,
                                                 flash_attention, flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import check_rows_see_a_key
from repro_torch.kernels.flash_attention.ops import (backward_route, backward_with_keyless_rows,
                                                     first_keyless_row, with_keyless_rows)

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
def test_rows_without_a_key_are_refused(s, t, window, causal, monkeypatch):
    """The kernel refuses query rows that see no key (it has nothing to
    give them); the op gives them attention_ref's value, the mean of v
    (zeros at t = 0), as the reference does: on the CPU through
    attention_ref, on the card by a write after the kernel
    (``with_keyless_rows``, run here with a stand-in for the launcher that
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

    monkeypatch.setattr(flash_ops, "flash_attention_fwd", kernel)
    mine = with_keyless_rows(q, k, v, causal=causal, window=window, softcap=0.0)
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


# -- the backward's dispatch, its keyless rows and the log-sum-exp ----------

@pytest.mark.parametrize("device,dtype,d,route", [
    ("cpu", torch.float32, 128, "recompute"),     # the CPU: the plain version
    ("cpu", torch.bfloat16, 128, "recompute"),
    ("cuda", torch.float32, 128, "recompute"),    # the fp32 forward runs on the CUDA cores
    ("cuda", torch.bfloat16, 256, "recompute"),   # d 256: no backward instance
    ("cuda", torch.bfloat16, 128, "kernel"),
    ("cuda", torch.float16, 16, "kernel"),
    ("cuda", torch.bfloat16, 112, "kernel")])
def test_the_backward_is_chosen_by_device_dtype_and_head_dim(device, dtype, d, route):
    assert backward_route(torch.device(device), dtype, d) == route


def _bwd_stand_in(q, k, v, out, lse, dout, **mask):
    """The backward launcher's signature on the CPU: refuses rows that see
    no key, as the kernel does, and differentiates attention_ref."""
    check_rows_see_a_key(q.shape[2], k.shape[2], mask["window"])
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    return torch.autograd.grad(attention_ref(qr, kr, vr, **mask), (qr, kr, vr), dout)


def _jax_grads(jq, jk, jv, g, mask):
    """The reference's gradients: the vjp of its attention_ref at the
    cotangent ``g``, as its ``custom_vjp`` takes them."""
    _, vjp = jax.vjp(lambda *a: jax_attention_ref(*a, **mask), jq, jk, jv)
    return vjp(jnp.asarray(g.numpy()))


@pytest.mark.parametrize("s,t,window,causal", [(200, 100, 64, True), (200, 100, 64, False),
                                               (40, 8, 4, True), (4, 0, 0, True),
                                               (64, 64, 0, True)])
def test_the_keyless_rows_gradient_is_added_in_the_op(s, t, window, causal, monkeypatch):
    """Rows that see no key get a uniform softmax over all t keys through a
    constant score in attention_ref: dv gains their dout / t for every key,
    dq and dk nothing.  The op adds that around the kernel, which runs on
    the rows before them (here a stand-in that refuses keyless rows), and
    the whole is held to the vjp of the reference's attention_ref."""
    (q, k, v), (jq, jk, jv) = _qkv(1, 4, 2, s, 32, t=t)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(q.shape).astype(np.float32))
    mask = dict(causal=causal, window=window, softcap=0.0)
    out, lse = attention_ref(q, k, v, **mask), attention_lse_ref(q, k, **mask)
    monkeypatch.setattr(flash_ops, "flash_attention_bwd", _bwd_stand_in)
    mine = backward_with_keyless_rows(q, k, v, out, lse, g, **mask)
    for a, want in zip(mine, _jax_grads(jq, jk, jv, g, mask)):
        assert tuple(a.shape) == want.shape
        np.testing.assert_allclose(_np(a), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0), (True, 5, 30.0),
                                                   (False, 0, 0.0)])
def test_the_log_sum_exp_ref_is_that_of_the_scores_a_row_sees(causal, window, softcap):
    """``attention_lse_ref``, which the card tests hold the kernel's
    log-sum-exp to: each row's log-sum-exp of the scaled (and capped)
    scores the reference's masks let through, -inf where it sees none."""
    (q, k, _), (jq, jk, _) = _qkv(2, 4, 2, 30, 16, t=20)
    scores = jnp.einsum("bhsd,bhtd->bhst", jq, jnp.repeat(jk, 2, axis=1)) / 4.0
    if softcap:
        scores = softcap * jnp.tanh(scores / softcap)
    qp, kp = jnp.arange(30)[:, None], jnp.arange(20)[None, :]
    ok = (kp <= qp) if causal else jnp.ones((30, 20), bool)
    if window:
        ok &= (qp - kp) < window
    want = jax.nn.logsumexp(jnp.where(ok, scores, -jnp.inf), axis=-1)
    lse = attention_lse_ref(q, k, causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(_np(lse), _np(want), rtol=1e-5, atol=1e-5)
    keyless = lse[:, :, first_keyless_row(30, 20, window):]
    assert keyless.numel() == (2 * 4 * 6 if window else 0)
    assert bool((keyless == float("-inf")).all())


def test_the_capture_emits_the_lse_op_and_the_backward_kernels_products():
    """A captured step through the two ops the card's training runs: the
    forward's two products and the backward's five (the scores recomputed,
    dP, dV, dQ, dK), each over the full (s, t) score matrix as the
    reference computes them, and their outputs as parts."""
    from repro_torch.core.capture import capture

    def step(q, k, v, g):
        out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, True, 0, 0.0)
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, g,
                                                                True, 0, 0.0)
        return out, lse, dq, dk, dv

    b, h, kv, s, t, d = 2, 4, 2, 24, 20, 16
    (q, k, v), _ = _qkv(b, h, kv, s, d, t=t)
    cap = capture(step, q, k, v, torch.ones_like(q))
    m = cap.module
    flops = sum(sc * m.op_flops(c, o)["mxu"] for o, c, sc in m.walk_entry())
    assert flops == 7 * 2 * b * h * s * t * d
    ops_seen = [n.target for n in cap.graph.graph.nodes if n.op == "call_function"
                and "repro_torch" in str(n.target)]
    assert ops_seen == [torch.ops.repro_torch.flash_attention_lse.default,
                        torch.ops.repro_torch.flash_attention_bwd.default]


def test_a_graph_replay_counts_the_backward_kernels_launches(monkeypatch):
    """The forward's and the backward's launches made while a compiled step
    is captured land in its capture, not on their counters; each replay of
    its graph adds them (here 80 and 40, a graphed qwen1.5-4b step's), by
    their launchers' names."""
    from types import SimpleNamespace

    from repro_torch.kernels.dispatch import launch
    from repro_torch.obs import regions
    from repro_torch.runtime import jit

    class _Stub:
        def replay(self):
            pass

    for entry in (flash_kernel._FWD, flash_kernel._BWD):
        monkeypatch.setattr(entry, "fn", lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    cap = regions.Capture("train", 7)
    monkeypatch.setattr(regions, "capturing", lambda: cap)
    before = flash_attention_fwd.launches, flash_attention_bwd.launches
    for entry, launcher, n in ((flash_kernel._FWD, flash_attention_fwd, 80),
                               (flash_kernel._BWD, flash_attention_bwd, 40)):
        for _ in range(n):
            launch(entry, launcher, torch.device("cuda"), detail=lambda: "")
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == before
    graph = jit.Graph(_Stub(), [], None, cap)
    assert graph.launches == {"flash_attention_fwd": 80, "flash_attention_bwd": 40}
    graph.replay()
    graph.replay()
    assert (flash_attention_fwd.launches - before[0],
            flash_attention_bwd.launches - before[1]) == (160, 80)
