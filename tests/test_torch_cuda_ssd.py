"""The SSD chunk-scan kernel (``csrc/ssd_scan.cu``) on the card, against the
plain loop (``ssd_scan_ref``) run in fp32 on the same inputs.

Every test here needs an NVIDIA GPU and ``nvcc``, is marked ``cuda``, and
skips without a card.  The file imports no ``jax``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_ssd.py

Limits, of the largest magnitude of the fp32 loop's output: y 1e-2 in
bf16 and 2e-3 in fp16 (y is rounded once to the input's type, 2^-9 and
2^-11 of itself, and so is each term of the chunk's own product; the 16-bit
loop, which rounds four times, misses by up to 4.5e-3 and 6.3e-4 at these
shapes on the H100); the final state 1e-4 (fp32 throughout, the products
on it in two TF32 terms, 2^-20 of each; the rest is the order of the
chunks' fp32 cumulative sums, which the loop takes in another order).  And
over the whole output the kernel is no further from the fp32 loop than the
16-bit loop is (the norm of the difference).
"""
import pytest
import torch

from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_op, ssd_scan_ref
from repro_torch.kernels.ssd_scan.kernel import readable
from repro_torch.models.ssm import ssd_chunked

Y_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3}
STATE_TOL = 1e-4
DTYPES = [torch.bfloat16, torch.float16]
#: (b, s, h, g, n, chunk, ragged, state0): the published Zamba2's prefill
#: scan first, then small shapes off the 16-row blocks
CASES = [(4, 4088, 112, 2, 64, 256, True, False),
         (2, 40, 4, 2, 16, 16, True, True), (2, 336, 8, 1, 64, 128, False, True),
         (1, 777, 6, 2, 64, 256, True, True), (3, 100, 4, 4, 16, 56, True, False),
         (2, 1000, 8, 2, 64, 256, True, True), (1, 5, 2, 1, 64, 256, True, True),
         (2, 384, 4, 1, 16, 128, False, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, s, h, g, n, dtype, state0=False, seed=0):
    """A prefill's scan inputs: x dt, dt A with dt = softplus(N(-2, 1)) and
    A in -[1, 16], B and C N(0, 1/4), as the model hands them over: xdt, B
    and C with the positions at unit stride."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, h, 64, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen, device="cuda") - 2)
    A = -(1 + 15 * torch.rand(h, generator=gen, device="cuda"))
    B, C = (0.5 * torch.randn(b, s, g, n, generator=gen, device="cuda") for _ in range(2))
    s0 = (torch.randn(b, h, 64, n, generator=gen, device="cuda") if state0
          else torch.zeros(b, h, 64, n, device="cuda"))
    return (_positions_major((x * dt[..., None]).to(dtype)), dt * A,
            _positions_major(B.to(dtype)), _positions_major(C.to(dtype)), s0)


def _positions_major(t):
    """``t`` (b, s, k, d) copied into the layout of the model's conv output:
    the positions at unit stride, feature by feature."""
    b, s, k, d = t.shape
    return torch.empty(b, k, d, s, dtype=t.dtype, device=t.device).permute(0, 3, 1, 2).copy_(t)


def _rel(a, ref):
    return float((a.float() - ref).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,g,n,chunk,ragged,state0", CASES)
@pytest.mark.parametrize("layout", ["rows", "positions"])
def test_the_kernel_matches_the_fp32_loop(cuda, layout, dtype, b, s, h, g, n, chunk, ragged,
                                          state0):
    """Through the model's scan (one launch), against the loop in fp32 on
    the same inputs; no further from it than the 16-bit loop.  xdt, B and C
    laid out position by position (copied into the kernel's layout first)
    or, as the model's conv output lies, with the positions at unit stride."""
    args = _inputs(b, s, h, g, n, dtype, state0, seed=s)
    if layout == "rows":
        args = tuple(a.contiguous() for a in args)
    before = ssd_scan.launches
    y, state = ssd_chunked(*args, chunk=chunk, ragged=ragged)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert (y.dtype, tuple(y.shape), state.dtype) == (dtype, (b, s, h, 64), torch.float32)
    length = chunk if ragged else s // max(s // chunk, 1)
    want_y, want_state = ssd_scan_ref(*(a.float() for a in args), length)
    loop_y, _ = ssd_scan_ref(*args, length)
    assert _rel(y, want_y) <= Y_TOL[dtype]
    assert _rel(state, want_state) <= STATE_TOL
    assert float((y.float() - want_y).norm()) <= float((loop_y.float() - want_y).norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,g,n,chunk", [(4, 4088, 112, 2, 64, 256), (2, 1000, 8, 2, 16, 256),
                                             (1, 296, 4, 1, 64, 152), (2, 40, 4, 2, 16, 16)])
def test_the_model_layout_is_read_as_it_lies_with_the_same_bits(cuda, dtype, b, s, h, g, n,
                                                               chunk):
    """xdt, B and C with the positions at unit stride (the model's conv
    output) are read without a copy and give the bits of the same values
    laid out position by position, which the op copies into that layout."""
    xdt, dA, B, C, s0 = _inputs(b, s, h, g, n, dtype, True)
    assert all(readable(t) for t in (xdt, B, C))
    got = ssd_scan(xdt, dA, B, C, s0, chunk)
    want = ssd_scan_op(xdt.contiguous(), dA, B.contiguous(), C.contiguous(), s0, chunk)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_calls_give_the_same_bits(cuda, dtype):
    args = _inputs(2, 1000, 8, 2, 64, dtype, True)
    first, second = ssd_scan(*args, 256), ssd_scan(*args, 256)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_a_graph_replay_gives_the_eager_bits(cuda):
    """The op captured into a CUDA graph (at 700 positions, not a multiple
    of 8: the copies into the kernel's layout and one kernel launch) and
    replayed on new inputs written into the captured ones: the eager call's
    bits."""
    args = _inputs(2, 700, 8, 2, 64, torch.bfloat16, True)
    fresh = _inputs(2, 700, 8, 2, 64, torch.bfloat16, True, seed=1)
    ssd_scan_op(*args, 256)     # built and loaded before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = ssd_scan.launches
    with torch.cuda.graph(graph):
        out = ssd_scan_op(*args, 256)
    assert ssd_scan.launches == before + 1
    for a, f in zip(args, fresh):
        a.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    want = ssd_scan_op(*fresh, 256)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
def test_a_scan_that_needs_a_gradient_keeps_the_loop(cuda):
    """The training forward: no launch, and the gradient flows through the
    loop."""
    args = [a.requires_grad_() if a.is_floating_point() else a
            for a in _inputs(1, 300, 4, 2, 64, torch.bfloat16)]
    before = ssd_scan.launches
    y, state = ssd_chunked(*args, chunk=256, ragged=True)
    (y.float().sum() + state.sum()).backward()
    assert ssd_scan.launches == before
    assert all(a.grad is not None and torch.isfinite(a.grad.float()).all() for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-7b", "zamba2-7b-instruct"])
def test_a_16_bit_prefill_launches_the_kernel_once_a_layer(cuda, arch):
    """The smoke configs (one group, chunks of 128 shrunk to divide s: 160
    at 320 tokens; two groups, ragged chunks of 16): one launch a Mamba2
    layer, finite logits."""
    from repro_torch import config as C
    from repro_torch.models import build_model
    cfg = C.get(arch).smoke
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 320), device="cuda")
    before = ssd_scan.launches
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + cfg.num_layers
    assert bool(torch.isfinite(logits.float()).all())
