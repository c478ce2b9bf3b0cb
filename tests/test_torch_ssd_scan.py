"""The SSD chunk-scan kernel's route, op and counts on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda_ssd.py``); here:
which scans the route gives it (16-bit CUDA tensors at the compiled shapes
with no gradient needed) and which keep the plain loop (CPU, fp32,
gradient-requiring and ``meta`` tensors, shapes it is not compiled for);
the op's fake implementation; the chunks a scan counts on either route,
with a CPU stand-in for the kernel; the launcher's refusals; the layout the
kernel reads and the copy into it; and that a capture of the op holds what
a capture of the loop holds.
"""
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.capture import capture
from repro_torch.kernels.ssd_scan import (MAX_CHUNK, STATE_SIZES, scan_route, ssd_scan,
                                          ssd_scan_op, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.kernel import readable
from repro_torch.kernels.ssd_scan.ops import positions_major
from repro_torch.models import ssm
from repro_torch.models.ssm import ssd_chunked
from repro_torch.obs.metrics import REGISTRY

#: the published Zamba2's scan: b 4, s 4,088, h 112, p 64, g 2, n 64, chunks of 256
CELL = (4, 4088, 112, 64, 2, 64)


def _inputs(b, s, h, p, g, n, dtype=torch.bfloat16, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen) - 2)
    A = -(1 + 15 * torch.rand(h, generator=gen))
    B, C = (0.5 * torch.randn(b, s, g, n, generator=gen) for _ in range(2))
    state0 = torch.randn(b, h, p, n, generator=gen)
    return ((x * dt[..., None]).to(dtype).to(device), (dt * A).to(device),
            B.to(dtype).to(device), C.to(dtype).to(device), state0.to(device))


def _fake(b, s, h, p, g, n, dtype=torch.bfloat16, device="cuda"):
    with FakeTensorMode():
        return (torch.empty(b, s, h, p, dtype=dtype, device=device),
                torch.empty(b, s, h, device=device),
                torch.empty(b, s, g, n, dtype=dtype, device=device),
                torch.empty(b, s, g, n, dtype=dtype, device=device),
                torch.empty(b, h, p, n, device=device))


@pytest.mark.parametrize("n", STATE_SIZES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_the_route_gives_the_kernel_16_bit_cuda_scans_at_the_compiled_shapes(n, dtype):
    args = _fake(4, 4088, 112, 64, 2, n, dtype)
    assert scan_route(*args, 256) == "kernel"
    assert scan_route(*args, MAX_CHUNK) == "kernel"
    with torch.no_grad():   # a gradient-requiring input that no gradient is taken of
        assert scan_route(args[0].requires_grad_(), *args[1:], 256) == "kernel"


@pytest.mark.parametrize("case", ["cpu", "fp32", "grad", "meta", "head dim 32",
                                  "state 32", "chunk 257", "chunk 150", "fp32 state",
                                  "mixed dtypes"])
def test_the_route_keeps_the_loop_elsewhere(case):
    b, s, h, p, g, n = 2, 300, 8, 64, 2, 64
    dtype, device, chunk = torch.bfloat16, "cuda", 256
    if case == "cpu":
        device = "cpu"
    elif case == "fp32":
        dtype = torch.float32
    elif case == "meta":
        device = "meta"
    elif case == "head dim 32":
        p = 32
    elif case == "state 32":
        n = 32
    elif case == "chunk 257":
        chunk = 257
    elif case == "chunk 150":     # off the kernel's 8-row units: HybridLM's 128 at 300 tokens
        chunk = 150
    args = list(_fake(b, s, h, p, g, n, dtype, device))
    if case == "grad":
        args[0].requires_grad_()
    elif case == "fp32 state":
        args[1] = args[1].to(torch.bfloat16)
    elif case == "mixed dtypes":
        args[2] = args[2].to(torch.float16)
    assert scan_route(*args, chunk) == "loop"


def test_the_fake_gives_the_outputs_shapes_and_dtypes():
    for dtype in (torch.bfloat16, torch.float16):
        y, state = ssd_scan_op(*_fake(*CELL, dtype), 256)
        assert (tuple(y.shape), y.dtype, y.device.type) == ((4, 4088, 112, 64), dtype, "cuda")
        assert y.is_contiguous() and state.is_contiguous()
        assert (tuple(state.shape), state.dtype) == ((4, 112, 64, 64), torch.float32)


def test_the_op_on_the_cpu_is_the_plain_version_and_checks_out():
    args = _inputs(2, 40, 4, 64, 2, 16)
    y, state = ssd_scan_op(*args, 16)
    want_y, want_state = ssd_scan_ref(*args, 16)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    torch.library.opcheck(ssd_scan_op, (*args, 16),
                          test_utils=("test_schema", "test_faketensor"))


def _counted(fn):
    REGISTRY.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counts = (REGISTRY.value("ssm_scan_chunks_total", step="eager"),
              REGISTRY.value("ssm_scan_kernel_chunks_total", step="eager"))
    REGISTRY.clear()
    return out, counts


@pytest.mark.parametrize("s,chunk,ragged,chunks", [(40, 16, True, 3), (48, 16, False, 3),
                                                   (40, 16, False, 2)])
def test_the_kernel_route_counts_the_chunks_it_covers(s, chunk, ragged, chunks, monkeypatch):
    """A CPU stand-in for the kernel (the op, which runs the plain version
    here), taken by a route that names the kernel, gets the chunk length as
    the loop runs it (shrunk to divide s without ``ragged``) and B and C by
    group; both routes count every chunk, the kernel's also on its own
    counter, and give the same result."""
    args = _inputs(2, s, 4, 64, 2, 16, dtype=torch.float32)
    seen = []

    def stand_in(xdt, dA, B, C, state0, length):
        seen.append((B.dim(), length))
        return ssd_scan_op(xdt, dA, B, C, state0, length)

    (want_y, want_state), loop = _counted(lambda: ssd_chunked(*args, chunk=chunk,
                                                              ragged=ragged))
    monkeypatch.setattr(ssm, "scan_route", lambda *a: "kernel")
    monkeypatch.setattr(ssm, "ssd_scan_op", stand_in)
    (y, state), kernel = _counted(lambda: ssd_chunked(*args, chunk=chunk, ragged=ragged))
    assert seen == [(4, chunk if ragged else s // chunks)]
    assert kernel == (chunks, chunks) and loop == (chunks, 0)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)


def test_a_meta_scan_at_the_cell_shape_counts_16_chunks_on_the_loop():
    args = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in _fake(*CELL)]
    _, counts = _counted(lambda: ssd_chunked(*args, chunk=256, ragged=True))
    assert counts == (math.ceil(4088 / 256), 0) == (16, 0)


def test_the_launcher_refuses_cpu_tensors_and_launches_nothing():
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*_inputs(1, 8, 2, 64, 1, 16), 8)
    assert ssd_scan.launches == before


def test_layout_names_how_the_kernel_reads_each_tensor():
    """The kernel reads a tensor as it lies where the positions have a unit
    stride and every other stride and the base fall on 16 bytes."""
    x = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    assert not readable(x)                            # position by position
    assert not readable(x.transpose(2, 3))
    # the published Zamba2's conv output, (b, c, s) in memory seen as (b, s, c):
    # 7,168 + 2 x 2 x 64 channels of 4,088 positions
    conv = torch.zeros(1, 7168 + 4 * 64, 4088, dtype=torch.bfloat16).transpose(1, 2)
    x_view = conv[..., :7168].unflatten(-1, (112, 64))
    B_view = conv[..., 7168:7168 + 128].unflatten(-1, (2, 64))
    assert readable(x_view) and readable(B_view)
    odd = torch.zeros(1, 7424, 4087, dtype=torch.bfloat16).transpose(1, 2)   # 8,174-byte rows
    assert not readable(odd[..., 7168:7296].unflatten(-1, (2, 64)))
    assert not readable(conv[:, 1:][..., :7168].unflatten(-1, (112, 64)))   # a 2-byte offset


@pytest.mark.parametrize("s", [4088, 4087, 5])
def test_positions_major_copies_only_what_the_kernel_cannot_read(s):
    """The model's conv output at a length of a multiple of 8 is handed over
    as it is; at any other length, and position by position, it is copied
    into rows of positions padded to 8, the values unchanged."""
    conv = torch.randn(2, 7424, s).to(torch.bfloat16).transpose(1, 2)
    x = conv[..., :7168].unflatten(-1, (112, 64))
    for t in (x, x.contiguous()):
        out = positions_major(t)
        assert readable(out) and torch.equal(out, t)
        assert (out is t) == (t is x and s % 8 == 0)
        assert out.stride()[1:] == (1, 64 * out.stride(3), -(-s // 8) * 8)


def test_a_capture_of_the_op_holds_the_loops_products():
    """On the card a capture traces the op (one node a layer); its emitter
    inlines the plain version, so the module has the loop's instructions and
    FLOPs.  (CPU fakes, with the op as the kernel stand-in.)"""
    def dot_flops(m):
        return sum(sc * m.op_flops(c, op)["mxu"] for op, c, sc in m.walk_entry()
                   if op.opcode == "dot")

    args = _fake(2, 40, 4, 64, 2, 16, device="cpu")
    scan = lambda *a: ssd_chunked(*a, chunk=16, ragged=True)  # noqa: E731
    loop = capture(scan, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssm, "scan_route", lambda *a: "kernel")
        caps = [loop, capture(scan, *args)]
    targets = [[str(n.target) for n in c.graph.graph.nodes if n.op == "call_function"]
               for c in caps]
    assert targets[1] == ["repro_torch.ssd_scan.default", "<built-in function getitem>",
                          "<built-in function getitem>"]
    assert len(targets[0]) > 100
    assert dot_flops(caps[1].module) == dot_flops(caps[0].module) > 0
    assert len(caps[1].hlo_text.splitlines()) == len(caps[0].hlo_text.splitlines())


def test_graph_replays_count_the_kernels_launches(monkeypatch):
    """A scan launched while a compiled step is captured counts in its
    capture, not on ``ssd_scan.launches``; each replay of its graph adds it."""
    from types import SimpleNamespace

    from repro_torch.kernels.dispatch import launch
    from repro_torch.kernels.ssd_scan import kernel
    from repro_torch.obs import regions
    from repro_torch.runtime import jit

    class _Stub:
        def replay(self):
            pass

    monkeypatch.setattr(kernel._ENTRY, "fn", lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    cap = regions.Capture("prefill", 7)
    monkeypatch.setattr(regions, "capturing", lambda: cap)
    before = ssd_scan.launches
    for _ in range(81):
        launch(kernel._ENTRY, ssd_scan, torch.device("cuda"), detail=lambda: "")
    assert ssd_scan.launches == before and cap.launches == {ssd_scan: 81}
    graph = jit.Graph(_Stub(), [], None, cap)
    graph.replay()
    assert ssd_scan.launches == before + 81 and graph.launches["ssd_scan"] == 81
