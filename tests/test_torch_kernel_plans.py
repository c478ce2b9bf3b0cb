"""The host-side plans of the port's CUDA kernels, on the CPU: the K-split
count of ``tiled_matmul``, the TMA layout check of the bf16 flash kernel,
the block geometry of the fused Winograd conv, and the build digest that
names each library.  None of them needs a card."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import check_tma_layout
from repro_torch.kernels.tiled_matmul.kernel import (BLOCK_CONFIGS, BLOCKS_PER_SM,
                                                     MIN_SLABS_PER_SPLIT, split_k_plan)
from repro_torch.kernels.winograd.kernel import (COUT_PER_BLOCK, PATCHES, STAGES,
                                                 TILES_PER_BLOCK, smem_bytes,
                                                 winograd_plan)

H100_SMS = 132
H100_SMEM_PER_SM = 233472   # 228 KB of shared memory an SM

# every product of one LeNet-full training step (batch 128): (label, M, K, N)
LENET_STEP = [("fwd0", 100352, 25, 6), ("fwd1", 12800, 150, 16), ("fwd2", 128, 400, 120),
              ("fwd3", 128, 120, 84), ("fwd4", 128, 84, 10),
              ("dw0", 25, 100352, 6), ("dw1", 150, 12800, 16), ("dw2", 400, 128, 120),
              ("dw3", 120, 128, 84), ("dw4", 84, 128, 10),
              ("dx1", 12800, 16, 150), ("dx2", 128, 120, 400), ("dx3", 128, 84, 120),
              ("dx4", 128, 10, 84)]


def _tiles(m, n, bm, bn):
    return -(-m // bm) * -(-n // bn)


def _check_plan(m, k, n, block, sms):
    bm, bn, bk = block
    splits = split_k_plan(m, n, k, bm, bn, bk, sms)
    slabs = -(-k // bk)
    assert 1 <= splits <= max(1, slabs)
    # the kernel's cut: every split walks the same whole number of slabs,
    # so all start on a slab boundary and none is empty
    per = -(-slabs // splits) if slabs else 0
    assert per * (splits - 1) < max(slabs, 1)
    if splits > 1:
        assert per >= MIN_SLABS_PER_SPLIT
        assert _tiles(m, n, bm, bn) * splits <= 2 * BLOCKS_PER_SM * sms
    return splits


@pytest.mark.parametrize("label,m,k,n", LENET_STEP, ids=[p[0] for p in LENET_STEP])
def test_split_k_plan_on_the_lenet_step(label, m, k, n):
    splits = _check_plan(m, k, n, (64, 64, 64), H100_SMS)
    if label in ("dw0", "dw1"):
        # conv1's and conv2's weight gradients: one or three output tiles
        # over K = 100,352 and 12,800 would leave the card idle
        assert splits >= 2
        assert _tiles(m, n, 64, 64) * splits >= H100_SMS
    if _tiles(m, n, 64, 64) >= H100_SMS:
        assert splits == 1


@pytest.mark.parametrize("m,k,n", [(64, 5000, 32), (25, 100352, 6), (1, 1, 1), (100, 30, 50),
                                   (64, 255, 64), (64, 256, 64), (64, 511, 64), (4096, 4096, 4096),
                                   (8448, 1 << 20, 64), (0, 64, 64), (64, 0, 64)])
@pytest.mark.parametrize("block", BLOCK_CONFIGS)
@pytest.mark.parametrize("sms", [1, 16, H100_SMS])
def test_split_k_plan_edges(m, k, n, block, sms):
    splits = _check_plan(m, k, n, block, sms)
    if -(-k // block[2]) < 2 * MIN_SLABS_PER_SPLIT:
        assert splits == 1       # too short to cut into two splits of 4 slabs


def test_split_k_plan_ragged_last_split():
    # 79 slabs of 64 over 16 splits of 5: the last split has 4 slabs and a
    # ragged K of 8, so K is not a multiple of splits * block_k
    assert split_k_plan(64, 32, 5000, 64, 64, 64, H100_SMS) == 16
    assert 5000 % (16 * 64)


def _model_view(b, s, heads, d, dtype=torch.bfloat16):
    """q, k or v as the model hands them in: (b, s, heads, d) transposed."""
    return torch.zeros(b, s, heads, d, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("d", [16, 32, 64, 112, 128, 256])
@pytest.mark.parametrize("b,s,heads", [(4, 2048, 32), (4, 2048, 8), (1, 77, 4), (2, 1, 8)])
def test_tma_layout_accepts_the_models_views(d, b, s, heads):
    x = _model_view(b, s, heads, d)
    check_tma_layout("q", x.shape, x.stride(), x.element_size(), x.data_ptr())
    y = x.contiguous()   # and the head-major layout the card tests use
    check_tma_layout("k", y.shape, y.stride(), y.element_size(), y.data_ptr())


def test_tma_layout_ignores_the_stride_of_an_extent_one_dim():
    check_tma_layout("q", (1, 1, 1, 64), (7, 3, 5, 1), 2, 4096)


@pytest.mark.parametrize("ptr", [4098, 4104, 4097])
def test_tma_layout_rejects_a_misaligned_base(ptr):
    x = _model_view(1, 128, 4, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_tma_layout("q", x.shape, x.stride(), 2, ptr)


@pytest.mark.parametrize("shape,strides", [
    ((1, 4, 128, 36), (18432, 36, 144, 1)),    # d 36 rows: 72-byte position stride
    ((1, 4, 128, 64), (32768, 8196, 64, 1)),   # a head stride of 16,392 bytes
    ((2, 4, 128, 64), (4, 8192, 64, 1)),       # a batch stride of 8 bytes
    ((1, 4, 128, 64), (32768, 0, 64, 1)),      # heads broadcast (stride 0)
])
def test_tma_layout_rejects_misaligned_strides(shape, strides):
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        check_tma_layout("k", shape, strides, 2, 4096)


def test_build_digest_covers_the_compiler_flags(monkeypatch):
    before = {k: build.lib_path(k) for k in build.KERNELS}
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    after = {k: build.lib_path(k) for k in build.KERNELS}
    assert all(before[k] != after[k] for k in build.KERNELS)
    monkeypatch.undo()
    assert {k: build.lib_path(k) for k in build.KERNELS} == before


def test_build_digest_covers_the_link_flags(monkeypatch):
    before = build.lib_path("flash_attention")
    monkeypatch.setattr(build, "LINK_FLAGS", ("-lcuda",))
    assert build.lib_path("flash_attention") != before


def test_build_digest_covers_included_headers(monkeypatch, tmp_path):
    (tmp_path / "common.cuh").write_text("#define ONE 1\n")
    (tmp_path / "inner.cuh").write_text('#include "common.cuh"\n')
    (tmp_path / "kern.cu").write_text('#include <cuda_runtime.h>\n#include "inner.cuh"\n')
    (tmp_path / "other.cu").write_text("#include <cuda_runtime.h>\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first, other = build.lib_path("kern"), build.lib_path("other")
    assert first.name.startswith("libkern-") and first.suffix == ".so"
    assert build.lib_path("kern") == first            # stable
    (tmp_path / "common.cuh").write_text("#define ONE 2\n")
    second = build.lib_path("kern")
    assert second != first                             # a header two levels down
    assert build.lib_path("other") == other            # not included there
    (tmp_path / "kern.cu").write_text('#include <cuda_runtime.h>\n#include "inner.cuh"\n// x\n')
    assert build.lib_path("kern") != second


# the section V case study, a ResNet-50 conv2_x layer at batch 32, the
# reference's ragged 13x13 test with cin 3, and the other reference shapes
WINO_PLAN_CASES = [(64, 28, 28, 16, 32), (32, 56, 56, 64, 64), (1, 13, 13, 3, 5),
                   (1, 8, 8, 4, 8), (2, 14, 14, 8, 16), (1, 10, 10, 64, 64)]


@pytest.mark.parametrize("b,h,w,cin,cout", WINO_PLAN_CASES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_winograd_plan_covers_every_tile_once(b, h, w, cin, cout, padding):
    plan = winograd_plan(b, h, w, cin, cout, padding)
    pad = 1 if padding == "SAME" else 0
    assert (plan.oh, plan.ow) == (h + 2 * pad - 2, w + 2 * pad - 2)
    th, tw = plan.tiles
    assert (th, tw) == ((plan.oh + 1) // 2, (plan.ow + 1) // 2)
    r, c = plan.patch
    assert plan.patch in PATCHES and plan.tiles_per_block == r * c == TILES_PER_BLOCK
    assert plan.halo == (2 * r + 2, 2 * c + 2)
    assert plan.stages == STAGES >= 2
    assert plan.cout_blocks * COUT_PER_BLOCK >= cout > (plan.cout_blocks - 1) * COUT_PER_BLOCK
    seen = {}
    for i in range(plan.grid):
        img, ti0, tj0, co0, r0, c0 = plan.block(i)
        assert (r0, c0) == (2 * ti0 - pad, 2 * tj0 - pad)
        for ti in range(ti0, ti0 + r):
            for tj in range(tj0, tj0 + c):
                if ti < th and tj < tw:
                    key = (img, ti, tj, co0)
                    assert key not in seen
                    seen[key] = i
    assert len(seen) == b * th * tw * plan.cout_blocks


@pytest.mark.parametrize("b,h,w,cin,cout", WINO_PLAN_CASES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_winograd_halo_is_exactly_what_the_tiles_read(b, h, w, cin, cout, padding):
    """A block's halo box is the union of its tiles' 4x4 windows (tile (i, j)
    reads rows 2i - pad .. 2i - pad + 3 of the image); the windows of the
    tiles that hold outputs lie inside it."""
    plan = winograd_plan(b, h, w, cin, cout, padding)
    r, c = plan.patch
    for i in range(0, plan.grid, plan.cout_blocks):
        _, ti0, tj0, _, r0, c0 = plan.block(i)
        rows = {2 * ti - plan.pad + k for ti in range(ti0, ti0 + r) for k in range(4)}
        cols = {2 * tj - plan.pad + k for tj in range(tj0, tj0 + c) for k in range(4)}
        assert rows == set(range(r0, r0 + plan.halo[0]))
        assert cols == set(range(c0, c0 + plan.halo[1]))


@pytest.mark.parametrize("b,h,w,cin,cout,padding,patch,grid", [
    (64, 28, 28, 16, 32, "SAME", (2, 16), 448),     # 14x14 tiles: 2 of 16 columns idle
    (32, 56, 56, 64, 64, "SAME", (4, 8), 1792),     # 28x28 tiles: the 10x18 box
    (1, 13, 13, 3, 5, "SAME", (4, 8), 2),           # 7x7 tiles
    (1, 13, 13, 3, 5, "VALID", (4, 8), 2),          # 6x6 tiles
])
def test_winograd_plan_picks_the_patch_with_least_waste(b, h, w, cin, cout, padding,
                                                         patch, grid):
    plan = winograd_plan(b, h, w, cin, cout, padding)
    assert plan.patch == patch and plan.grid == grid


def test_winograd_plan_shared_memory():
    """Two blocks an SM in image mode (each block also reserves 1 KB)."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = winograd_plan(64, 28, 28, 16, 32, "SAME", dtype)
        assert plan.smem_bytes == smem_bytes(dtype, image=True)
        assert 2 * (plan.smem_bytes + 1024) <= H100_SMEM_PER_SM
    assert smem_bytes(torch.float32) == 85120 and smem_bytes(torch.bfloat16) == 109696


@pytest.mark.parametrize("shape,padding", [((1, 2, 9, 3), "VALID"), ((1, 9, 2, 3), "VALID"),
                                           ((1, 4, 4, 3), "FULL")])
def test_winograd_plan_refuses_what_has_no_output(shape, padding):
    with pytest.raises(ValueError):
        winograd_plan(*shape, 5, padding)
