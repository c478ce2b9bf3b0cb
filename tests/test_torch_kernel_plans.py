"""The host-side plans of the port's CUDA kernels, on the CPU: the K-split
count of ``tiled_matmul``, the TMA layout check of the bf16 flash kernel,
and the build digest that names each library.  None of them needs a card."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import check_tma_layout
from repro_torch.kernels.tiled_matmul.kernel import (BLOCK_CONFIGS, BLOCKS_PER_SM,
                                                     MIN_SLABS_PER_SPLIT, split_k_plan)

H100_SMS = 132

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


@pytest.mark.parametrize("d", [32, 64, 128])
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
