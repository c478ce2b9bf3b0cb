"""The frozen operation and byte counts against values worked out by hand."""
import json
import math

import pytest

import port_bench_tiny as tiny
import yardstick as Y

CONFIGS = tiny.BENCH / "configs"
MOE = json.loads((CONFIGS / "qwen3-moe-30b-a3b.json").read_text())
DENSE = json.loads((CONFIGS / "qwen1.5-4b.json").read_text())


def test_pairs_under_the_masks():
    assert Y.attn_pairs(4, 4, causal=True) == 10
    assert Y.attn_pairs(4, 4, causal=False) == 16
    assert Y.attn_pairs(4, 4, causal=True, window=2) == 1 + 2 + 2 + 2
    assert Y.attn_pairs(4096, 4096, causal=True) == 4096 * 4097 // 2


def test_flash_bound_at_llama3_8b_prefill_is_0_139_ms():
    # b 4, 32 query and 8 kv heads, s = t = 2048, d 128, causal, bf16
    flops = 4 * 4 * 32 * (2048 * 2049 // 2) * 128
    nbytes = 2 * (2 * 4 * 32 * 2048 * 128 + 2 * 4 * 8 * 2048 * 128)
    assert Y.attn_flops(4, 32, 2048, 2048, 128, True) == flops
    assert Y.flash_fwd_bytes(4, 32, 8, 2048, 2048, 128) == nbytes
    bound = Y.flash_fwd_bound_s(4, 32, 8, 2048, 2048, 128)
    assert bound == pytest.approx(flops / 989e12)
    assert round(bound * 1e3, 3) == 0.139
    assert nbytes / 3.35e12 < flops / 989e12           # bound by operations


def test_memory_bound_call():
    # a short causal call is bound by its bytes
    assert Y.flash_fwd_bound_s(1, 1, 1, 1, 1, 128) == pytest.approx(
        2 * 4 * 128 / 3.35e12)


def test_moe_prefill_by_hand():
    b, s = 4, 4096
    proj = 2 * 2048 * (32 + 8) * 128 + 2 * 32 * 128 * 2048
    ffn = 2 * 2048 * 128 + 8 * 3 * 2 * 2048 * 768
    attn = 4 * b * 32 * (s * (s + 1) // 2) * 128
    want = 48 * (b * s * (proj + ffn) + attn) + b * 2 * 2048 * 151936
    assert Y.prefill_flops(MOE, b, s) == pytest.approx(want, rel=1e-12)
    assert Y.prefill_flops(MOE, b, s) == pytest.approx(1.16e14, rel=0.01)


def test_moe_decode_by_hand():
    b, pos = 4, 4096
    per_token = (2 * 2048 * (32 + 8) * 128 + 2 * 32 * 128 * 2048
                 + 2 * 2048 * 128 + 8 * 3 * 2 * 2048 * 768)
    want = 48 * (b * per_token + 4 * b * 32 * (pos + 1) * 128) + b * 2 * 2048 * 151936
    assert Y.decode_step_flops(MOE, b, pos) == pytest.approx(want, rel=1e-12)
    assert Y.generate_decode_flops(MOE, b, 4096, 8) == pytest.approx(
        sum(Y.decode_step_flops(MOE, b, 4096 + i) for i in range(7)))
    assert Y.generate_decode_flops(MOE, b, 4096, 1) == 0


def test_dense_train_step_by_hand():
    b, s = 6, 4096
    n = b * s
    layer = 2 * 2560 * 60 * 128 + 2 * 20 * 128 * 2560 + 3 * 2 * 2560 * 6912
    attn = 4 * b * 20 * (s * (s + 1) // 2) * 128
    fwd = 40 * (n * layer + attn) + n * 2 * 2560 * 151936
    assert Y.train_step_flops(DENSE, b, s) == pytest.approx(3 * fwd, rel=1e-12)
    assert Y.train_step_flops(DENSE, b, s) == pytest.approx(5.87e14, rel=0.01)


def test_peaks_are_the_data_sheet_values():
    assert (Y.PEAK_BF16_FLOPS, Y.PEAK_TF32_FLOPS, Y.PEAK_F32_FLOPS) == (989e12, 495e12, 67e12)
    assert Y.HBM_BYTES_PER_S == 3.35e12
    assert math.isclose(Y.bound_s(989e12, 0.0), 1.0)
