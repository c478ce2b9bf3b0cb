"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

The reference package's simplified block, kept as the reference has it: 81
Mamba2 layers (one group of B and C); a single *shared* (weight-tied)
attention+MLP block is applied every 6 layers (81 // 6 = 13 application
points), each with its own KV cache.  The published model (two blocks over
[hidden, embedding], heads of 224, adapters) is ``zamba2-7b-instruct``.
"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    attn_every=2,
)

register(ArchEntry(
    arch_id="zamba2-7b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2411.15242; unverified",
    shape_skips=(),   # hybrid: long_500k RUNS (O(1) SSM state + linear-cost decode attn)
))
