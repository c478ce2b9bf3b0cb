"""rwkv6-1.6b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,          # 32 heads of 64
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    d_ff=128,
    vocab_size=256,
    rwkv_head_dim=16,
)

register(ArchEntry(
    arch_id="rwkv6-1.6b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2404.05892; unverified",
    shape_skips=(),   # linear attention: long_500k RUNS
))
