"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8, fine-grained d_ff=768.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                 # per-expert
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    rope_theta=1e6,
)

register(ArchEntry(
    arch_id="qwen3-moe-30b-a3b",
    full=FULL,
    smoke=SMOKE,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
    shape_skips=(("long_500k", "pure full-attention arch: quadratic at 500k context"),),
))
