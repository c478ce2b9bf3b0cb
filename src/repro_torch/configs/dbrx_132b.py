"""dbrx-132b [moe] — 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base; unverified]"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,               # per-expert
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="dbrx-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
    rope_theta=5e5,
)

register(ArchEntry(
    arch_id="dbrx-132b",
    full=FULL,
    smoke=SMOKE,
    source="hf:databricks/dbrx-base; unverified",
    shape_skips=(("long_500k", "pure full-attention arch: quadratic at 500k context"),),
    accum_steps=8,   # 132B params: activations must shrink to fit 16GB HBM
))
