"""llama3-8b [dense] — GQA, 128k vocab.  [arXiv:2407.21783; unverified]"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    rope_theta=5e5,
)

register(ArchEntry(
    arch_id="llama3-8b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2407.21783; unverified",
    shape_skips=(("long_500k", "pure full-attention arch: quadratic at 500k context"),),
))
