"""qwen1.5-4b [dense] — MHA with QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    qkv_bias=True,
)

register(ArchEntry(
    arch_id="qwen1.5-4b",
    full=FULL,
    smoke=SMOKE,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    shape_skips=(("long_500k", "pure full-attention arch: quadratic at 500k context"),),
))
