"""gemma3-27b [dense] — 5:1 local:global attention, 128k ctx.  [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    window_size=1024,
    global_every=6,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="gemma3-27b-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    window_size=16,
    global_every=3,
    rope_theta=1e6,
)

register(ArchEntry(
    arch_id="gemma3-27b",
    full=FULL,
    smoke=SMOKE,
    source="hf:google/gemma-3-1b-pt; unverified",
    shape_skips=(
        ("long_500k",
         "global layers (every 6th) are full attention -> family counts as full-attention"),
    ),
    accum_steps=2,   # 62L x 262k-vocab: halve per-microbatch activations
))
