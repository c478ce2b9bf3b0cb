"""gemma3-12b [dense] — 5:1 local:global attention, 128k ctx.  [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    window_size=1024,
    global_every=6,      # 5 local : 1 global
    logit_softcap=0.0,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    window_size=16,
    global_every=2,
    rope_theta=1e6,
)

register(ArchEntry(
    arch_id="gemma3-12b",
    full=FULL,
    smoke=SMOKE,
    source="hf:google/gemma-3-1b-pt; unverified",
    shape_skips=(
        ("long_500k",
         "global layers (every 6th) are full attention -> family counts as full-attention"),
    ),
))
