"""internvl2-2b [vlm] — InternViT frontend + InternLM2 backbone.
[arXiv:2404.16821; hf]

The InternViT vision frontend is a STUB: ``input_specs`` provides precomputed
patch embeddings of shape (batch, frontend_seq, d_model) prepended to the text
sequence; the InternLM2-1.8B language backbone is fully modeled.
"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision_patches",
    frontend_seq=256,          # 256 visual tokens per image tile
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend="vision_patches",
    frontend_seq=8,
    rope_theta=1e6,
)

register(ArchEntry(
    arch_id="internvl2-2b",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2404.16821; hf",
    shape_skips=(("long_500k", "pure full-attention arch: quadratic at 500k context"),),
))
