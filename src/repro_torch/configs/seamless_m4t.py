"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal backbone.
[arXiv:2308.11596; hf]

The audio frontend (conformer feature extractor) is a STUB: ``input_specs``
provides precomputed frame embeddings of shape (batch, frontend_seq, d_model);
the enc-dec transformer backbone is fully modeled.
"""
from repro_torch.config import ArchEntry, ModelConfig, register

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,             # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio_frames",
    frontend_seq=1024,         # precomputed speech frame embeddings fed to encoder
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    frontend="audio_frames",
    frontend_seq=16,
)

register(ArchEntry(
    arch_id="seamless-m4t-large-v2",
    full=FULL,
    smoke=SMOKE,
    source="arXiv:2308.11596; hf",
    shape_skips=(("long_500k", "pure full-attention enc-dec: quadratic at 500k context"),),
))
