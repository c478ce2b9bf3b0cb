"""zamba2-7b-instruct [zamba2] — Zamba2-7B as published: 81 Mamba2 layers
(112 heads of 64, state 64, 2 groups of B and C, chunks of 256) and two
shared transformer blocks, taking turns at 13 points, over [hidden,
embedding] (7,168 wide) with 32 heads of 224 and a GELU-gated MLP of 14,336
with a rank-128 adapter and a d x d linear of each point's own; the head
tied to the embedding.  Every key is the published config's.
[hf Zyphra/Zamba2-7B-Instruct config.json]

``zamba2-7b`` beside it is the reference package's simplified block.
"""
from repro_torch.config import ArchEntry, Zamba2Config, register

FULL = Zamba2Config(
    name="zamba2-7b-instruct",
    family="zamba2",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=2,
    ssm_chunk=256,
    hybrid_layers=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    shared_blocks=2,
    adapter_rank=128,
    rope_theta=10000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
)

#: the same structure at a small size: two blocks at three points (0, 1, 0),
#: two groups of two Mamba2 heads each, and chunks of 16 (a ragged last one
#: at any length that is not a multiple of 16)
SMOKE = Zamba2Config(
    name="zamba2-instruct-smoke",
    family="zamba2",
    num_layers=7,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=256,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_ngroups=2,
    ssm_chunk=16,
    hybrid_layers=(1, 3, 5),
    shared_blocks=2,
    adapter_rank=8,
    rope_theta=10000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
)

register(ArchEntry(
    arch_id="zamba2-7b-instruct",
    full=FULL,
    smoke=SMOKE,
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json",
))
