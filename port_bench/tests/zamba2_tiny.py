"""A tiny configuration of the published Zamba2 in its own keys, for the CPU
tests: the full configuration's file with its widths and depth made small
(two shared blocks at three points, two groups of two Mamba2 heads, chunks
of 16) and fp32, and its weights drawn wider than the published 0.02."""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

FULL = json.loads((BENCH / "configs" / "zamba2-7b-instruct.json").read_text())
LAYERS, POINTS = 7, [1, 3, 5]
TINY = dict(FULL, name="tiny-zamba2", hidden_size=128, num_hidden_layers=LAYERS,
            hybrid_layer_ids=POINTS,
            layers_block_type=["hybrid" if i in POINTS else "mamba" for i in range(LAYERS)],
            num_attention_heads=4, num_key_value_heads=4, num_query_groups=4,
            attention_head_dim=64, attention_hidden_size=256, kv_channels=32,
            intermediate_size=256, ffn_hidden_size=256, mamba_d_state=16,
            n_mamba_heads=4, chunk_size=16, adapter_rank=8, vocab_size=256,
            torch_dtype="float32", initializer_range=0.1)
