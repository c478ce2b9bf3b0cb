"""A checkout of the benchmark with tiny cells added as files, for the CPU
tests: the benchmark's own files, copied, plus a tiny MoE and a tiny dense
configuration, two traffic mixes at small shapes, and a manifest whose cells
use them and whose metrics are the real manifest's.  The tiny weights are
drawn wider than the published 0.02, so that a two-layer model's next token
hangs on its context the way a deep one's does."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MOE = {"name": "tiny-moe", "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
            "moe_intermediate_size": 32, "num_experts": 8, "num_experts_per_tok": 2,
            "vocab_size": 200, "rope_theta": 1e6, "rms_norm_eps": 1e-6,
            "initializer_range": 0.3, "torch_dtype": "float32"}
TINY_DENSE = {"name": "tiny-dense", "hidden_size": 64, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 16,
              "intermediate_size": 96, "qkv_bias": True, "vocab_size": 256,
              "rope_theta": 1e4, "rms_norm_eps": 1e-6, "initializer_range": 0.3,
              "torch_dtype": "float32"}
#: a tiny window finishes some tens of requests: all of them are compared, so
#: that a fault in any row of a batch shows (a sample of 4 of them could hold
#: only the rows that a fault leaves right)
SERVE = {"loop": "serve", "batch": 2, "prompt_len": 16,
         "new_tokens": 4, "pool_calls": 8, "warmup_calls": 2, "trace_calls": 1,
         "check_requests": 100_000}
TRAIN = {"loop": "train", "batch": 2, "seq_len": 32,
         "optimizer": {"learning_rate": 3e-4, "warmup_steps": 100, "total_steps": 1000,
                       "weight_decay": 0.1, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
                       "grad_clip": 1.0},
         "check_steps": 2, "trace_steps": 1}
#: tiny cell -> (configuration, traffic, the real cell whose limits it takes)
CELLS = {"tiny-moe.serve": ("tiny-moe", "tiny.serve", "qwen3-moe-30b-a3b.serve.doc4k"),
         "tiny-dense.serve": ("tiny-dense", "tiny.serve", "qwen3-moe-30b-a3b.serve.doc4k"),
         "tiny-dense.train": ("tiny-dense", "tiny.train", "qwen1.5-4b.train.seq4k")}


def checkout(tmp: Path) -> Path:
    """A copy of the benchmark under ``tmp`` with the tiny cells added as
    files only; returns the checkout's root."""
    tmp = Path(tmp)
    shutil.copytree(BENCH, tmp / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp / BENCH.name
    for c in (TINY_MOE, TINY_DENSE):
        (bench / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    (bench / "traffic" / "tiny.serve.json").write_text(json.dumps(SERVE))
    (bench / "traffic" / "tiny.train.json").write_text(json.dumps(TRAIN))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"] += [
        {"name": c["name"], "source": "a tiny configuration of the CPU tests",
         "file": f"{BENCH.name}/configs/{c['name']}.json", "reduced": [], "why": "tests"}
        for c in (TINY_MOE, TINY_DENSE)]
    manifest["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tests"}
                              for n, (c, t, _) in CELLS.items()]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [n for n, (_, _, real) in CELLS.items() if real in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    for n, (_, _, real) in CELLS.items():
        shutil.copy(bench / "limits" / f"{real}.json", bench / "limits" / f"{n}.json")
    return tmp


def run(root: Path, cell: str, trace: bool = False, seed: int = 4_294_967_311,
        seconds: float = 0.3):
    import harness
    return harness.run_cell(root, root / BENCH.name, cell, seed, seconds, trace, "cpu")
