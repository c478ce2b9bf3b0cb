"""The one traffic generator: turns a traffic file's parameters and a seed
into the inputs a loop hands to the program.

* Prompts: (batch, prompt_len) token ids
  drawn uniformly from the vocabulary on the device, one generator per
  call, seeded from (seed, call), as ``launch/serve.py::make_prompts``
  draws them.
* Training batches: a copy of
  ``data/synthetic.py::synthetic_lm_batches``: a Zipf unigram over the
  4096 most frequent ids, with three tokens in ten replaced by a fixed
  function of the one before, so the loss has something to learn; drawn on
  the host from ``numpy``'s generator seeded with the run's seed, new rows
  every step.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping

import numpy as np
import torch


def prompt_seed(seed: int, call: int) -> int:
    return (seed * 1_000_033 + 7919 * (call + 1)) % (1 << 63)


def prompts(traffic: Mapping, cfg: Mapping, seed: int, call: int, device) -> torch.Tensor:
    """The prompts of one call: (batch, prompt_len) int32 ids."""
    gen = torch.Generator(device=device).manual_seed(prompt_seed(seed, call))
    return torch.randint(0, cfg["vocab_size"], (traffic["batch"], traffic["prompt_len"]),
                         generator=gen, device=device, dtype=torch.int32)


def lm_batches(traffic: Mapping, cfg: Mapping, seed: int) -> Iterator[Dict[str, np.ndarray]]:
    """Training batches {tokens, labels} of (batch, seq_len) int32."""
    batch, seq = traffic["batch"], traffic["seq_len"]
    rng = np.random.default_rng(seed)
    support = min(cfg["vocab_size"], 4096)
    ranks = np.arange(1, support + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    shift = 17
    while True:
        base = rng.choice(support, size=(batch, seq + 1), p=probs)
        prev = np.roll(base, 1, axis=1)
        mix = rng.random((batch, seq + 1)) < 0.3
        toks = np.where(mix, (prev * shift + 3) % support, base).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
