"""Deterministic synthetic data sources (offline container: no real corpora).

The LM stream is a Zipf-distributed Markov-ish token process — enough structure
that cross-entropy visibly falls during the example training runs, while being
fully reproducible from a seed.  The MNIST stream draws one of ten procedural
digit templates plus noise, so LeNet genuinely learns (paper §IV trains LeNet).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


def synthetic_lm_batches(cfg: ModelConfig, batch: int, seq: int,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {tokens, labels} (+ frontend_emb for vlm/audio stubs)."""
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size
    # Zipf-ish unigram distribution over a capped support
    support = min(vocab, 4096)
    ranks = np.arange(1, support + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    # order-1 structure: each token deterministically biases the next
    shift = 17
    while True:
        base = rng.choice(support, size=(batch, seq + 1), p=probs)
        prev = np.roll(base, 1, axis=1)
        mix = rng.random((batch, seq + 1)) < 0.3
        toks = np.where(mix, (prev * shift + 3) % support, base).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend != "none":
            out["frontend_emb"] = rng.standard_normal(
                (batch, cfg.frontend_seq, cfg.d_model)).astype(np.float32) * 0.02
        yield out


def _digit_templates(hw: int) -> np.ndarray:
    """Ten distinct procedural 'digit' patterns (hw, hw)."""
    t = np.zeros((10, hw, hw), np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / (hw - 1)
    for d in range(10):
        a, b = (d % 5) + 1, (d // 5) + 1
        t[d] = (np.sin(np.pi * a * xx + d) * np.cos(np.pi * b * yy - d) > 0.1)
    return t


def synthetic_mnist_batches(cfg: ModelConfig, batch: int,
                            seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    hw = cfg.image_hw
    templates = _digit_templates(hw)
    while True:
        labels = rng.integers(0, cfg.num_classes, size=batch).astype(np.int32)
        imgs = templates[labels] + 0.3 * rng.standard_normal(
            (batch, hw, hw)).astype(np.float32)
        yield {"images": imgs[..., None].astype(np.float32), "labels": labels}


def batches_for(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
    if cfg.family == "conv":
        return synthetic_mnist_batches(cfg, shape.global_batch, seed)
    text = shape.seq_len
    if cfg.frontend != "none":
        text = max(shape.seq_len - cfg.frontend_seq, 1)
    return synthetic_lm_batches(cfg, shape.global_batch, text, seed)
