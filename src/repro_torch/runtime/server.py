"""Batched serving loop: prefill, then decode over a KV cache.

The port of ``repro.runtime.server``.  ``Server.generate`` prefills a batch
of prompts, then decodes greedily (``temperature <= 0``) or by sampling at
the temperature, for up to N tokens; a slot is done once it emits the EOS
token.  It runs on the device its parameters lie on; sampling draws from an
explicit ``torch.Generator`` there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import RunConfig
from repro_torch.models import build_model
from repro_torch.runtime.steps import decode_step, prefill_step


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0

    @property
    def decode_tok_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


class Server:
    def __init__(self, run_cfg: RunConfig, params: Mapping[str, Any],
                 eos_token: int = 0, temperature: float = 0.0):
        self.run_cfg = run_cfg
        self.model = build_model(run_cfg.model)
        self.params = params
        self.device = params["embed"].device
        self.eos = eos_token
        self.temperature = temperature
        self.stats = ServeStats()

    def _sync(self) -> None:
        """Wait for the device (the reference's ``block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        logits = logits[:, -1, :self.run_cfg.model.vocab_size].float()
        if self.temperature <= 0.0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @staticmethod
    def _grow_cache(cache: Any, extra: int) -> Any:
        """Pad the KV caches (rank-5 (L, b, S, kv, hd) leaves named k/v, at
        any depth of the cache tree) along S so decode has capacity for
        ``extra`` new positions; O(1) recurrent states need no growth."""
        if not isinstance(cache, Mapping):
            return cache
        return {key: (F.pad(v, (0, 0, 0, 0, 0, extra))
                      if key in ("k", "v") and isinstance(v, torch.Tensor) and v.dim() == 5
                      else Server._grow_cache(v, extra))
                for key, v in cache.items()}

    def generate(self, batch: Mapping[str, torch.Tensor], max_new_tokens: int = 16,
                 seed: int = 0) -> np.ndarray:
        """Prefill the prompt batch, then decode up to max_new_tokens.
        Returns the (b, n) int32 token ids."""
        t0 = time.perf_counter()
        logits, cache = prefill_step(self.model, self.params, batch)
        cache = self._grow_cache(cache, max_new_tokens)
        self._sync()
        self.stats.prefill_s += time.perf_counter() - t0

        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok = self._sample(logits, gen)
        out = [tok.cpu().numpy()]
        done = np.zeros(tok.shape[0], bool)
        t0 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            logits, cache = decode_step(self.model, self.params, cache,
                                        {"token": tok[:, None]})
            tok = self._sample(logits, gen)
            arr = tok.cpu().numpy()
            done |= arr == self.eos
            out.append(arr)
            self.stats.tokens_out += int((~done).sum())
            if done.all():
                break
        self._sync()
        self.stats.decode_s += time.perf_counter() - t0
        return np.stack(out, axis=1).astype(np.int32)
