"""Batched serving loop: prefill, then decode over a KV cache.

The port of ``repro.runtime.server``.  ``Server`` owns compiled prefill and
decode steps for one RunConfig (``prefill_bundle(...).jit()`` and
``decode_bundle(...).jit()``, as the reference's): on the card each is a
CUDA graph per shape, captured at its first call and replayed after, the
two graphs in one memory pool; on the CPU each is its plain step.
``generate`` prefills a batch of prompts, then decodes greedily
(``temperature <= 0``) or by sampling at the temperature, for up to N
tokens; a slot is done once it emits the EOS token.  Sampling runs outside
the steps, as the reference samples outside its jitted ones, from an
explicit ``torch.Generator`` on the device the parameters lie on.

The decode step reads a cache the server owns, one per (batch, prompt
length, new tokens): each ``generate`` copies the prefill's cache into it
once, and the decode graph reads it in place and advances it.  The
prefill's cache (an output of its graph) is copied before the decode
graph, in the same pool, replays; the decode's logits are sampled before
the next replay.

A call's phases are spans (:data:`repro_torch.obs.TRACER`), all carrying
the call's number: ``server.prefill`` (the prefill step's call),
``server.cache_copy``, ``server.decode_step`` (each decode step's call),
``server.sample`` and ``server.token_read`` (a token's read to the host).
The routing counts the steps made while a profiler recorded
(:mod:`repro_torch.obs.routing`) reach the registry at the sync a call
ends with.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves, tree_map_only

from repro_torch.config import RunConfig
from repro_torch.obs import routing
from repro_torch.obs.trace import TRACER
from repro_torch.runtime.jit import GraphPool
from repro_torch.runtime.steps import decode_bundle, prefill_bundle


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
        self.params = params
        self.device = params["embed"].device
        self.eos = eos_token
        self.temperature = temperature
        pool = GraphPool()
        self._prefill = prefill_bundle(run_cfg).jit(pool)
        self._decode = decode_bundle(run_cfg).jit(pool)
        self._caches: dict = {}
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
    def _grow_cache(cache: Any, extra: int, into: Any = None) -> Any:
        """Pad the KV caches (rank-5 (L, b, S, kv, hd) leaves named k/v, at
        any depth of the cache tree) with zeros along S so decode has
        capacity for ``extra`` new positions; O(1) recurrent states need no
        growth.  With ``into`` (a grown cache of these shapes) every leaf is
        written into it instead."""
        if not isinstance(cache, Mapping):
            return cache
        out = {}
        for key, v in cache.items():
            dst = None if into is None else into[key]
            if isinstance(v, Mapping):
                out[key] = Server._grow_cache(v, extra, dst)
            elif not isinstance(v, torch.Tensor):
                out[key] = v
            elif key in ("k", "v") and v.dim() == 5:
                if dst is None:
                    out[key] = F.pad(v, (0, 0, 0, 0, 0, extra))
                else:
                    dst[:, :, :v.shape[2]].copy_(v)
                    dst[:, :, v.shape[2]:].zero_()
                    out[key] = dst
            else:
                out[key] = v if dst is None else dst.copy_(v)
        return out

    def _decode_cache(self, cache: Any, extra: int) -> Any:
        """The prefill's ``cache`` grown by ``extra`` positions, in the
        server's own cache of its shapes (made at the first call from a copy:
        the prefill's states are outputs of its graph)."""
        key = (extra,) + tuple((tuple(t.shape), t.dtype) for t in tree_leaves(cache)
                               if isinstance(t, torch.Tensor))
        own = self._caches.get(key)
        if own is None:
            own = self._caches[key] = self._grow_cache(
                tree_map_only(torch.Tensor, torch.clone, cache), extra)
        else:
            self._grow_cache(cache, extra, own)
        return own

    def generate(self, batch: Mapping[str, torch.Tensor], max_new_tokens: int = 16,
                 seed: int = 0) -> np.ndarray:
        """Prefill the prompt batch, then decode up to max_new_tokens.
        Returns the (b, n) int32 token ids."""
        with TRACER.request():
            return self._generate(batch, max_new_tokens, seed)

    def _generate(self, batch: Mapping[str, torch.Tensor], max_new_tokens: int,
                  seed: int) -> np.ndarray:
        t0 = time.perf_counter()
        # the prefill's graph reads its prompts where the first call's lay:
        # hand it tensors of the server's own, not the caller's
        with TRACER.span("server.prefill"):
            logits, cache = self._prefill(self.params,
                                          {k: v.clone() for k, v in batch.items()})
        with TRACER.span("server.cache_copy"):
            cache = self._decode_cache(cache, max_new_tokens)
        self._sync()
        self.stats.prefill_s += time.perf_counter() - t0

        gen = torch.Generator(device=self.device).manual_seed(seed)
        with TRACER.span("server.sample"):
            tok = self._sample(logits, gen)
        with TRACER.span("server.token_read"):
            out = [tok.cpu().numpy()]
        done = np.zeros(tok.shape[0], bool)
        t0 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            with TRACER.span("server.decode_step"):
                logits, cache = self._decode(self.params, cache, {"token": tok[:, None]})
            with TRACER.span("server.sample"):
                tok = self._sample(logits, gen)
            with TRACER.span("server.token_read"):
                arr = tok.cpu().numpy()
            done |= arr == self.eos
            out.append(arr)
            self.stats.tokens_out += int((~done).sum())
            if done.all():
                break
        self._sync()
        self.stats.decode_s += time.perf_counter() - t0
        routing.flush()
        return np.stack(out, axis=1).astype(np.int32)
