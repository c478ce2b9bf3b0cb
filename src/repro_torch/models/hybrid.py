"""Zamba2-style hybrid LM: Mamba2 backbone + a single weight-SHARED attention
block applied every ``attn_every`` layers.

The port of ``repro.models.hybrid.HybridLM``, the reference package's
simplified block, with its parameter tree; the published Zamba2 (two
blocks over [hidden, embedding], adapters, per-point linears, grouped
Mamba2) is :mod:`repro_torch.models.zamba2` (``zamba2-7b-instruct``).
Structure (G = num_layers // attn_every groups, R = remainder mamba layers):

    for g in 0..G-1:   shared_attn_block(x)  ;  attn_every x mamba(x)
    then R trailing mamba layers

``groups`` is stacked (G, attn_every, ...), ``tail`` (R, ...) exists only
when R > 0, and ``shared`` is one block whose weights every application
reuses; each application has its own KV cache.  Simplifications vs the
released model (the reference's): no per-application LoRA on the shared
block, standard pre-norm residual wiring.  The shared block's causal
self-attention runs the flash op; the Mamba2 layers run plain PyTorch but
for their scan, which a 16-bit prefill on the card runs as the SSD kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig, ShardingConfig
from repro_torch.distributed.sharding import lc
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (ParamSpec, lm_loss_from_hidden, rms_norm,
                                       rms_norm_spec, stack_specs, swiglu, torch_dtype)
from repro_torch.models.transformer import (KV_AXES, LMBase, Params, _layer, position,
                                            position_spec)


class HybridLM(LMBase):
    def __init__(self, cfg: ModelConfig, sharding: Optional[ShardingConfig] = None):
        super().__init__(cfg, sharding)
        self.groups = cfg.num_layers // cfg.attn_every
        self.remainder = cfg.num_layers - self.groups * cfg.attn_every

    # ------------------------------------------------------------------ specs
    def _mamba_specs(self) -> Dict[str, Any]:
        return {"ln": rms_norm_spec(self.cfg.d_model),
                "mixer": ssm.ssm_param_specs(self.cfg)}

    def _shared_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": rms_norm_spec(cfg.d_model),
            "attn": attn.attn_param_specs(cfg),
            "ln2": rms_norm_spec(cfg.d_model),
            "ffn": {
                "w_gate": ParamSpec((cfg.d_model, cfg.d_ff), ("fsdp", "ffn")),
                "w_up": ParamSpec((cfg.d_model, cfg.d_ff), ("fsdp", "ffn")),
                "w_down": ParamSpec((cfg.d_ff, cfg.d_model), ("ffn", "fsdp")),
            },
        }

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        specs = {
            "embed": self._embed_spec(),
            "shared": self._shared_specs(),
            "groups": stack_specs(stack_specs(self._mamba_specs(), cfg.attn_every),
                                  self.groups),
            "ln_f": rms_norm_spec(cfg.d_model),
            "head": self._head_spec(),
        }
        if self.remainder:
            specs["tail"] = stack_specs(self._mamba_specs(), self.remainder)
        return specs

    # ---------------------------------------------------------------- blocks
    def _shared_ffn(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, p["ln2"], self.cfg.norm_eps)
        f = p["ffn"]
        return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])

    def _shared_block(self, p: Params, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        return self._shared_ffn(p, x + attn.attention(p["attn"], self.cfg, h, positions))

    def _mamba_block(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, p["ln"], self.cfg.norm_eps)
        return lc(x + ssm.ssm_mixer(p["mixer"], self.cfg, h), ("batch", "act_seq", "embed"))

    def _group(self, shared: Params, p_group: Params, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        x = self._shared_block(shared, x, positions)
        for j in range(self.cfg.attn_every):
            x = self._remat(self._mamba_block, _layer(p_group, j), x)
        return x

    # ----------------------------------------------------------------- train
    def hidden(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Causal forward -> final-norm hidden (b, s, d).  Remat is nested,
        as in the reference: each group (the shared block and its Mamba2
        layers) is one unit of the remat policy, and so is each Mamba2 layer
        within it, and each tail layer."""
        cfg = self.cfg
        x = self._embed(params, tokens, seq_axis="act_seq")
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for g in range(self.groups):
            x = self._remat(self._group, params["shared"], _layer(params["groups"], g),
                            x, positions)
            x = lc(x, ("batch", "act_seq", "embed"))
        for r in range(self.remainder):
            x = self._remat(self._mamba_block, _layer(params["tail"], r), x)
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return lc(self.hidden(params, tokens) @ params["head"], ("batch", "act_seq", "vocab"))

    def loss(self, params: Params, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self.hidden(params, batch["tokens"])
        loss, ce = lm_loss_from_hidden(x, params["head"], batch["labels"], z_loss=1e-4)
        return loss, {"ce": ce}

    # --------------------------------------------------------------- serving
    def _mamba_prefill(self, p: Params, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h = rms_norm(x, p["ln"], self.cfg.norm_eps)
        out, cache = ssm.ssm_prefill(p["mixer"], self.cfg, h)
        return x + out, cache

    def prefill(self, params: Params, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Full-sequence prefill; returns last-token logits + decode cache:
        {"groups": {"k", "v": (G, b, S, kv, hd), "mamba": {"state": (G, E,
        b, h, p, n) fp32, "conv": (G, E, b, w-1, c)}}, "tail": the same
        mamba tree (R, ...) or None, "pos": S as a 0-d int32 tensor}."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        shared = params["shared"]
        ks = self._kv_cache(self.groups, b, s, x)
        vs = self._kv_cache(self.groups, b, s, x)
        gcaches = []
        for g in range(self.groups):
            h = rms_norm(x, shared["ln1"], cfg.norm_eps)
            h, (ks[g], vs[g]) = attn.attention_prefill(shared["attn"], cfg, h, positions)
            x = self._shared_ffn(shared, x + h)
            p_group = _layer(params["groups"], g)
            mc = []
            for j in range(cfg.attn_every):
                x, c = self._mamba_prefill(_layer(p_group, j), x)
                mc.append(c)
            gcaches.append(_stack(mc))
        tail = None
        if self.remainder:
            tc = []
            for r in range(self.remainder):
                x, c = self._mamba_prefill(_layer(params["tail"], r), x)
                tc.append(c)
            tail = _stack(tc)
        x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
        cache = {"groups": {"k": ks, "v": vs,
                            "mamba": _stack(gcaches)},
                 "tail": tail, "pos": position(s, x.device)}
        return x @ params["head"], cache

    def decode_state_specs(self, shape: ShapeConfig):
        """The cache a prefill of ``shape.seq_len`` leaves, as ``meta``
        tensors, with its logical axes, and the decode token's (``pos``: the
        cache's last slot, as :meth:`DecoderLM.decode_state_specs`)."""
        cfg = self.cfg
        b, S = shape.global_batch, shape.seq_len
        d_inner, heads, headdim, n = ssm._dims(cfg)
        conv_ch = d_inner + 2 * n
        G, E = self.groups, cfg.attn_every
        act = torch_dtype(cfg.dtype)

        def mamba(lead):
            return {"state": torch.empty(lead + (b, heads, headdim, n), dtype=torch.float32,
                                         device="meta"),
                    "conv": torch.empty(lead + (b, cfg.ssm_conv - 1, conv_ch), dtype=act,
                                        device="meta")}
        kv = self._kv_specs(G, b, S)
        cache = {"groups": {"k": kv, "v": kv.clone(), "mamba": mamba((G, E))},
                 "tail": None, "pos": position_spec()}
        cache_axes = {"groups": {"k": KV_AXES, "v": KV_AXES, "mamba": {
                          "state": ("layers", "layers", "batch", "ssm_heads", None, "state"),
                          "conv": ("layers", "layers", "batch", None, "ffn")}},
                      "tail": None, "pos": ()}
        if self.remainder:
            cache["tail"] = mamba((self.remainder,))
            cache_axes["tail"] = {"state": ("layers", "batch", "ssm_heads", None, "state"),
                                  "conv": ("layers", "batch", None, "ffn")}
        return (cache, cache_axes) + self._token_specs(shape)

    def _mamba_decode(self, p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h = rms_norm(x, p["ln"], self.cfg.norm_eps)
        h, cache = ssm.ssm_decode_step(p["mixer"], self.cfg, h, cache)
        return x + h, cache

    def decode_step(self, params: Params, cache: Mapping[str, Any],
                    batch: Mapping[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token per sequence.  Each application's K/V cache is written
        in place; the recurrent states come back as new tensors."""
        cfg = self.cfg
        pos = cache["pos"]
        x = self._embed(params, batch["token"])
        shared = params["shared"]
        gc = cache["groups"]
        gstates = []
        for g in range(self.groups):
            h = rms_norm(x, shared["ln1"], cfg.norm_eps)
            h, _ = attn.attention_decode(shared["attn"], cfg, h, gc["k"][g], gc["v"][g], pos)
            x = self._shared_ffn(shared, x + h)
            p_group, m_group = _layer(params["groups"], g), _layer(gc["mamba"], g)
            mc = []
            for j in range(cfg.attn_every):
                x, c = self._mamba_decode(_layer(p_group, j), x, _layer(m_group, j))
                mc.append(c)
            gstates.append(_stack(mc))
        tail = cache["tail"]
        if self.remainder:
            tc = []
            for r in range(self.remainder):
                x, c = self._mamba_decode(_layer(params["tail"], r), x,
                                          _layer(cache["tail"], r))
                tc.append(c)
            tail = _stack(tc)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x @ params["head"], {
            "groups": {"k": gc["k"], "v": gc["v"], "mamba": _stack(gstates)},
            "tail": tail, "pos": pos + 1}


def _stack(trees):
    """A list of equal trees of tensors as one tree stacked on a new
    leading dim."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)
