"""Decoder-only transformer LM, ``family == "dense"`` (llama3-8b).

The port of ``repro.models.transformer.DecoderLM``.  It keeps the
reference's parameter tree — ``embed``, ``layers`` stacked on a leading
(L, ...) axis, ``ln_f``, ``head`` — so weights transfer 1:1
(:func:`params_from_jax`), and loops over the layers in Python where the
reference runs ``lax.scan``.  The KV cache is ``{"k", "v": (L, b, S, kv,
hd), "pos": int}``; prefill fills it layer by layer and decode updates it in
place.  The ``moe`` and ``vlm`` families come with their own modules later.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamSpec, init_params, pad_vocab,
                                       rms_norm, rms_norm_spec, stack_specs,
                                       swiglu, torch_dtype)

Params = Dict[str, Any]


def _tensor(a: Any) -> torch.Tensor:
    """A numpy array (bfloat16 included, which torch cannot read directly)
    as a CPU tensor that owns its memory."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(params: Mapping[str, Any],
                    cfg: Optional[ModelConfig] = None) -> Params:
    """The reference package's DecoderLM parameters (a tree of numpy arrays)
    as the port's: the same tree of CPU tensors.

    With ``cfg`` every name, shape and dtype is checked against
    :meth:`DecoderLM.param_specs`.
    """
    def conv(tree):
        if isinstance(tree, Mapping):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree)

    out = conv(params)
    if cfg is not None:
        _check_tree(out, DecoderLM(cfg).param_specs(), torch_dtype(cfg.dtype), "")
    return out


def _check_tree(vals: Any, specs: Any, dtype: torch.dtype, where: str) -> None:
    if isinstance(specs, ParamSpec):
        if tuple(vals.shape) != specs.shape or vals.dtype != dtype:
            raise ValueError(f"{where}: got {tuple(vals.shape)} {vals.dtype}, "
                             f"expected {specs.shape} {dtype}")
        return
    if not isinstance(vals, Mapping) or set(vals) != set(specs):
        got = sorted(vals) if isinstance(vals, Mapping) else type(vals).__name__
        raise KeyError(f"{where or 'params'}: names {got} != {sorted(specs)}")
    for k in specs:
        _check_tree(vals[k], specs[k], dtype, f"{where}/{k}")


def _layer(tree: Any, idx: int) -> Any:
    """Layer ``idx`` of a stacked (L, ...) parameter tree (views, no copies)."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


class DecoderLM:
    """The dense decoder-only LM: specs, init, forward, prefill and decode."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (only 'dense')")
        self.cfg = cfg

    # ------------------------------------------------------------------ specs
    def layer_specs(self) -> Dict[str, Any]:
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
        return {
            "embed": ParamSpec((pad_vocab(cfg.vocab_size), cfg.d_model),
                               (None, "embed_tbl"), init="embed", scale=0.02),
            "layers": stack_specs(self.layer_specs(), cfg.num_layers),
            "ln_f": rms_norm_spec(cfg.d_model),
            "head": ParamSpec((cfg.d_model, pad_vocab(cfg.vocab_size)),
                              ("fsdp", "vocab")),
        }

    def init(self, seed: int = 0,
             device: Optional[Union[str, torch.device]] = None) -> Params:
        """Random weights from ``seed``, drawn on ``device`` (default cuda)."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return init_params(self.param_specs(), gen, self.cfg.dtype)

    # ---------------------------------------------------------------- embed
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(torch_dtype(self.cfg.dtype))

    def _window_for(self, idx: int) -> int:
        cfg = self.cfg
        if cfg.global_every <= 0:
            return cfg.window_size
        return 0 if (idx + 1) % cfg.global_every == 0 else cfg.window_size

    def _ffn(self, p_l: Params, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, p_l["ln2"], self.cfg.norm_eps)
        f = p_l["ffn"]
        return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])

    # ---------------------------------------------------------------- train
    def hidden(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Causal forward -> final-norm hidden (b, s, d)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for idx in range(cfg.num_layers):
            p_l = _layer(params["layers"], idx)
            h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
            x = x + attn.attention(p_l["attn"], cfg, h, positions,
                                   window=self._window_for(idx))
            x = self._ffn(p_l, x)
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def forward(self, params: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full logits and the MoE aux loss (zero for a dense model)."""
        logits = self.hidden(params, tokens) @ params["head"]
        return logits, torch.zeros((), device=logits.device)

    # -------------------------------------------------------------- prefill
    def prefill(self, params: Params, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Returns (last-token logits, cache). Cache K/V: (L, b, S, kv, hd)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        shape = (cfg.num_layers, b, s, cfg.num_kv_heads, cfg.resolved_head_dim)
        ks = torch.empty(shape, dtype=x.dtype, device=x.device)
        vs = torch.empty(shape, dtype=x.dtype, device=x.device)
        for idx in range(cfg.num_layers):
            p_l = _layer(params["layers"], idx)
            h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
            h, (k, v) = attn.attention_prefill(p_l["attn"], cfg, h, positions,
                                               window=self._window_for(idx))
            ks[idx] = k
            vs[idx] = v
            x = self._ffn(p_l, x + h)
        x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
        return x @ params["head"], {"k": ks, "v": vs, "pos": s}

    # --------------------------------------------------------------- decode
    def decode_step(self, params: Params, cache: Mapping[str, Any],
                    batch: Mapping[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """batch: {"token": (b, 1)}. Returns (logits, cache advanced by one).

        The new token's k and v are written into ``cache["k"]`` and
        ``cache["v"]`` in place, so the cache exists once in device memory
        (the reference gets the same from its while loop's aliased carry).
        """
        cfg = self.cfg
        pos = cache["pos"]
        x = self._embed(params, batch["token"])
        for idx in range(cfg.num_layers):
            p_l = _layer(params["layers"], idx)
            h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
            h, _ = attn.attention_decode(p_l["attn"], cfg, h, cache["k"][idx],
                                         cache["v"][idx], pos,
                                         window=self._window_for(idx))
            x = self._ffn(p_l, x + h)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x @ params["head"], {"k": cache["k"], "v": cache["v"],
                                    "pos": pos + 1}
