"""Zamba2 as published (family ``zamba2``): Mamba2 layers, and before some
of them one of a few shared transformer blocks.

The equations are those of ``transformers``' ``modeling_zamba2.py``
(``Zamba2HybridLayer``, ``Zamba2AttentionDecoderLayer``, ``Zamba2MLP``,
``Zamba2MambaDecoderLayer``, ``Zamba2MambaMixer``), with the config's keys
in :class:`~repro_torch.config.Zamba2Config`:

* every layer is a Mamba2 layer, ``x + mixer(norm(x + extra))``, its B and
  C in ``ssm_ngroups`` groups (:mod:`repro_torch.models.ssm`);
* before the layers in ``hybrid_layers`` (the application points), block
  ``j % shared_blocks`` of the shared blocks runs on [x, the embedding] (2d
  wide): an RMS norm of the concatenation, attention of heads of
  2d / heads with RoPE over the whole head and scores scaled by
  (head_dim / 2) ** -0.5 (the flash op's ``scale``), an RMS norm of its
  output, and a GELU-gated MLP whose ``gate_up`` product has the point's
  own rank-``adapter_rank`` adapter added; no residual inside the block.
  The point's own d x d ``linear`` maps the block's output, and that is
  ``extra``: it joins the Mamba2 layer's input, not the residual stream;
* the head is the embedding's transpose (``tie_embeddings``).

Norm weights are stored as ``gamma`` in a ``(1 + gamma)`` scale, as the
port's other models store them.  The tree: ``embed``, ``blocks`` (stacked
on the shared blocks), ``points`` (each point's adapter and linear,
stacked), ``layers`` (the Mamba2 layers, stacked), ``ln_f``.

Serving: a prefill leaves one K/V cache a point, (points, b, S, kv, hd),
and one Mamba2 state and conv window a layer, in one cache tree; a decode
step carries the token's embedding to every point, as the prefill carries
the prompt's.  Each application of a block is the region ``shared.block``
(the flash op keeps its own nested ``attn.flash_fwd``) and counts on
``shared_block_applications_total`` with its ``block``
(:func:`repro_torch.obs.regions.count`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ShapeConfig, ShardingConfig, Zamba2Config
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.hybrid import _stack
from repro_torch.models.layers import ParamSpec, dense, rms_norm, rms_norm_spec, stack_specs
from repro_torch.models.transformer import (KV_AXES, LMBase, Params, _layer, position,
                                            position_spec)
from repro_torch.obs import region
from repro_torch.obs.regions import count


class Zamba2LM(LMBase):
    def __init__(self, cfg: Zamba2Config, sharding: Optional[ShardingConfig] = None):
        super().__init__(cfg, sharding)
        #: layer index -> application point
        self.points = {layer: j for j, layer in enumerate(cfg.hybrid_layers)}
        self.scale = (cfg.resolved_head_dim / 2) ** -0.5

    # ------------------------------------------------------------------ specs
    def _block_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        return {
            "ln1": rms_norm_spec(2 * d),
            "attn": {"wq": ParamSpec((2 * d, h * hd), ("fsdp", "qkv")),
                     "wk": ParamSpec((2 * d, kv * hd), ("fsdp", "qkv")),
                     "wv": ParamSpec((2 * d, kv * hd), ("fsdp", "qkv")),
                     "wo": ParamSpec((h * hd, d), ("qkv", "fsdp"))},
            "ln2": rms_norm_spec(d),
            "mlp": {"w_gate_up": ParamSpec((d, 2 * cfg.d_ff), ("fsdp", "ffn")),
                    "w_down": ParamSpec((cfg.d_ff, d), ("ffn", "fsdp"))},
        }

    def _point_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d, r = cfg.d_model, cfg.adapter_rank
        return {"adapter_a": ParamSpec((d, r), ("fsdp", None)),
                "adapter_b": ParamSpec((r, 2 * cfg.d_ff), (None, "ffn")),
                "linear": ParamSpec((d, d), ("fsdp", None))}

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": self._embed_spec(),
            "blocks": stack_specs(self._block_specs(), cfg.shared_blocks),
            "points": stack_specs(self._point_specs(), len(cfg.hybrid_layers)),
            "layers": stack_specs({"ln": rms_norm_spec(cfg.d_model),
                                   "mixer": ssm.ssm_param_specs(cfg, cfg.ssm_ngroups)},
                                  cfg.num_layers),
            "ln_f": rms_norm_spec(cfg.d_model),
        }

    # ---------------------------------------------------------------- blocks
    def block_of(self, point: int) -> int:
        """The shared block applied at ``point``: they take turns."""
        return point % self.cfg.shared_blocks

    def _mlp(self, p_block: Params, p_point: Params, h: torch.Tensor) -> torch.Tensor:
        """The block's MLP on its attention's output, with the point's
        adapter, mapped by the point's linear."""
        h = rms_norm(h, p_block["ln2"], self.cfg.norm_eps)
        gate_up = dense(h, p_block["mlp"]["w_gate_up"]) + dense(
            dense(h, p_point["adapter_a"]), p_point["adapter_b"])
        gate, up = gate_up.chunk(2, dim=-1)
        out = dense(F.gelu(gate) * up, p_block["mlp"]["w_down"])
        return dense(out, p_point["linear"])

    def _shared(self, params: Params, point: int, x: torch.Tensor, emb: torch.Tensor,
                attend) -> Tuple[torch.Tensor, Any]:
        """The block of ``point`` on [x, emb]: its output mapped by the
        point's linear, and what ``attend(p_attn, h)`` returns beside the
        attention's output (the K/V it wrote)."""
        block = self.block_of(point)
        with region("shared.block"):
            p_block = _layer(params["blocks"], block)
            h = rms_norm(torch.cat([x, emb], dim=-1), p_block["ln1"], self.cfg.norm_eps)
            h, kv = attend(p_block["attn"], h)
            out = self._mlp(p_block, _layer(params["points"], point), h)
        count("shared_block_applications_total", 1, block=str(block))
        return out, kv

    def _mamba(self, p: Params, x: torch.Tensor, extra: Optional[torch.Tensor],
               cache: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """A Mamba2 layer on x (with ``extra`` added to its input): over the
        whole sequence, or one decode step from ``cache``; and its cache."""
        h = rms_norm(x if extra is None else x + extra, p["ln"], self.cfg.norm_eps)
        if cache is None:
            h, cache = ssm.ssm_prefill(p["mixer"], self.cfg, h, self.cfg.ssm_ngroups,
                                       self.cfg.ssm_chunk)
        else:
            h, cache = ssm.ssm_decode_step(p["mixer"], self.cfg, h, cache, self.cfg.ssm_ngroups)
        return x + h, cache

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        with region("lm_head"):
            return x @ params["embed"].t()

    # ---------------------------------------------------------------- prefill
    def _prefill_layers(self, params: Params, tokens: torch.Tensor,
                        caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """Every layer over the whole prompt: the last hidden (b, s, d) and
        each layer's Mamba2 cache; each point's K and V written into
        ``caches`` (the (points, b, s, kv, hd) K and V caches) where given."""
        x = emb = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

        def attend(p_attn, h):
            return attn.attention_prefill(p_attn, self.cfg, h, positions, scale=self.scale)
        states = []
        for i in range(self.cfg.num_layers):
            extra = None
            if i in self.points:
                j = self.points[i]
                extra, (k, v) = self._shared(params, j, x, emb, attend)
                if caches is not None:
                    caches[0][j], caches[1][j] = k, v
            x, c = self._mamba(_layer(params["layers"], i), x, extra)
            states.append(c)
        return x, states

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Full logits (b, s, padded vocab)."""
        x, _ = self._prefill_layers(params, tokens)
        return self._logits(params, x)

    def prefill(self, params: Params, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Last-token logits and the decode cache: {"k", "v": (points, b, S,
        kv, hd), "mamba": {"state": (L, b, h, p, n) fp32, "conv": (L, b,
        w - 1, c)}, "pos": S as a 0-d int32 tensor}.  Each point's K and V
        go into the cache as they are made."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        like = params["embed"]
        ks = self._kv_cache(len(self.cfg.hybrid_layers), b, s, like)
        vs = self._kv_cache(len(self.cfg.hybrid_layers), b, s, like)
        x, states = self._prefill_layers(params, tokens, (ks, vs))
        return self._logits(params, x[:, -1:]), {"k": ks, "v": vs, "mamba": _stack(states),
                                                 "pos": position(s, x.device)}

    # ---------------------------------------------------------------- decode
    def decode_state_specs(self, shape: ShapeConfig):
        """The cache a prefill of ``shape.seq_len`` leaves, as ``meta``
        tensors, with its logical axes, and the decode token's."""
        cfg = self.cfg
        b, S, L = shape.global_batch, shape.seq_len, cfg.num_layers
        _, heads, headdim, n = ssm._dims(cfg)
        kv = self._kv_specs(len(cfg.hybrid_layers), b, S)
        conv_ch = ssm.conv_channels(cfg, cfg.ssm_ngroups)
        mamba = {"state": torch.empty((L, b, heads, headdim, n), dtype=torch.float32,
                                      device="meta"),
                 "conv": torch.empty((L, b, cfg.ssm_conv - 1, conv_ch), dtype=kv.dtype,
                                     device="meta")}
        cache = {"k": kv, "v": kv.clone(), "mamba": mamba, "pos": position_spec()}
        axes = {"k": KV_AXES, "v": KV_AXES,
                "mamba": {"state": ("layers", "batch", "ssm_heads", None, "state"),
                          "conv": ("layers", "batch", None, "ffn")}, "pos": ()}
        return (cache, axes) + self._token_specs(shape)

    def decode_step(self, params: Params, cache: Mapping[str, Any],
                    batch: Mapping[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token per sequence.  Each point's K/V cache is written in
        place; the recurrent states come back as new tensors."""
        pos = cache["pos"]
        x = emb = self._embed(params, batch["token"])
        states = []
        for i in range(self.cfg.num_layers):
            extra = None
            if i in self.points:
                j = self.points[i]

                def attend(p_attn, h):
                    return attn.attention_decode(p_attn, self.cfg, h, cache["k"][j],
                                                 cache["v"][j], pos, scale=self.scale)
                extra, _ = self._shared(params, j, x, emb, attend)
            x, c = self._mamba(_layer(params["layers"], i), x, extra,
                               _layer(cache["mamba"], i))
            states.append(c)
        return self._logits(params, x), {"k": cache["k"], "v": cache["v"],
                                         "mamba": _stack(states), "pos": pos + 1}
