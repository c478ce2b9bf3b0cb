"""Encoder-decoder transformer (seamless-m4t backbone, family "audio"/"encdec").

The port of ``repro.models.encdec.EncDecLM``, with its parameter tree
(``encoder`` and ``decoder`` stacked on a leading layer axis).  The audio
frontend is a stub, as in the reference: the encoder consumes precomputed
frame embeddings (b, frontend_seq, d_model).  Decoder = causal self-attention
+ cross-attention over the encoder's output + a 2-matrix ReLU FFN, pre-RMSNorm.

Every full-sequence attention runs the flash op: the encoder's non-causal
self-attention, the decoder's causal self-attention and the
cross-attention (s queries against the encoder's t rows, in prefill and,
recomputed from the encoder's output at every step as the reference does,
in decode).  Decode self-attention against its cache is plain math.  The
cache is {"k", "v": (L, b, S, kv, hd), "enc_out": (b, t, d), "pos": int}.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamSpec, dense, lm_loss_from_hidden, rms_norm,
                                       rms_norm_spec, stack_specs, torch_dtype)
from repro_torch.models.transformer import LMBase, Params, _layer


class EncDecLM(LMBase):
    # ------------------------------------------------------------------ specs
    def _ffn_specs(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        return {
            "w_in": ParamSpec((cfg.d_model, cfg.d_ff), ("fsdp", "ffn")),
            "b_in": ParamSpec((cfg.d_ff,), ("ffn",), init="zeros"),
            "w_out": ParamSpec((cfg.d_ff, cfg.d_model), ("ffn", "fsdp")),
            "b_out": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        }

    def enc_layer_specs(self) -> Dict[str, Any]:
        return {"ln1": rms_norm_spec(self.cfg.d_model),
                "attn": attn.attn_param_specs(self.cfg),
                "ln2": rms_norm_spec(self.cfg.d_model),
                "ffn": self._ffn_specs()}

    def dec_layer_specs(self) -> Dict[str, Any]:
        return {"ln1": rms_norm_spec(self.cfg.d_model),
                "self_attn": attn.attn_param_specs(self.cfg),
                "ln_x": rms_norm_spec(self.cfg.d_model),
                "cross_attn": attn.attn_param_specs(self.cfg),
                "ln2": rms_norm_spec(self.cfg.d_model),
                "ffn": self._ffn_specs()}

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": self._embed_spec(),
            "encoder": stack_specs(self.enc_layer_specs(), cfg.encoder_layers),
            "ln_enc": rms_norm_spec(cfg.d_model),
            "decoder": stack_specs(self.dec_layer_specs(), cfg.num_layers),
            "ln_f": rms_norm_spec(cfg.d_model),
            "head": self._head_spec(),
        }

    # ----------------------------------------------------------------- blocks
    def _ffn(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, p["ln2"], self.cfg.norm_eps)
        f = p["ffn"]
        return x + dense(F.relu(dense(h, f["w_in"], f["b_in"])), f["w_out"], f["b_out"])

    def _enc_layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor
                   ) -> torch.Tensor:
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        x = x + attn.attention(p["attn"], self.cfg, h, positions, causal=False)
        return self._ffn(p, x)

    def _cross(self, p: Params, x: torch.Tensor, enc_out: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, p["ln_x"], self.cfg.norm_eps)
        return x + attn.attention(p["cross_attn"], self.cfg, h, positions,
                                  kv_source=enc_out, causal=False)

    def _dec_layer(self, p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        x = x + attn.attention(p["self_attn"], self.cfg, h, positions)
        return self._ffn(p, self._cross(p, x, enc_out, positions))

    # --------------------------------------------------------------- encoder
    def encode(self, params: Params, frontend_emb: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = frontend_emb.to(torch_dtype(cfg.dtype))
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for idx in range(cfg.encoder_layers):
            x = self._remat(self._enc_layer, _layer(params["encoder"], idx), x, positions)
        return rms_norm(x, params["ln_enc"], cfg.norm_eps)

    # ----------------------------------------------------------------- train
    def hidden(self, params: Params, tokens: torch.Tensor,
               frontend_emb: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        enc_out = self.encode(params, frontend_emb)
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for idx in range(cfg.num_layers):
            x = self._remat(self._dec_layer, _layer(params["decoder"], idx), x,
                            enc_out, positions)
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def forward(self, params: Params, tokens: torch.Tensor,
                frontend_emb: torch.Tensor) -> torch.Tensor:
        return self.hidden(params, tokens, frontend_emb) @ params["head"]

    def loss(self, params: Params, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self.hidden(params, batch["tokens"], batch["frontend_emb"])
        loss, ce = lm_loss_from_hidden(x, params["head"], batch["labels"], z_loss=1e-4)
        return loss, {"ce": ce}

    # --------------------------------------------------------------- serving
    def prefill(self, params: Params, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Encode + causal prefill of the decoder prompt; returns the
        last-token logits and the cache."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frontend_emb"])
        x = self._embed(params, batch["tokens"])
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        shape = (cfg.num_layers, b, s, cfg.num_kv_heads, cfg.resolved_head_dim)
        ks = torch.empty(shape, dtype=x.dtype, device=x.device)
        vs = torch.empty(shape, dtype=x.dtype, device=x.device)
        for idx in range(cfg.num_layers):
            p_l = _layer(params["decoder"], idx)
            h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
            h, (ks[idx], vs[idx]) = attn.attention_prefill(p_l["self_attn"], cfg, h,
                                                           positions)
            x = self._ffn(p_l, self._cross(p_l, x + h, enc_out, positions))
        x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
        return x @ params["head"], {"k": ks, "v": vs, "enc_out": enc_out, "pos": s}

    def decode_step(self, params: Params, cache: Mapping[str, Any],
                    batch: Mapping[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token per sequence; the K/V caches are written in place."""
        cfg = self.cfg
        pos = cache["pos"]
        enc_out = cache["enc_out"]
        x = self._embed(params, batch["token"])
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        for idx in range(cfg.num_layers):
            p_l = _layer(params["decoder"], idx)
            h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
            h, _ = attn.attention_decode(p_l["self_attn"], cfg, h, cache["k"][idx],
                                         cache["v"][idx], pos)
            x = self._ffn(p_l, self._cross(p_l, x + h, enc_out, positions))
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x @ params["head"], {"k": cache["k"], "v": cache["v"],
                                    "enc_out": enc_out, "pos": pos + 1}
