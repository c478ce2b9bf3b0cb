"""RWKV6 LM (family "ssm"): attention-free, O(1)-state decode.

The port of ``repro.models.rwkv_model.RWKVLM``, with its parameter tree
(``layers`` stacked on a leading (L, ...) axis).  It runs no kernel: the
WKV scan is plain PyTorch (:func:`~repro_torch.models.rwkv.wkv_chunked`),
as the reference's is plain ``jnp``.  The decode cache is {"state": (L, b,
h, hd, hd) fp32, "tm_prev", "cm_prev": (L, b, 1, d), "pos": int}.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from repro_torch.models import rwkv
from repro_torch.models.layers import (lm_loss_from_hidden, rms_norm, rms_norm_spec,
                                       stack_specs)
from repro_torch.models.transformer import LMBase, Params, _layer


class RWKVLM(LMBase):
    def layer_specs(self) -> Dict[str, Any]:
        return {
            "ln1": rms_norm_spec(self.cfg.d_model),
            "time": rwkv.rwkv_time_specs(self.cfg),
            "ln2": rms_norm_spec(self.cfg.d_model),
            "channel": rwkv.rwkv_channel_specs(self.cfg),
        }

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": self._embed_spec(),
            "ln_in": rms_norm_spec(cfg.d_model),
            "layers": stack_specs(self.layer_specs(), cfg.num_layers),
            "ln_f": rms_norm_spec(cfg.d_model),
            "head": self._head_spec(),
        }

    def _zeros(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The zero token-shift carry and the zero WKV state of a batch."""
        heads, hd = rwkv._dims(self.cfg)
        b = x.shape[0]
        return (torch.zeros((b, 1, self.cfg.d_model), dtype=x.dtype, device=x.device),
                torch.zeros((b, heads, hd, hd), dtype=torch.float32, device=x.device))

    def _layer_fwd(self, p_l: Params, x: torch.Tensor, prev: torch.Tensor,
                   state0: torch.Tensor):
        """One layer from a zero carry: (x out, its decode cache)."""
        cfg = self.cfg
        h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
        y, tm_prev, state = rwkv.rwkv_time_mix(p_l["time"], cfg, h, prev, state0)
        x = x + y
        h = rms_norm(x, p_l["ln2"], cfg.norm_eps)
        y, cm_prev = rwkv.rwkv_channel_mix(p_l["channel"], cfg, h, prev)
        return x + y, {"state": state, "tm_prev": tm_prev, "cm_prev": cm_prev}

    def _layer_train(self, p_l: Params, x: torch.Tensor, prev: torch.Tensor,
                     state0: torch.Tensor) -> torch.Tensor:
        return self._layer_fwd(p_l, x, prev, state0)[0]

    def _embed_in(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return rms_norm(self._embed(params, tokens), params["ln_in"], self.cfg.norm_eps)

    # ----------------------------------------------------------------- train
    def hidden(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self._embed_in(params, tokens)
        prev, state0 = self._zeros(x)
        for idx in range(cfg.num_layers):
            x = self._remat(self._layer_train, _layer(params["layers"], idx), x,
                            prev, state0)
        return rms_norm(x, params["ln_f"], cfg.norm_eps)

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return self.hidden(params, tokens) @ params["head"]

    def loss(self, params: Params, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self.hidden(params, batch["tokens"])
        loss, ce = lm_loss_from_hidden(x, params["head"], batch["labels"], z_loss=1e-4)
        return loss, {"ce": ce}

    # --------------------------------------------------------------- serving
    def prefill(self, params: Params, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cfg = self.cfg
        x = self._embed_in(params, batch["tokens"])
        prev, state0 = self._zeros(x)
        caches = []
        for idx in range(cfg.num_layers):
            x, c = self._layer_fwd(_layer(params["layers"], idx), x, prev, state0)
            caches.append(c)
        x = rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
        cache = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
        cache["pos"] = batch["tokens"].shape[1]
        return x @ params["head"], cache

    def decode_step(self, params: Params, cache: Mapping[str, Any],
                    batch: Mapping[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cfg = self.cfg
        x = self._embed_in(params, batch["token"])
        new = {"state": [], "tm_prev": [], "cm_prev": []}
        for idx in range(cfg.num_layers):
            p_l = _layer(params["layers"], idx)
            h = rms_norm(x, p_l["ln1"], cfg.norm_eps)
            y, tm_new, st_new = rwkv.rwkv_time_decode(p_l["time"], cfg, h,
                                                      cache["tm_prev"][idx],
                                                      cache["state"][idx])
            x = x + y
            h = rms_norm(x, p_l["ln2"], cfg.norm_eps)
            y, cm_new = rwkv.rwkv_channel_decode(p_l["channel"], cfg, h,
                                                 cache["cm_prev"][idx])
            x = x + y
            for key, t in (("state", st_new), ("tm_prev", tm_new), ("cm_prev", cm_new)):
                new[key].append(t)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        out = {k: torch.stack(v) for k, v in new.items()}
        out["pos"] = cache["pos"] + 1
        return x @ params["head"], out
