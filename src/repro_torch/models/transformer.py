"""Decoder-only transformer LM, families ``dense`` (llama3-8b, qwen1.5-4b,
gemma3-12b/27b), ``moe`` (qwen3-moe-30b-a3b, dbrx-132b) and ``vlm``
(internvl2-2b).

The port of ``repro.models.transformer.DecoderLM``.  It keeps the
reference's parameter tree — ``embed``, ``layers`` stacked on a leading
(L, ...) axis, ``ln_f``, ``head`` — so weights transfer 1:1
(:func:`params_from_jax`, and a whole training state with
:func:`state_from_jax`), and loops over the layers in Python where the
reference runs ``lax.scan``.  Under autograd each layer is recomputed in the
backward pass as the sharding config's ``remat_policy`` says (the
reference's ``jax.checkpoint`` on the scan body).  The KV cache is ``{"k",
"v": (L, b, S, kv, hd), "pos": int}``; prefill fills it layer by layer and
decode updates it in place.

``moe`` replaces the FFN with :func:`~repro_torch.models.moe.moe_ffn` (its
aux loss joins the training loss at 1e-2), at capacity factor
``moe_capacity`` (1.25) in training and prefill and without drops in
decode, as the reference does.  ``vlm`` prepends the (b, frontend_seq, d)
``frontend_emb`` rows (a stub for the vision encoder's output) to the text
embeddings, and its loss covers the text positions only.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig, ShapeConfig, ShardingConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamSpec, init_params, lm_loss_from_hidden,
                                       pad_vocab, rms_norm, rms_norm_spec,
                                       stack_specs, swiglu, torch_dtype)
from repro_torch.optim import TrainState

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
    """The reference package's LM parameters (a tree of numpy arrays) as the
    port's: the same tree of CPU tensors, for every LM family (the hybrid's
    ``shared``/``groups``/``tail`` and the encoder-decoder's
    ``encoder``/``decoder`` included).

    With ``cfg`` every name, shape and dtype is checked against the specs of
    ``build_model(cfg)``.
    """
    def conv(tree):
        if isinstance(tree, Mapping):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor(tree)

    out = conv(params)
    if cfg is not None:
        _check_tree(out, _specs(cfg), torch_dtype(cfg.dtype), "")
    return out


def _specs(cfg: ModelConfig) -> Dict[str, Any]:
    from repro_torch.models import build_model
    return build_model(cfg).param_specs()


def state_from_jax(state: Any, cfg: Optional[ModelConfig] = None) -> TrainState:
    """The reference package's ``TrainState`` (step, params, master, m, v as
    numpy arrays) as the port's: the same trees of CPU tensors, the step a
    0-d int32 tensor.  With ``cfg`` every tree is checked against the
    model's specs (params in the model's dtype, the rest fp32)."""
    step, params, master, m, v = state
    out = TrainState(torch.tensor(int(np.asarray(step)), dtype=torch.int32),
                     params_from_jax(params, cfg),
                     *(params_from_jax(t) for t in (master, m, v)))
    if cfg is not None:
        specs = _specs(cfg)
        for name, tree in zip(("master", "m", "v"), out[2:]):
            _check_tree(tree, specs, torch.float32, name)
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
    """Layer ``idx`` of a stacked (L, ...) parameter tree (views, no copies),
    or of a list of per-layer trees (the train step's gradient leaves)."""
    if isinstance(tree, list):
        return tree[idx]
    if isinstance(tree, Mapping):
        return {k: _layer(v, idx) for k, v in tree.items()}
    return tree[idx]


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" remat policy: keep the products without batch dims (the
    reference's ``checkpoint_dots_with_no_batch_dims``), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class LMBase:
    """What every LM family shares: the config, the remat policy, the
    embedding and head specs, init, the abstract tree, the token embedding
    and the train batch's specs."""

    def __init__(self, cfg: ModelConfig, sharding: Optional[ShardingConfig] = None):
        self.cfg = cfg
        self.sharding = sharding or ShardingConfig()
        if self.sharding.remat_policy not in ("none", "full", "dots"):
            raise ValueError(f"unknown remat_policy {self.sharding.remat_policy!r}")

    def _embed_spec(self) -> ParamSpec:
        return ParamSpec((pad_vocab(self.cfg.vocab_size), self.cfg.d_model),
                         (None, "embed_tbl"), init="embed", scale=0.02)

    def _head_spec(self) -> ParamSpec:
        return ParamSpec((self.cfg.d_model, pad_vocab(self.cfg.vocab_size)),
                         ("fsdp", "vocab"))

    def init(self, seed: int = 0,
             device: Optional[Union[str, torch.device]] = None) -> Params:
        """Random weights from ``seed``, drawn on ``device`` (default cuda)."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return init_params(self.param_specs(), gen, self.cfg.dtype)

    def abstract(self) -> Params:
        """The parameter tree as ``meta`` tensors: shapes and dtypes, no
        storage (the reference's ``ShapeDtypeStruct`` tree)."""
        def meta(spec):
            if isinstance(spec, ParamSpec):
                return torch.empty(spec.shape, device="meta",
                                   dtype=torch_dtype(spec.dtype or self.cfg.dtype))
            return {k: meta(v) for k, v in spec.items()}
        return meta(self.param_specs())

    def _embed(self, params: Params, tokens: torch.Tensor,
               frontend_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = params["embed"][tokens].to(torch_dtype(self.cfg.dtype))
        if frontend_emb is not None:
            x = torch.cat([frontend_emb.to(x.dtype), x], dim=1)
        return x

    def _remat(self, fn, *args):
        """``fn(*args)`` (one layer, or one unit of layers) under the remat
        policy: "full" keeps only its inputs and recomputes the rest in the
        backward pass, "dots" also keeps the products' outputs, "none" keeps
        everything.  Without autograd it just runs."""
        policy = self.sharding.remat_policy
        if policy == "none" or not torch.is_grad_enabled():
            return fn(*args)
        kw = {}
        if policy == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_dots)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    def text_len(self, shape: ShapeConfig) -> int:
        if self.cfg.frontend != "none":
            return max(shape.seq_len - self.cfg.frontend_seq, 1)
        return shape.seq_len

    def train_input_specs(self, shape: ShapeConfig
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple[str, ...]]]:
        """The train batch as ``meta`` tensors (with the frontend rows where
        the config has a frontend), and its logical axes."""
        cfg = self.cfg
        b = shape.global_batch
        tok = torch.empty((b, self.text_len(shape)), dtype=torch.int32, device="meta")
        specs = {"tokens": tok, "labels": tok.clone()}
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if cfg.frontend != "none":
            specs["frontend_emb"] = torch.empty((b, cfg.frontend_seq, cfg.d_model),
                                                dtype=torch_dtype(cfg.dtype), device="meta")
            axes["frontend_emb"] = ("batch", "frontend_seq", "embed")
        return specs, axes

    def prefill_input_specs(self, shape: ShapeConfig
                            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple[str, ...]]]:
        specs, axes = self.train_input_specs(shape)
        specs.pop("labels"), axes.pop("labels")
        return specs, axes


class DecoderLM(LMBase):
    """The decoder-only LM (dense, moe, vlm): specs, init, forward, loss,
    prefill and decode."""

    def __init__(self, cfg: ModelConfig, sharding: Optional[ShardingConfig] = None):
        super().__init__(cfg, sharding)
        self.moe_capacity = moe_mod.CAPACITY_FACTOR   # train/prefill (<= 0: no-drop)

    # ------------------------------------------------------------------ specs
    def layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        specs: Dict[str, Any] = {
            "ln1": rms_norm_spec(cfg.d_model),
            "attn": attn.attn_param_specs(cfg),
            "ln2": rms_norm_spec(cfg.d_model),
        }
        if cfg.family == "moe":
            specs["moe"] = moe_mod.moe_param_specs(cfg)
        else:
            specs["ffn"] = {
                "w_gate": ParamSpec((cfg.d_model, cfg.d_ff), ("fsdp", "ffn")),
                "w_up": ParamSpec((cfg.d_model, cfg.d_ff), ("fsdp", "ffn")),
                "w_down": ParamSpec((cfg.d_ff, cfg.d_model), ("ffn", "fsdp")),
            }
        return specs

    def param_specs(self) -> Dict[str, Any]:
        return {
            "embed": self._embed_spec(),
            "layers": stack_specs(self.layer_specs(), self.cfg.num_layers),
            "ln_f": rms_norm_spec(self.cfg.d_model),
            "head": self._head_spec(),
        }

    # ---------------------------------------------------------------- layers
    def _window_for(self, idx: int) -> int:
        cfg = self.cfg
        if cfg.global_every <= 0:
            return cfg.window_size
        return 0 if (idx + 1) % cfg.global_every == 0 else cfg.window_size

    def _ffn(self, p_l: Params, x: torch.Tensor, capacity: float
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x plus the layer's FFN (MoE at ``capacity``) of its norm, and the
        MoE aux loss (None for an FFN)."""
        h = rms_norm(x, p_l["ln2"], self.cfg.norm_eps)
        if self.cfg.family == "moe":
            h, aux = moe_mod.moe_ffn(p_l["moe"], self.cfg, h, capacity_factor=capacity)
            return x + h, aux
        f = p_l["ffn"]
        return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"]), None

    def _block(self, p_l: Params, x: torch.Tensor, positions: torch.Tensor,
               window: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = rms_norm(x, p_l["ln1"], self.cfg.norm_eps)
        x = x + attn.attention(p_l["attn"], self.cfg, h, positions, window=window)
        return self._ffn(p_l, x, self.moe_capacity)

    # ---------------------------------------------------------------- train
    def hidden(self, params: Params, tokens: torch.Tensor,
               frontend_emb: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Causal forward -> (final-norm hidden (b, s_total, d), MoE aux)."""
        cfg = self.cfg
        x = self._embed(params, tokens, frontend_emb)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        aux = None
        for idx in range(cfg.num_layers):
            x, a = self._remat(self._block, _layer(params["layers"], idx), x,
                               positions, self._window_for(idx))
            if a is not None:
                aux = a if aux is None else aux + a
        if aux is None:
            aux = torch.zeros((), device=x.device)
        return rms_norm(x, params["ln_f"], cfg.norm_eps), aux

    def loss(self, params: Params, batch: Mapping[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean loss, {"ce", "aux_loss"}) of a {tokens, labels[,
        frontend_emb][, loss_mask]} batch: the chunked LM loss with the
        reference's z-loss of 1e-4, over the text positions, plus 1e-2 of the
        MoE aux loss."""
        cfg = self.cfg
        x, aux = self.hidden(params, batch["tokens"], batch.get("frontend_emb"))
        if cfg.frontend != "none":          # loss only on text positions
            x = x[:, cfg.frontend_seq:]
        loss, ce = lm_loss_from_hidden(x, params["head"], batch["labels"],
                                       z_loss=1e-4, mask=batch.get("loss_mask"))
        if cfg.family == "moe":
            loss = loss + 1e-2 * aux
        return loss, {"ce": ce, "aux_loss": aux}

    def forward(self, params: Params, tokens: torch.Tensor,
                frontend_emb: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full logits and the MoE aux loss (zero for a model without MoE)."""
        x, aux = self.hidden(params, tokens, frontend_emb)
        return x @ params["head"], aux

    # -------------------------------------------------------------- prefill
    def prefill(self, params: Params, batch: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Returns (last-token logits, cache). Cache K/V: (L, b, S, kv, hd)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], batch.get("frontend_emb"))
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
            x, _ = self._ffn(p_l, x + h, self.moe_capacity)
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
            x, _ = self._ffn(p_l, x + h, 0.0)
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x @ params["head"], {"k": cache["k"], "v": cache["v"],
                                    "pos": pos + 1}
