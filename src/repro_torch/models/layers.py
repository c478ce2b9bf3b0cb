"""Parameter specs and the common layers, in PyTorch.

The port of ``repro.models.layers``: :class:`ParamSpec` trees (nested dicts
of specs, stacked on a leading layer axis by :func:`stack_specs`), their
``normal``/``zeros``/``embed`` initializers drawn from an explicit
``torch.Generator`` on the generator's device, the layers LeNet and the
decoder LMs use, and the LMs' chunked training loss.  Layouts follow the
reference package so parameters transfer 1:1.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import gather_dims, inner_dims, lc, whole_grad
from repro_torch.obs import region

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | fan_in | zeros | ones | embed
    scale: float = 1.0
    dtype: Optional[str] = None   # None -> model compute dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a shardable multiple (standard embedding-table padding)."""
    return ((v + multiple - 1) // multiple) * multiple


def _spec_leaves(specs: Any):
    if isinstance(specs, ParamSpec):
        yield specs
        return
    for v in specs.values():
        yield from _spec_leaves(v)


def _map_specs(fn, specs: Any) -> Any:
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def spec_param_count(specs: Any, active_expert_frac: float = 1.0) -> int:
    """Analytic number of parameters of a (nested) spec dict; tensors with an
    ``experts`` axis are scaled by the active fraction."""
    total = 0
    for s in _spec_leaves(specs):
        n = int(np.prod(s.shape))
        if "experts" in s.axes:
            n = int(n * active_expert_frac)
        total += n
    return total


def axes_tree(specs: Any) -> Any:
    """The logical axes of every spec, in the specs' tree."""
    return _map_specs(lambda s: s.axes, specs)


def stack_specs(specs: Any, n: int) -> Any:
    """Add a leading stacked-layer dimension to every spec."""
    return _map_specs(lambda s: dataclasses.replace(
        s, shape=(n,) + s.shape, axes=("layers",) + s.axes), specs)


#: bytes of one leaf's fp32 draw above which :func:`init_params` draws it
#: slice by slice along its leading dim (16 GiB: every dense config and
#: every smoke config draws each leaf whole)
SLICED_DRAW_BYTES = 16 << 30


def _init_one(spec: ParamSpec, generator: torch.Generator,
              default_dtype: str) -> torch.Tensor:
    dtype = torch_dtype(spec.dtype or default_dtype)
    device = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "embed":
        std = spec.scale
    elif spec.init in ("normal", "fan_in"):
        # the reference's fan-in rule: leading dim for rank >= 2 (for a
        # stacked spec that is the layer count, as in the reference);
        # "fan_in" takes every dim but the last
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        if spec.init == "fan_in" and len(spec.shape) >= 2:
            fan_in = int(np.prod(spec.shape[:-1]))
        std = spec.scale / np.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    if 4 * int(np.prod(spec.shape)) <= SLICED_DRAW_BYTES:
        draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                           device=device)
        return draw.mul_(std).to(dtype)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for row in out:
        row.copy_(torch.randn(row.shape, generator=generator, dtype=torch.float32,
                              device=device).mul_(std))
    return out


def init_params(specs: Any, generator: torch.Generator,
                dtype: str = "float32",
                keep: Optional[Callable[[torch.Tensor, ParamSpec], Any]] = None) -> Any:
    """Materialize a (nested) spec dict in the specs' order, on the
    generator's device.

    Each tensor is drawn in fp32 and cast to its dtype before the next one
    is drawn.  A tensor whose fp32 draw would pass ``SLICED_DRAW_BYTES`` is
    made in its dtype and drawn one slice of its leading dim at a time, so
    the transient is the fp32 draw of one tensor or, for such a tensor, of
    one slice: llama3-8b (8.03 B parameters) is made on the card in bf16
    without a 32 GB fp32 copy on the host, and a qwen3-moe-30b-a3b expert
    stack (48 x 128 x 2048 x 768) with a 0.81 GB transient, not 38.65 GB.
    ``jax.random`` and ``torch.Generator`` draw different numbers from the
    same seed: to give both packages identical weights, make them with
    numpy and load them with :func:`~repro_torch.models.transformer.params_from_jax`.

    ``keep(tensor, spec)``, where given, makes what the tree holds of each
    tensor (a rank's shard of it) as soon as it is drawn, so the whole
    tensor is freed before the next one is drawn.
    """
    keep = keep or (lambda t, spec: t)
    return _map_specs(lambda s: keep(_init_one(s, generator, dtype), s), specs)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with fp32 statistics and the reference's ``(1 + gamma)`` scale."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * (1.0 + gamma.float()).to(x.dtype)


def rms_norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="zeros")   # gamma stored as (1+g)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    # on a mesh: the product folds (b, s) of x and, in its backward, of y's
    # gradient, so both are gathered along s first (see gather_dims)
    y = whole_grad(gather_dims(x, inner_dims(x)) @ w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """The dense MLP (the region ``ffn``)."""
    with region("ffn"):
        return dense(F.silu(dense(x, w_gate)) * dense(x, w_up), w_down)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs                 # (..., seq, hd/2)
    cos = angles.cos()[..., None, :]                              # (..., seq, 1, hd/2)
    sin = angles.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0,
                          z_loss: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE with optional z-loss. Returns (loss, z_loss) per row."""
    from repro_torch.distributed.sharding import vocab_parallel_ce
    split = vocab_parallel_ce(logits, labels, label_smoothing, z_loss)
    if split is not None:
        return split
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # gather-free true-logit extraction, as the reference does it
    v_iota = torch.arange(logits.shape[-1], device=logits.device)
    true_logit = torch.where(v_iota == labels[..., None], logits,
                             torch.zeros((), device=logits.device)).sum(-1)
    ce = lse - true_logit
    if label_smoothing:
        ce = (1.0 - label_smoothing) * ce + label_smoothing * (
            lse - logits.mean(-1))
    zl = z_loss * lse.square() if z_loss else torch.zeros_like(lse)
    return ce, zl


def _chunk_loss(xb: torch.Tensor, head_w: torch.Tensor, lb: torch.Tensor,
                mb: torch.Tensor, z_loss: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk's masked (loss, ce, token) sums."""
    # constrain the head at its use site, so its gradient stays sharded too
    logits = dense(xb, lc(head_w, ("fsdp", "vocab")))
    ce, zl = softmax_cross_entropy(logits, lb, z_loss=z_loss)
    return torch.sum((ce + zl) * mb), torch.sum(ce * mb), torch.sum(mb)


def lm_loss_from_hidden(x: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                        *, z_loss: float = 0.0, chunk: int = 512,
                        mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-chunked LM loss: never materializes full (b, s, V) logits.

    The reference's scan over chunks becomes a loop; each chunk's logits are
    recomputed in the backward pass (``torch.utils.checkpoint`` on the chunk,
    the reference's ``jax.checkpoint``), bounding loss memory at
    O(b * chunk * V).  The chunk is the largest divisor of s that is at most
    ``chunk``.  Returns (loss_mean, ce_mean) over the mask's tokens.  The
    forward is the region ``loss``.
    """
    with region("loss"):
        b, s, _ = x.shape
        c = next(cc for cc in range(min(chunk, s), 0, -1) if s % cc == 0)
        if mask is None:
            mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        tot, ce_tot, cnt = zero, zero, zero
        for i in range(0, s, c):
            args = (x[:, i:i + c], head_w, labels[:, i:i + c], mask[:, i:i + c], z_loss)
            if torch.is_grad_enabled():
                t, ct, n = checkpoint(_chunk_loss, *args, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                t, ct, n = _chunk_loss(*args)
            tot, ce_tot, cnt = tot + t, ce_tot + ct, cnt + n
        denom = torch.clamp(cnt, min=1.0)
        return tot / denom, ce_tot / denom
