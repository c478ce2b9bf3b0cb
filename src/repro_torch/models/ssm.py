"""Mamba2 (SSD) mixer: chunked-parallel training path + recurrent decode.

The port of ``repro.models.ssm``, with its parameter names and layouts.
The state-space-dual algorithm runs over sequence chunks, the state carried
across chunks in fp32.  On the card a prefill's mixer is, beside its two
products, three launches a layer of hand-written kernels: ``ssm_conv_in``
(``kernels/ssm_mixer``, ``csrc/ssm_mixer.cu``: the causal conv, SiLU, dt
and dt A from the in_proj output read in place, written as the scan reads
them), the scan (``kernels/ssd_scan``, ``csrc/ssd_scan.cu``) and
``ssm_gated_norm`` (the skip, the gate and the grouped RMS norm).  Each is
taken where its route names it from what the inputs show
(``ssm_mixer.ops.mixer_route``: 16-bit CUDA tensors off a mesh at the
compiled shapes with no gradient needed; ``ssd_scan.ops.scan_route``);
elsewhere (the CPU, fp32, ``meta`` tensors, training, a mesh) the plain
version: PyTorch steps before and after the scan, and a Python loop over
the chunks whose work within a chunk is products (``torch.einsum``).
Decode is the O(1)-state recurrence, in PyTorch.

Shapes: d_inner = expand*d_model, heads = d_inner/64 (headdim p=64), state
n = cfg.ssm_state, and ``groups`` groups of B and C (1, the reference's
layout, unless a caller passes more): heads split evenly over the groups,
head i reading group i // (heads / groups), and the gated RMS norm taken
over each group's d_inner / groups channels.  With ``chunk`` 0 the scan
runs in the reference's chunks (:data:`CHUNK`, shrunk to divide the
sequence); with a chunk length (the published Zamba2's) in chunks of that
length and a shorter last one, which is what padding the sequence with
zeros to a whole chunk gives (a padded step neither decays nor feeds the
state).

The scan (and the decode recurrence) is the region ``ssm.scan``, nested in
``ssm.mixer``, which covers the rest of the mixer
(:func:`repro_torch.obs.region`); each scan counts its chunks on
``ssm_scan_chunks_total``, and those the kernel covered also on
``ssm_scan_kernel_chunks_total``; each prefill mixer counts one on
``ssm_mixer_layers_total``, and on ``ssm_mixer_kernel_layers_total`` where
it took the two mixer kernels (:func:`repro_torch.obs.regions.count`).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import gather_dims, lc, on_shards, whole_grad
from repro_torch.kernels.ssd_scan.ops import scan_route, ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.ssm_mixer.ops import (mixer_route, scan_inputs, ssm_conv_in_op,
                                               ssm_gated_norm_op)
from repro_torch.models.layers import ParamSpec, causal_conv, dense, gated_norm
from repro_torch.obs import region
from repro_torch.obs.regions import count

HEADDIM = 64
CHUNK = 128


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = max(d_inner // HEADDIM, 1)
    headdim = d_inner // heads
    return d_inner, heads, headdim, cfg.ssm_state


def conv_channels(cfg: ModelConfig, groups: int = 1) -> int:
    """The causal conv's channels: x, then every group's B, then C."""
    d_inner, _, _, n = _dims(cfg)
    return d_inner + 2 * groups * n


def ssm_param_specs(cfg: ModelConfig, groups: int = 1) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_inner, heads, headdim, n = _dims(cfg)
    conv_ch = conv_channels(cfg, groups)
    return {
        "in_proj": ParamSpec((d, d_inner + conv_ch + heads), ("fsdp", "ffn")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_ch), (None, "ffn"), init="fan_in"),
        "conv_b": ParamSpec((conv_ch,), ("ffn",), init="zeros"),
        "dt_bias": ParamSpec((heads,), ("ssm_heads",), init="zeros"),
        "a_log": ParamSpec((heads,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamSpec((heads,), ("ssm_heads",), init="ones"),
        "norm": ParamSpec((d_inner,), ("ffn",), init="zeros"),
        "out_proj": ParamSpec((d_inner, d), ("ffn", "fsdp")),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor, groups: int):
    d_inner, heads, headdim, n = _dims(cfg)
    gn = groups * n
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn, heads], dim=-1)


def _by_group(t: torch.Tensor, groups: int) -> torch.Tensor:
    """B or C (..., groups * n) as (..., groups, n)."""
    return t.reshape(*t.shape[:-1], groups, t.shape[-1] // groups)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. x: (b, s, c); w: (width, c).  On a mesh each
    rank convolves its own rows whole (DTensor's convolution rule keeps the
    groups count of the whole channel dim where it shards the weight's)."""
    return on_shards(causal_conv, (x, w, b), (("batch",), (None,), (None,)),
                     (("batch",),))


def ssd_chunked(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                state0: torch.Tensor, chunk: int = CHUNK, ragged: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xdt:   (b, s, h, p)  — inputs pre-multiplied by dt
    dA:    (b, s, h)     — per-step log decay (dt * A, A<0)
    B, C:  (b, s, g, n)  — g groups, head i reading group i // (h / g);
           or (b, s, n), one group shared across heads
    state0:(b, h, p, n)
    Returns y: (b, s, h, p), final state (fp32).

    Without ``ragged`` the chunks are the reference's: ``chunk`` shrunk to
    divide s (one chunk below it); with it, chunks of ``chunk`` and a
    shorter last one.  Where :func:`scan_route` names the kernel (on the
    card, a 16-bit prefill) the scan is one launch of it; otherwise the
    plain loop over the chunks (:func:`ssd_scan_ref`).  Either is the region
    ``ssm.scan`` and counts its chunks on ``ssm_scan_chunks_total``; the
    kernel's also on ``ssm_scan_kernel_chunks_total``.
    """
    b, s, h, p = xdt.shape
    if not ragged:
        nc = max(s // chunk, 1)
        chunk = s // nc
        if nc * chunk != s:
            raise ValueError(f"ssd_chunked: s={s} is not {nc} chunks of {chunk}")
    if B.dim() == 3:
        B, C = B[:, :, None], C[:, :, None]
    chunks = -(-s // chunk)
    with region("ssm.scan"):
        if scan_route(xdt, dA, B, C, state0, chunk) == "kernel":
            y, state = ssd_scan_op(xdt, dA, B, C, state0, chunk)
            count("ssm_scan_kernel_chunks_total", chunks)
        else:
            y, state = ssd_scan_ref(xdt, dA, B, C, state0, chunk)
        count("ssm_scan_chunks_total", chunks)
        return y, state


def _heads(t: torch.Tensor, heads: int, headdim: int) -> torch.Tensor:
    """(..., heads * headdim) -> (..., heads, headdim).  On a mesh the
    channels are gathered first where the heads do not divide over the
    ranks that split them (DTensor cannot unflatten an uneven split)."""
    return gather_dims(t, (-1,), unit=heads).reshape(*t.shape[:-1], heads, headdim)


def _merge_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., heads, headdim) -> (..., heads * headdim), the inverse of
    :func:`_heads`: the head dim gathered first, and the merged gradient's
    channels gathered where the heads do not divide over its ranks."""
    merged = gather_dims(t, (-1,), unit=1).reshape(*t.shape[:-2], -1)
    return whole_grad(merged, (-1,), unit=heads)


def _mixer_inputs(params: Dict, cfg: ModelConfig, zxbcdt: torch.Tensor, groups: int):
    """The plain causal conv and dt from the in_proj output: (z, xh (b, s,
    h, p), xdt, dA, B, C (b, s, groups, n), the conv's raw input (b, s, c))."""
    d_inner, heads, headdim, n = _dims(cfg)
    gn = groups * n
    z, xs, B, C, dt = _split_proj(cfg, zxbcdt, groups)
    xbc_raw = torch.cat([xs, B, C], dim=-1)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs, B, C = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())       # (b, s, h)
    A = -torch.exp(params["a_log"].float())                       # (h,)
    xh = lc(_heads(xs, heads, headdim), ("batch", None, "ssm_heads", None))
    xdt = (xh.float() * dt[..., None]).to(xh.dtype)
    dA = lc(dt * A, ("batch", None, "ssm_heads"))                # (b, s, h)
    return z, xh, xdt, dA, _by_group(B, groups), _by_group(C, groups), xbc_raw


def _mixer_gate(params: Dict, cfg: ModelConfig, y: torch.Tensor, xh: torch.Tensor,
                z: torch.Tensor, groups: int) -> torch.Tensor:
    """The plain skip, gate and grouped norm of the scan's y (b, s, h, p):
    out_proj's input (b, s, h p)."""
    heads = y.shape[2]
    y = y + xh * params["d_skip"].to(y.dtype)[None, None, :, None]
    return gated_norm(_merge_heads(y, heads), z, params["norm"], groups, cfg.norm_eps)


_MIXER_PARAMS = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm")


def ssm_mixer(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Training/prefill path. x: (b, s, d) -> (b, s, d)."""
    return ssm_prefill(params, cfg, x)[0]


def ssm_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor, groups: int = 1,
                chunk: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`ssm_mixer` and the decode cache it leaves: {state (b, h, p, n)
    fp32, conv: the last ``ssm_conv - 1`` raw conv inputs}.  ``groups`` and
    ``chunk`` as the module's docstring has them."""
    d_inner, heads, headdim, n = _dims(cfg)
    with region("ssm.mixer"):
        zxbcdt = dense(x, params["in_proj"])
        kernels = mixer_route(zxbcdt, *(params[k] for k in _MIXER_PARAMS), groups) == "kernels"
        if kernels:
            xbc, dA, xh, conv = ssm_conv_in_op(zxbcdt, params["conv_w"], params["conv_b"],
                                               params["dt_bias"], params["a_log"], d_inner)
            xdt, dA, B, C = scan_inputs(xbc, dA, d_inner, groups)
        else:
            z, xh, xdt, dA, B, C, xbc_raw = _mixer_inputs(params, cfg, zxbcdt, groups)
            # a copy: a view would hold the whole (b, s, c) conv input alive
            conv = xbc_raw[:, -(cfg.ssm_conv - 1):, :].clone()
        state0 = torch.zeros((x.shape[0], heads, headdim, n), dtype=torch.float32,
                             device=x.device)
        # on a mesh each rank scans its own rows and heads (the scan's products
        # fold (b, heads), which DTensor cannot do with both split)
        hx, sx = ("batch", None, "ssm_heads", None), ("batch", "ssm_heads", None, None)
        rows = ("batch", None, None, None)
        scan = functools.partial(ssd_chunked, chunk=chunk or CHUNK, ragged=bool(chunk))
        y, state = on_shards(scan, (xdt, dA, B, C, state0),
                             (hx, ("batch", None, "ssm_heads"), rows, rows, sx), (hx, sx))
        y = lc(y, ("batch", None, "ssm_heads", None))
        if kernels:
            gated = ssm_gated_norm_op(y, xh, zxbcdt, params["d_skip"], params["norm"], groups,
                                      cfg.norm_eps)
        else:
            gated = _mixer_gate(params, cfg, y, xh, z, groups)
        out = dense(gated, params["out_proj"])
    count("ssm_mixer_layers_total", 1)
    if kernels:
        count("ssm_mixer_kernel_layers_total", 1)
    return out, {"state": state, "conv": conv}


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) per token)
# ---------------------------------------------------------------------------

def ssm_cache_shape(cfg: ModelConfig, batch: int, groups: int = 1
                    ) -> Dict[str, Tuple[int, ...]]:
    d_inner, heads, headdim, n = _dims(cfg)
    return {
        "state": (batch, heads, headdim, n),
        "conv": (batch, cfg.ssm_conv - 1, conv_channels(cfg, groups)),
    }


def _ssd_step(B1: torch.Tensor, C1: torch.Tensor, xh: torch.Tensor, dt1: torch.Tensor,
              dA: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's state update and read, per (batch row, head); B1 and C1
    (b, g, n) by group."""
    r = xh.shape[1] // B1.shape[1]
    B1, C1 = B1.repeat_interleave(r, dim=1), C1.repeat_interleave(r, dim=1)
    state = state * dA[..., None, None] + torch.einsum("bhn,bhp->bhpn", B1, xh * dt1[..., None])
    return torch.einsum("bhn,bhpn->bhp", C1, state), state


def ssm_decode_step(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor], groups: int = 1
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (b, 1, d); cache: {state: (b,h,p,n) fp32, conv: (b,w-1,c)}."""
    d_inner, heads, headdim, n = _dims(cfg)
    gn = groups * n
    with region("ssm.mixer"):
        zxbcdt = dense(x, params["in_proj"])
        z, xs, B, C, dt = _split_proj(cfg, zxbcdt, groups)
        xbc_new = torch.cat([xs, B, C], dim=-1)                          # (b, 1, c)
        window = torch.cat([cache["conv"], xbc_new], dim=1)              # (b, w, c)
        conv_out = torch.sum(window * params["conv_w"].to(window.dtype)[None], dim=1)
        xbc = F.silu(conv_out + params["conv_b"].to(conv_out.dtype))
        xs1, B1, C1 = torch.split(xbc, [d_inner, gn, gn], dim=-1)        # (b, c)
        B1, C1 = _by_group(B1, groups), _by_group(C1, groups)
        dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"].float())  # (b, h)
        A = -torch.exp(params["a_log"].float())
        xh = _heads(xs1, heads, headdim).float()
        dA = torch.exp(dt1 * A)                                          # (b, h)
        hx, rows = ("batch", "ssm_heads", None), ("batch", None, None)
        with region("ssm.scan"):
            y, state = on_shards(_ssd_step, (B1.float(), C1.float(), xh, dt1, dA,
                                             cache["state"]),
                                 (rows, rows, hx, ("batch", "ssm_heads"), ("batch", "ssm_heads"),
                                  ("batch", "ssm_heads", None, None)),
                                 (hx, ("batch", "ssm_heads", None, None)))
        y = y + xh * params["d_skip"].float()[None, :, None]
        y = _merge_heads(y, heads).unsqueeze(1).to(x.dtype)
        out = dense(gated_norm(y, z, params["norm"], groups, cfg.norm_eps), params["out_proj"])
    return out, {"state": state, "conv": window[:, 1:]}
