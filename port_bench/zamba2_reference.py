"""The plain reference of the published Zamba2 (``Zamba2ForCausalLM``), in
fp32, for the serving comparison.

Plain PyTorch written from the equations of ``transformers``'
``modeling_zamba2.py`` and the configuration's file, importing nothing of
the program (the helpers it shares with :mod:`reference` are plain fp32 too:
``rms_norm``, ``rope``, ``Precision``, TF32 off).  Over the whole sequence:

* the embedding rows x, and e = x kept for every shared block;
* layer i, with ``extra`` = 0 or, at the j-th of ``hybrid_layer_ids``, the
  output of shared block j % ``num_mem_blocks`` on [x, e]: RMS norm of the
  concatenation, q, k, v of heads of ``attention_head_dim`` with RoPE over
  the whole head (theta ``rope_theta``), causal softmax attention with the
  scores scaled by (head_dim / 2) ** -0.5, the o projection, an RMS norm, a
  GELU-gated MLP whose ``gate_up`` product has point j's adapter (rank
  ``adapter_rank``) added, and point j's d x d linear;
* then the Mamba2 layer: x + mixer(rms_norm(x + extra)), where the mixer
  projects to z, x B C and dt, runs the depthwise causal conv (width
  ``mamba_d_conv``, with its bias) and SiLU over x B C, takes dt =
  softplus(dt + dt_bias) and A = -exp(A_log), and scans: y_t = sum over
  j <= t of (C_t . B_j) exp(sum_{k=j+1..t} dt_k A) dt_j x_j, plus D x_t, per
  head, head h reading group h // (heads / ``mamba_ngroups``) of B and C.
  The scan is formed whole, in its quadratic form over the sequence (the
  segment sums by a masked cumulative sum, ``Mamba2``'s own
  ``segment_sum``), a few heads at a time: no chunks, so that the
  program's chunking and its ragged last chunk are held to a formulation
  that has neither.  Then the gated RMS norm of y * silu(z), taken over each
  group's channels (eps 1e-5, as ``Zamba2MambaMixer`` sets it), and the out
  projection;
* the final RMS norm and the head, the embedding's transpose, over the
  published vocabulary.

Departures from ``modeling_zamba2.py``, each a choice of its plain path
and not of the model:

* dt is not clamped: ``time_step_limit`` is null, which the fused path
  (``mamba_chunk_scan_combined``) takes as no limit; the plain path
  (``torch_forward``) clamps dt at ``time_step_min``, which the reference
  does not copy;
* the scan is formed in its quadratic form, where ``torch_forward`` chunks
  it (the same sums);
* a norm's weight is read as ``1 + gamma`` (the benchmark's weights store
  gamma: :mod:`zamba2_weights`).

Weights come from :mod:`zamba2_weights`, drawn again from the seed layer by
layer and widened to fp32.  ``lowp`` is the control, as in
:mod:`reference`: ``"fp8"`` rounds every product's operands and every kept
activation to float8 e4m3, ``"fp8_products"`` the products' operands alone;
attention's and the scan's inner arithmetic stays fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

import reference as R
import zamba2_weights as ZW

#: Mamba2 heads whose (T, T) decays the scan forms at once
HEADS_AT_ONCE = 8
#: sequences a layer's products take at once
ROWS_AT_ONCE = 8
#: the gated norm's epsilon, as ``Zamba2MambaMixer`` sets it
MAMBA_NORM_EPS = 1e-5


def stack_weights(cfg: Mapping, seed: int, stack: str, idx: int, device
                  ) -> Dict[str, torch.Tensor]:
    """One slice of a stack (a block, a point or a layer), drawn again from
    the seed, in fp32, by the path below the stack."""
    return {path: ZW.draw_leaf(cfg, seed, f"{stack}.{path}", idx, device).float()
            for path in ZW.stack_shapes(cfg)[stack]}


def top_weight(cfg: Mapping, seed: int, path: str, device) -> torch.Tensor:
    return ZW.draw_leaf(cfg, seed, path, None, device).float()


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of a_k over k = j + 1 .. i at [i, j],
    -inf above the diagonal (a masked cumulative sum, not a difference of
    running sums, which would lose the short segments' digits)."""
    t = a.shape[-1]
    ones = torch.ones((t, t), dtype=torch.bool, device=a.device)
    seg = torch.cumsum(a[..., None].expand(*a.shape, t).masked_fill(~ones.tril(-1), 0.0),
                       dim=-2)
    return seg.masked_fill_(~ones.tril(), float("-inf"))


def ssd_quadratic(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """The scan of one sequence, whole: x (T, h, p), dt (T, h), A and D (h,),
    B and C (T, g, n) -> y (T, h, p)."""
    t, h, p = x.shape
    g = B.shape[1]
    per = h // g
    step = math.gcd(HEADS_AT_ONCE, per)
    y = torch.empty_like(x)
    xdt = x * dt[..., None]
    for grp in range(g):
        cb = C[:, grp] @ B[:, grp].T                             # (T, T): C_i . B_j
        for h0 in range(grp * per, (grp + 1) * per, step):
            hs = slice(h0, h0 + step)
            decay = torch.exp(segsum((dt[:, hs] * A[hs]).T))      # (heads, T, T)
            y[:, hs] = ((cb * decay) @ xdt[:, hs].transpose(0, 1)).transpose(0, 1)
    return y + x * D[:, None]


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (rows, T, c), w (width, c) -> sum over k of
    w[k] x[t - width + 1 + k], plus b."""
    width, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    return b + sum(w[k] * pad[:, k:k + t] for k in range(width))


def mamba_layer(p: Mapping[str, torch.Tensor], cfg: Mapping, x: torch.Tensor,
                extra: Optional[torch.Tensor], prec: R.Precision) -> torch.Tensor:
    rows, t, d = x.shape
    heads, hp = cfg["n_mamba_heads"], cfg["mamba_headdim"]
    g, n = cfg["mamba_ngroups"], cfg["mamba_d_state"]
    d_inner = cfg["mamba_expand"] * d
    h = prec.store(R.rms_norm(x if extra is None else x + extra, p["ln"], cfg["rms_norm_eps"]))
    z, xbc, dt = torch.split(prec.mm(h, p["mixer.in_proj"]),
                             [d_inner, d_inner + 2 * g * n, heads], dim=-1)
    xbc = prec.store(F.silu(causal_conv(xbc, p["mixer.conv_w"], p["mixer.conv_b"])))
    xs, B, C = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt + p["mixer.dt_bias"])
    A = -torch.exp(p["mixer.a_log"])
    y = torch.stack([ssd_quadratic(xs[i].reshape(t, heads, hp), dt[i], A,
                                   B[i].reshape(t, g, n), C[i].reshape(t, g, n),
                                   p["mixer.d_skip"]) for i in range(rows)])
    gated = (y.reshape(rows, t, d_inner) * F.silu(z)).reshape(rows, t, g, d_inner // g)
    y = R.rms_norm(gated, p["mixer.norm"].reshape(g, -1), MAMBA_NORM_EPS)
    return prec.store(x + prec.mm(prec.store(y.reshape(rows, t, d_inner)),
                                  p["mixer.out_proj"]))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """One sequence's causal attention: q, k, v (T, heads, hd), a few heads
    at a time."""
    t, heads, _ = q.shape
    future = R._future(t, q.device)
    out = torch.empty_like(q)
    for h0 in range(0, heads, R.HEADS_AT_ONCE):
        hs = slice(h0, h0 + R.HEADS_AT_ONCE)
        qi, ki, vi = (u[:, hs].transpose(0, 1) for u in (q, k, v))
        scores = (qi @ ki.transpose(1, 2) * scale).masked_fill_(future, float("-inf"))
        out[:, hs] = (torch.softmax(scores, dim=-1) @ vi).transpose(0, 1)
    return out


def shared_block(pb: Mapping[str, torch.Tensor], pp: Mapping[str, torch.Tensor],
                 cfg: Mapping, x: torch.Tensor, emb: torch.Tensor,
                 prec: R.Precision) -> torch.Tensor:
    """A shared block on [x, emb], with the point's adapter, mapped by the
    point's linear: the ``extra`` of the point's Mamba2 layer."""
    rows, t, _ = x.shape
    heads, hd, eps = cfg["num_attention_heads"], cfg["attention_head_dim"], cfg["rms_norm_eps"]
    h = prec.store(R.rms_norm(torch.cat([x, emb], dim=-1), pb["ln1"], eps))
    q, k, v = (prec.mm(h, pb[f"attn.w{c}"]).reshape(rows, t, heads, hd) for c in "qkv")
    pos = torch.arange(t, device=x.device)
    q = prec.store(R.rope(q, pos, cfg["rope_theta"]))
    k = prec.store(R.rope(k, pos, cfg["rope_theta"]))
    o = torch.stack([causal_attention(q[i], k[i], v[i], (hd / 2) ** -0.5) for i in range(rows)])
    h = prec.mm(prec.store(o).reshape(rows, t, heads * hd), pb["attn.wo"])
    h = prec.store(R.rms_norm(h, pb["ln2"], eps))
    gate, up = (prec.mm(h, pb["mlp.w_gate_up"])
                + prec.mm(prec.mm(h, pp["adapter_a"]), pp["adapter_b"])).chunk(2, dim=-1)
    h = prec.mm(prec.store(F.gelu(gate) * up), pb["mlp.w_down"])
    return prec.mm(h, pp["linear"])


@torch.no_grad()
def serve_logits(cfg: Mapping, seed: int, tokens: torch.Tensor, prompt_len: int,
                 positions: Sequence[int], device, lowp: Optional[str] = None
                 ) -> torch.Tensor:
    """The logits (r, len(positions), vocab) of ``tokens`` (r, T), each row a
    prompt and its served tokens, from the full forward over the row
    (``prompt_len`` is taken for the signature :mod:`check` calls with: a
    Zamba2 forward does not depend on it)."""
    R.setup_matmul()
    prec = R.Precision(lowp)
    tokens = tokens.to(device)
    embed = top_weight(cfg, seed, "embed", device)
    emb = embed[tokens]
    x = emb.clone()
    points = {layer: j for j, layer in enumerate(cfg["hybrid_layer_ids"])}
    for i in range(cfg["num_hidden_layers"]):
        p = stack_weights(cfg, seed, "layers", i, device)
        j = points.get(i)
        if j is not None:
            pb = stack_weights(cfg, seed, "blocks", j % cfg["num_mem_blocks"], device)
            pp = stack_weights(cfg, seed, "points", j, device)
        for r0 in range(0, x.shape[0], ROWS_AT_ONCE):
            rows = slice(r0, r0 + ROWS_AT_ONCE)
            extra = None if j is None else shared_block(pb, pp, cfg, x[rows], emb[rows], prec)
            x[rows] = mamba_layer(p, cfg, x[rows], extra, prec)
    x = prec.store(R.rms_norm(x[:, list(positions)], top_weight(cfg, seed, "ln_f", device),
                              cfg["rms_norm_eps"]))
    return prec.mm(x, embed[:cfg["vocab_size"]].T)
