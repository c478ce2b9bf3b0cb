"""The plain reference of the served and trained decoder LMs, in fp32.

Plain PyTorch, written from the models' equations and the configuration's
file, importing nothing of the program: pre-norm blocks with RMS norms
(``x * rsqrt(mean(x^2) + eps) * (1 + gamma)``), rotary embeddings on the
two halves of each head, causal attention with grouped kv heads (query head
i reads kv head i // group), a SwiGLU FFN or a mixture of experts, and a
head over the published vocabulary.  The experts follow the program's
routing rules: a softmax router in fp32, the top ``num_experts_per_tok``
experts with their gates renormalized to sum to 1, and in a block of tokens
routed together (a served prompt, a training sequence) each expert keeps its
first ``int(tokens * k * 1.25 / E)`` choices (at least 4, at most the
block's tokens) in token order, a dropped choice adding nothing.  A decode
step routes its one token without drops.  The training loss is the mean
over tokens of the cross entropy plus 1e-4 of the squared log-partition,
over the head's padded columns as the port's loss runs (its vocabulary
padded to a multiple of 256; a served token is chosen from the published
vocabulary alone).

Weights come from :mod:`weights`, drawn again from the seed layer by layer
and widened to fp32, never from the program's tensors.  Training keeps fp32
master weights and computes with them rounded to the configuration's dtype
(bf16 parameters with fp32 masters, as the configuration states), widened
back to fp32: an update below half a bf16 step moves the master and not the
weights the next step computes with.  Work is blocked so
that it fits beside what is left on the card: layer by layer, attention a
sequence and a few heads at a time, the loss a few rows at a time.

``lowp="fp8"`` is the control, the reference computed one precision below
the configuration's bf16: every product's operands (the projections, the
FFN or experts, the head; weights scaled by output column, activations by
row, to the format's largest value) and every activation kept between
operations (and, in training, its gradient; scaled by row) are rounded to
float8 e4m3; the router's and attention's inner arithmetic stays fp32.  A
product's rounding passes the gradient straight through.
``lowp="fp8_products"`` rounds the products' operands alone and keeps every
activation as it is: the fp8 step a faster program would take first.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

import weights as W

CAPACITY_FACTOR = 1.25
Z_LOSS = 1e-4
#: query heads a block of the attention computes at once
HEADS_AT_ONCE = 8
#: rows of the loss's logits computed at once
LOSS_ROWS = 1024
F8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled along ``dim`` by its largest
    magnitude, and back to fp32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _straight(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach() if x.requires_grad else q


class _Stored(torch.autograd.Function):
    """``x`` as a tensor kept in float8 e4m3 holds it (scaled by row), and
    its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, -1)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, -1)


class Precision:
    """The precision of the reference's arithmetic: fp32 throughout, or
    (the control) fp8: every product's operands, every activation between
    operations and, in training, its gradient rounded to float8 e4m3; or
    ``fp8_products``: the products' operands alone."""

    def __init__(self, lowp: Optional[str] = None):
        if lowp not in (None, "fp8", "fp8_products"):
            raise ValueError(f"unknown lower precision {lowp!r}")
        self.lowp = lowp

    def store(self, x: torch.Tensor) -> torch.Tensor:
        return _Stored.apply(x) if self.lowp == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., k) @ w (k, n)."""
        if self.lowp is not None:
            x = _straight(x, _fp8(x.detach(), -1))
            w = _straight(w, _fp8(w.detach(), 0))
        return self.store(x @ w)


def setup_matmul() -> None:
    """fp32 products stay fp32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + gamma)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, s, heads, hd); positions (s,)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions.float()[:, None] * freqs                  # (s, hd/2)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _future(s: int, device) -> torch.Tensor:
    """(s, s): True where a key lies after its query."""
    return torch.ones((s, s), dtype=torch.bool, device=device).triu(1)


def _causal_scores(q: torch.Tensor, k: torch.Tensor, future: torch.Tensor) -> torch.Tensor:
    """(heads, s, hd) x (heads, s, hd) -> masked, scaled scores (heads, s, s)."""
    scores = q @ k.transpose(1, 2) / math.sqrt(q.shape[-1])
    return scores.masked_fill_(future, float("-inf"))


class CausalAttention(torch.autograd.Function):
    """Causal attention over (b, s, h, hd) q and (b, s, kv, hd) k, v, one
    sequence and ``HEADS_AT_ONCE`` heads at a time, keeping no scores for
    the backward pass, which computes them again."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        b, s, h, hd = q.shape
        group = h // k.shape[2]
        future = _future(s, q.device)
        out = torch.empty_like(q)
        for i in range(b):
            for h0 in range(0, h, HEADS_AT_ONCE):
                hs = slice(h0, min(h0 + HEADS_AT_ONCE, h))
                kh = torch.arange(hs.start, hs.stop, device=q.device) // group
                qi = q[i, :, hs].transpose(0, 1)
                ki, vi = k[i][:, kh].transpose(0, 1), v[i][:, kh].transpose(0, 1)
                p = torch.softmax(_causal_scores(qi, ki, future), dim=-1)
                out[i, :, hs] = (p @ vi).transpose(0, 1)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        b, s, h, hd = q.shape
        group = h // k.shape[2]
        future = _future(s, q.device)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        c = 1.0 / math.sqrt(hd)
        for i in range(b):
            for h0 in range(0, h, HEADS_AT_ONCE):
                hs = slice(h0, min(h0 + HEADS_AT_ONCE, h))
                kh = torch.arange(hs.start, hs.stop, device=q.device) // group
                qi = q[i, :, hs].transpose(0, 1)
                ki, vi = k[i][:, kh].transpose(0, 1), v[i][:, kh].transpose(0, 1)
                do = dout[i, :, hs].transpose(0, 1)
                p = torch.softmax(_causal_scores(qi, ki, future), dim=-1)
                dvi = p.transpose(1, 2) @ do
                dp = do @ vi.transpose(1, 2)
                ds = p * (dp - (dp * p).sum(-1, keepdim=True))
                dq[i, :, hs] = (ds @ ki * c).transpose(0, 1)
                dki = (ds.transpose(1, 2) @ qi * c)
                dk[i].index_add_(1, kh, dki.transpose(0, 1))
                dv[i].index_add_(1, kh, dvi.transpose(0, 1))
        return dq, dk, dv


def attention(p: Mapping[str, torch.Tensor], cfg: Mapping, x: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    b, s, _ = x.shape
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], W.head_dim(cfg)
    q, k, v = (prec.mm(x, p[f"attn.w{n}"]) for n in "qkv")
    if cfg.get("qkv_bias"):
        q, k, v = (prec.store(t + p[f"attn.b{n}"]) for t, n in zip((q, k, v), "qkv"))
    pos = torch.arange(s, device=x.device)
    q = prec.store(rope(q.reshape(b, s, h, hd), pos, cfg["rope_theta"]))
    k = prec.store(rope(k.reshape(b, s, kv, hd), pos, cfg["rope_theta"]))
    out = prec.store(CausalAttention.apply(q, k, v.reshape(b, s, kv, hd)))
    return prec.mm(out.reshape(b, s, h * hd), p["attn.wo"])


def swiglu(x, wg, wu, wd, prec: Precision) -> torch.Tensor:
    return prec.mm(prec.store(torch.nn.functional.silu(prec.mm(x, wg)) * prec.mm(x, wu)), wd)


def capacity(tokens: int, cfg: Mapping) -> int:
    cap = int(tokens * cfg["num_experts_per_tok"] * CAPACITY_FACTOR / cfg["num_experts"])
    return max(min(cap, tokens), 4)


def route(router: torch.Tensor, cfg: Mapping, x: torch.Tensor, block: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (b, s, k), gates (b, s, k)) of x (b, s, d): positions below
    ``block`` are one block routed with drops, each later one alone without."""
    b, s, _ = x.shape
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ router, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    n = min(block, s)
    if n:
        chosen = torch.zeros((b, n, e), dtype=torch.int32, device=x.device)
        chosen.scatter_(2, idx[:, :n], 1)
        rank = chosen.cumsum(1) - 1                       # place in its expert's queue
        kept = torch.gather(rank, 2, idx[:, :n]) < capacity(n, cfg)
        gates = torch.cat([gates[:, :n] * kept, gates[:, n:]], dim=1)
    return idx, gates


def moe(p: Mapping[str, torch.Tensor], cfg: Mapping, x: torch.Tensor, block: int,
        prec: Precision) -> torch.Tensor:
    b, s, d = x.shape
    idx, gates = route(p["moe.router"], cfg, x, block)
    flat = x.reshape(b * s, d)
    out = torch.zeros_like(flat)
    tok = torch.arange(b * s, device=x.device).repeat_interleave(idx.shape[-1])
    ex, g = idx.reshape(-1), gates.reshape(-1)
    order = torch.argsort(ex, stable=True)
    counts = torch.bincount(ex, minlength=cfg["num_experts"]).tolist()
    start = 0
    for e, n in enumerate(counts):
        if n:
            sel = order[start:start + n]
            rows = tok[sel]
            y = swiglu(flat[rows], p["moe.w_gate"][e], p["moe.w_up"][e], p["moe.w_down"][e],
                       prec)
            out.index_add_(0, rows, y * g[sel, None])
        start += n
    return out.reshape(b, s, d)


def block_forward(p: Mapping[str, torch.Tensor], cfg: Mapping, x: torch.Tensor,
                  route_block: int, prec: Precision) -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    x = prec.store(x + attention(p, cfg, prec.store(rms_norm(x, p["ln1"], eps)), prec))
    h = prec.store(rms_norm(x, p["ln2"], eps))
    if cfg.get("num_experts"):
        return prec.store(x + moe(p, cfg, h, route_block, prec))
    return prec.store(x + swiglu(h, p["ffn.w_gate"], p["ffn.w_up"], p["ffn.w_down"], prec))


def layer_weights(cfg: Mapping, seed: int, layer: int, device) -> Dict[str, torch.Tensor]:
    """One layer's weights drawn again from the seed, in fp32."""
    return {path: W.draw_leaf(cfg, seed, path, layer, device).float()
            for path in W.layer_shapes(cfg)}


def top_weight(cfg: Mapping, seed: int, path: str, device) -> torch.Tensor:
    return W.draw_leaf(cfg, seed, path, None, device).float()


# ---------------------------------------------------------------------------
# Serving: logits at chosen positions of whole sequences
# ---------------------------------------------------------------------------

@torch.no_grad()
def serve_logits(cfg: Mapping, seed: int, tokens: torch.Tensor, prompt_len: int,
                 positions: Sequence[int], device, lowp: Optional[str] = None
                 ) -> torch.Tensor:
    """The logits (r, len(positions), vocab) of ``tokens`` (r, T): each row a
    prompt of ``prompt_len`` tokens (prefilled: routed as one block) and the
    served tokens fed back one by one (decoded: each routed alone)."""
    setup_matmul()
    prec = Precision(lowp)
    tokens = tokens.to(device)
    x = top_weight(cfg, seed, "embed", device)[tokens]
    for layer in range(cfg["num_hidden_layers"]):
        x = block_forward(layer_weights(cfg, seed, layer, device), cfg, x, prompt_len, prec)
    x = prec.store(rms_norm(x[:, list(positions)], top_weight(cfg, seed, "ln_f", device),
                            cfg["rms_norm_eps"]))
    head = top_weight(cfg, seed, "head", device)[:, :cfg["vocab_size"]]
    return prec.mm(x, head)


# ---------------------------------------------------------------------------
# Training: the first steps of AdamW, layer by layer
# ---------------------------------------------------------------------------

def lr_at(step: int, opt: Mapping) -> float:
    """Linear warm-up, then cosine decay to a tenth of the peak."""
    peak, warm, total = opt["learning_rate"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.1 * peak + 0.9 * peak * 0.5 * (1 + math.cos(math.pi * frac))


def _loss_and_grads(master: Dict[str, torch.Tensor], cfg: Mapping, batch: Mapping,
                    prec: Precision, device) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The mean loss of one batch and its fp32 gradient by leaf name, with
    the masters rounded to the configuration's dtype: the forward keeps
    each layer's input, the backward runs the layers again one at a time."""
    dtype = W.dtype_of(cfg)

    class Rounded(dict):
        def __missing__(self, name):
            return master[name].to(dtype, copy=True).float()
    params = Rounded()
    tokens = torch.as_tensor(batch["tokens"], device=device).long()
    labels = torch.as_tensor(batch["labels"], device=device).long()
    b, s = tokens.shape
    n_layers = cfg["num_hidden_layers"]
    eps = cfg["rms_norm_eps"]
    grads: Dict[str, torch.Tensor] = {}

    def layer_params(layer):
        return {p: params[W.leaf_name(p, layer)] for p in W.layer_shapes(cfg)}

    with torch.no_grad():
        xs = [params["embed"][tokens]]
        for layer in range(n_layers):
            xs.append(block_forward(layer_params(layer), cfg, xs[-1], s, prec))

    # the loss, a few rows at a time, and its gradient wrt the last hidden
    x_last = xs.pop().reshape(b * s, -1)
    ln_f = params["ln_f"].requires_grad_()
    head = params["head"].requires_grad_()
    dx = torch.empty_like(x_last)
    total = 0.0
    for r0 in range(0, b * s, LOSS_ROWS):
        xr = x_last[r0:r0 + LOSS_ROWS].detach().requires_grad_()
        with torch.enable_grad():
            logits = prec.mm(prec.store(rms_norm(xr, ln_f, eps)), head)
            lse = torch.logsumexp(logits, dim=-1)
            true = logits.gather(1, labels.reshape(-1)[r0:r0 + LOSS_ROWS, None])[:, 0]
            loss = ((lse - true) + Z_LOSS * lse.square()).sum() / (b * s)
            loss.backward()
        total += float(loss.detach())
        dx[r0:r0 + LOSS_ROWS] = xr.grad
    grads["ln_f"], grads["head"] = ln_f.grad, head.grad
    del x_last
    dx = dx.reshape(b, s, -1)
    for layer in reversed(range(n_layers)):
        xin = xs.pop().requires_grad_()
        lp = {k: t.requires_grad_() for k, t in layer_params(layer).items()}
        with torch.enable_grad():
            out = block_forward(lp, cfg, xin, s, prec)
            out.backward(dx)
        dx = xin.grad
        for k, t in lp.items():
            grads[W.leaf_name(k, layer)] = t.grad
        del xin, out
    emb = torch.zeros_like(master["embed"])
    emb.index_add_(0, tokens.reshape(-1), dx.reshape(b * s, -1))
    grads["embed"] = emb
    return total, grads


def train_steps(cfg: Mapping, seed: int, batches: Sequence[Mapping], opt: Mapping, device,
                lowp: Optional[str] = None) -> Dict[str, object]:
    """AdamW with gradient clipping, from the seed's weights, over
    ``batches``, one step a batch.  Returns the losses, the first step's
    gradient as the update takes it (clipped) by leaf, as its norms, and
    each leaf's change after the last step, as its norms.  Between steps
    the moments wait on the host, so that a step's activations fit on the
    card beside the fp32 masters."""
    setup_matmul()
    prec = Precision(lowp)
    names = [W.leaf_name(p, layer) for p, layer, _, _ in W.leaves(cfg)]
    master = {W.leaf_name(p, layer): W.draw_leaf(cfg, seed, p, layer, device).float()
              for p, layer, _, _ in W.leaves(cfg)}
    m: Dict[str, torch.Tensor] = {}
    v: Dict[str, torch.Tensor] = {}
    keep = torch.device("cpu")
    b1, b2, eps, wd = opt["beta1"], opt["beta2"], opt["eps"], opt["weight_decay"]
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for i, batch in enumerate(batches):
        step = i + 1
        loss, grads = _loss_and_grads(master, cfg, batch, prec, device)
        losses.append(loss)
        gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9)) if opt["grad_clip"] else 1.0
        lr = lr_at(step, opt)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        for name in names:
            g = grads.pop(name) * scale
            if step == 1:
                first_grad[name] = float(g.norm())
            mi = m[name].to(device) if name in m else torch.zeros_like(g)
            vi = v[name].to(device) if name in v else torch.zeros_like(g)
            mi = b1 * mi + (1 - b1) * g
            vi = b2 * vi + (1 - b2) * g.square()
            upd = (mi / bc1) / ((vi / bc2).sqrt() + eps) + wd * master[name]
            master[name] -= lr * upd
            if step < len(batches):
                m[name], v[name] = mi.to(keep), vi.to(keep)
            del g, mi, vi, upd
    m.clear(), v.clear()
    change = {}
    for p, layer, _, _ in W.leaves(cfg):
        name = W.leaf_name(p, layer)
        w0 = W.draw_leaf(cfg, seed, p, layer, device).float()
        change[name] = float((master.pop(name) - w0).norm())
    return {"losses": losses, "first_grad": first_grad, "change": change}
