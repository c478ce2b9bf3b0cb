"""The port's llama3-8b serving path against the reference package's, on
the smoke config with the same weights.

One set of weights and one token batch are made with numpy from a seed and
handed to both packages (``params_from_jax`` is the weight transfer, bf16
arrays included).  The full forward's logits, the prefill's last-token
logits and KV cache, and one decode step after a prefill of s-1 tokens must
agree, at prompt lengths 16 and 200 (not a multiple of the kernel's tiles):

* fp32 (the config with ``dtype="float32"``): rtol 1e-4, atol 1e-5, sums in
  another order;
* bf16: max |port - reference| / max |reference| < 2e-2.  The port's
  prefill attention keeps the probabilities in fp32 (the kernel's
  contract), where the reference's ``sdpa`` rounds them to bf16 before the
  PV product, so the two differ by more than fp32 noise.

Greedy ``Server.generate`` must give the reference server's token ids, and
the capture of the prefill and decode steps must count the same dot FLOPs
as the analytic count and the live reference capture.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as RC
from repro.core import Simulator as RefSimulator
from repro.models import build_model as ref_build_model
from repro.models import param_count as ref_param_count
from repro.runtime.server import Server as RefServer
from repro.runtime.steps import decode_bundle, prefill_bundle
from repro_torch import config as C
from repro_torch.core import H100, Simulator
from repro_torch.models import build_model, param_count
from repro_torch.models.layers import pad_vocab
from repro_torch.models.transformer import params_from_jax
from repro_torch.runtime.server import Server
from repro_torch.runtime.steps import decode_step, prefill_step

ARCH = "llama3-8b"
B = 2


def _cfgs(dtype):
    ref, port = RC.get(ARCH).smoke, C.get(ARCH).smoke
    return (dataclasses.replace(ref, dtype=dtype),
            dataclasses.replace(port, dtype=dtype))


def _np_tree(specs, rng):
    """Weights in the reference's tree: unit-scale activations, random norm
    gains (the reference initializes them to zero)."""
    if not isinstance(specs, dict):
        shape = specs.shape
        if specs.init == "zeros":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        std = 0.5 if specs.init == "embed" else 1.0 / np.sqrt(shape[-2])
        return (std * rng.standard_normal(shape)).astype(np.float32)
    return {k: _np_tree(v, rng) for k, v in specs.items()}


def _jnp_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v, dtype) for k, v in tree.items()}
    return jnp.asarray(tree).astype(dtype)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(reference model, its params, port model, its params, dtype)."""
    dtype = request.param
    ref_cfg, cfg = _cfgs(dtype)
    ref_model = ref_build_model(ref_cfg)
    weights = _np_tree(ref_model.param_specs(), np.random.default_rng(0))
    ref_params = _jnp_tree(weights, jnp.dtype(dtype))
    # the transfer reads the reference's own arrays (bf16 included)
    port_params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg)
    return ref_model, ref_params, build_model(cfg), port_params, dtype


def _tokens(s, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, s)).astype(np.int32)


def _close(mine, ref, dtype):
    mine = mine.detach().float().numpy() if isinstance(mine, torch.Tensor) else mine
    ref = np.asarray(ref, np.float32)
    assert mine.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-5)
    else:
        rel = np.abs(mine - ref).max() / np.abs(ref).max()
        assert rel < 2e-2, rel


def _pad_cache(cache, extra):
    return {k: (jnp.pad(v, [(0, 0)] * 2 + [(0, extra)] + [(0, 0)] * 2)
                if k in ("k", "v") else v) for k, v in cache.items()}


@pytest.mark.parametrize("s", [16, 200])
def test_forward_matches_reference(pair, s):
    ref_model, ref_params, model, params, dtype = pair
    tokens = _tokens(s)
    want, _ = jax.jit(ref_model.forward)(ref_params, jnp.asarray(tokens))
    got, aux = model.forward(params, torch.from_numpy(tokens).long())
    assert float(aux) == 0.0
    _close(got, want, dtype)


@pytest.mark.parametrize("s", [16, 200])
def test_prefill_logits_and_cache_match_reference(pair, s):
    ref_model, ref_params, model, params, dtype = pair
    tokens = _tokens(s)
    want, want_cache = jax.jit(ref_model.prefill)(ref_params,
                                                  {"tokens": jnp.asarray(tokens)})
    got, cache = prefill_step(model, params, {"tokens": torch.from_numpy(tokens).long()})
    _close(got, want, dtype)
    for key in ("k", "v"):
        _close(cache[key], want_cache[key], dtype)
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0
    assert int(cache["pos"]) == int(want_cache["pos"]) == s


@pytest.mark.parametrize("s", [16, 200])
def test_decode_step_matches_reference_and_forward(pair, s):
    """Decoding token s-1 after prefilling s-1 tokens equals the reference's
    decode step and the port's own full forward at the last position."""
    ref_model, ref_params, model, params, dtype = pair
    tokens = _tokens(s)
    _, ref_cache = jax.jit(ref_model.prefill)(
        ref_params, {"tokens": jnp.asarray(tokens[:, :s - 1])})
    want, _ = jax.jit(ref_model.decode_step)(
        ref_params, _pad_cache(ref_cache, 4), {"token": jnp.asarray(tokens[:, s - 1:])})
    tt = torch.from_numpy(tokens).long()
    _, cache = prefill_step(model, params, {"tokens": tt[:, :s - 1]})
    cache = Server._grow_cache(cache, 4)
    got, new_cache = decode_step(model, params, cache, {"token": tt[:, s - 1:]})
    assert int(new_cache["pos"]) == s and new_cache["k"] is cache["k"]
    _close(got, want, dtype)
    full, _ = model.forward(params, tt)
    _close(got[:, 0], full[:, -1].numpy() if dtype == "float32"
           else full[:, -1].float().numpy(), dtype)


def test_greedy_server_matches_reference():
    ref_cfg, cfg = _cfgs("float32")
    ref_model = ref_build_model(ref_cfg)
    weights = _np_tree(ref_model.param_specs(), np.random.default_rng(0))
    prompts = _tokens(8, seed=5)
    shape = RC.ShapeConfig("tiny_serve", 32, B, "prefill")
    ref = RefServer(RC.RunConfig(model=ref_cfg, shape=shape, mesh=RC.SMOKE_MESH),
                    _jnp_tree(weights, jnp.float32), eos_token=-1)
    want = ref.generate({"tokens": jnp.asarray(prompts)}, max_new_tokens=4)
    srv = Server(C.RunConfig(model=cfg, shape=C.ShapeConfig("tiny_serve", 32, B, "prefill"),
                             mesh=C.SMOKE_MESH),
                 params_from_jax(weights, cfg), eos_token=-1)
    got = srv.generate({"tokens": torch.from_numpy(prompts).long()}, max_new_tokens=4)
    assert got.shape == (B, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert srv.stats.tokens_out == B * 3 and srv.stats.decode_tok_per_s > 0


def test_sampling_is_seeded_and_within_vocab():
    _, cfg = _cfgs("float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    rc = C.RunConfig(model=cfg, shape=C.ShapeConfig("s", 16, B, "prefill"),
                     mesh=C.SMOKE_MESH)
    prompts = torch.from_numpy(_tokens(8)).long()
    outs = [Server(rc, params, eos_token=-1, temperature=0.7).generate(
        {"tokens": prompts}, max_new_tokens=6, seed=3) for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].max() < cfg.vocab_size


def test_full_config_param_count_matches_reference():
    n = param_count(C.get(ARCH).full)
    assert n == ref_param_count(RC.get(ARCH).full)
    assert abs(n - 8.03e9) / 8.03e9 < 0.01


def test_params_from_jax_checks_the_tree():
    _, cfg = _cfgs("float32")
    weights = _np_tree(ref_build_model(_cfgs("float32")[0]).param_specs(),
                       np.random.default_rng(0))
    weights["layers"]["ffn"].pop("w_up")
    with pytest.raises(KeyError, match="w_up"):
        params_from_jax(weights, cfg)


# -- capture --------------------------------------------------------------

def _mxu_flops(module):
    return sum(scale * module.op_flops(comp, op)["mxu"]
               for op, comp, scale in module.walk_entry())


def _analytic_dot_flops(cfg, b, n, t):
    """2*M*N*K over every product of one prefill (n = t) or decode (n = 1)
    step: q, k, v, o and the three FFN products per layer, the full n x t
    score and PV products (the reference computes the masked half too), and
    the head on the last position."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    layer = (2 * b * n * d * (h + 2 * kv) * hd + 2 * b * n * h * hd * d
             + 3 * 2 * b * n * d * cfg.d_ff + 2 * 2 * b * h * n * t * hd)
    return cfg.num_layers * layer + 2 * b * d * pad_vocab(cfg.vocab_size)


@pytest.fixture(scope="module")
def captures():
    cfg = C.get(ARCH).smoke
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    s = 16
    tokens = torch.zeros(B, s, dtype=torch.long)
    kv_shape = (cfg.num_layers, B, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.zeros(kv_shape, dtype=torch.bfloat16),
             "v": torch.zeros(kv_shape, dtype=torch.bfloat16),
             "pos": torch.tensor(s - 1, dtype=torch.int32)}
    sim = Simulator(hw=H100)
    port = {"prefill": sim.capture(lambda p, bt: prefill_step(model, p, bt),
                                   params, {"tokens": tokens}, name="prefill"),
            "decode": sim.capture(lambda p, c, bt: decode_step(model, p, c, bt),
                                  params, cache, {"token": tokens[:, :1]},
                                  name="decode")}
    ref_cfg = RC.get(ARCH).smoke
    ref = {kind: RefSimulator().capture_bundle(bundle(RC.RunConfig(
        model=ref_cfg, shape=RC.ShapeConfig(kind, s, B, kind), mesh=RC.SMOKE_MESH)),
        name=kind) for kind, bundle in (("prefill", prefill_bundle),
                                        ("decode", decode_bundle))}
    return cfg, s, port, ref


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_capture_dot_flops_match_analytic_and_reference(captures, kind):
    cfg, s, port, ref = captures
    n = s if kind == "prefill" else 1
    assert _mxu_flops(port[kind].module) == _analytic_dot_flops(cfg, B, n, s)
    assert _mxu_flops(port[kind].module) == _mxu_flops(ref[kind].module)


def test_capture_has_one_flash_node_per_layer(captures):
    cfg, s, port, _ = captures
    op = torch.ops.repro_torch.flash_attention.default
    cap = port["prefill"]
    assert sum(n.target is op for n in cap.graph.graph.nodes) == cfg.num_layers
    comp = cap.module.comp(cap.module.entry)
    exps = [o for o in comp.ops if o.opcode == "exponential" and o.name.endswith(".p")]
    assert len(exps) == cfg.num_layers
    kv = cfg.num_kv_heads
    assert all(o.outputs[0].dims == (B, kv, cfg.num_heads // kv * s, s) for o in exps)
    assert not any(n.target is op for n in port["decode"].graph.graph.nodes)


def _dims(attr, raw):
    m = re.search(attr + r"=\{([\d,]*)\}", raw)
    return tuple(int(d) for d in m.group(1).split(",") if d) if m else ()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_capture_dot_operands_agree(captures, kind):
    """Every captured dot is valid HLO: its operands' batch dims and
    contracting dims have equal sizes (under GQA the flash op's products
    batch over the kv heads that k and v have)."""
    module = captures[2][kind].module
    comp = module.comp(module.entry)
    dots = [o for o in comp.ops if o.opcode == "dot"]
    assert dots
    for op in dots:
        lhs, rhs = (module.op_shape(comp, n)[0].dims for n in op.operands[:2])
        for side in ("batch", "contracting"):
            lo, ro = _dims(f"lhs_{side}_dims", op.raw), _dims(f"rhs_{side}_dims", op.raw)
            assert [lhs[i] for i in lo] == [rhs[i] for i in ro], (op.name, side, lhs, rhs)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_steps_simulate_on_h100(captures, kind):
    s = Simulator(hw=H100).performance(captures[2][kind]).summary()
    assert s["total_seconds"] > 0 and s["total_flops"] > 0
