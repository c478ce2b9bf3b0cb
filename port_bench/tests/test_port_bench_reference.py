"""The plain reference against the port's plain path (its CPU mode) at smoke
size in fp32, from the benchmark's own weights: the MoE model's prefill
(with its capacity drops) and decode steps, and the dense model's first
training steps."""
import math

import pytest
import torch

import port_bench_tiny as tiny
import check
import port
import reference
import traffic as T
import weights as W

SEED = 3_000_000_019


def _moe_cfg(**kw):
    return dict(tiny.TINY_MOE, **kw)


def test_weights_tree_is_the_ports_and_draws_again_the_same():
    for cfg in (tiny.TINY_MOE, tiny.TINY_DENSE):
        tree = W.make(cfg, SEED, "cpu")
        port.check_layout(port.model_config(cfg), tree)
        for path, layer, _, _ in W.leaves(cfg):
            assert torch.equal(W.get(tree, path, layer), W.draw_leaf(cfg, SEED, path, layer,
                                                                     "cpu"))
    other = W.make(tiny.TINY_DENSE, SEED + 1, "cpu")
    assert not torch.equal(other["embed"], W.make(tiny.TINY_DENSE, SEED, "cpu")["embed"])


@pytest.mark.parametrize("prompt_len", [16, 40])
def test_moe_prefill_and_decode_match_the_reference(prompt_len):
    from repro_torch.models import build_model
    from repro_torch.models.moe import _capacity
    from repro_torch.runtime.server import Server
    cfg = _moe_cfg()
    mc = port.model_config(cfg)
    model = build_model(mc)
    params = W.make(cfg, SEED, "cpu")
    prompts = T.prompts({"batch": 3, "prompt_len": prompt_len}, cfg,
                        SEED, 0, "cpu")
    assert _capacity(prompt_len, mc, 1.25) == reference.capacity(prompt_len, cfg)
    logits, cache = model.prefill(params, {"tokens": prompts})
    cache = Server._grow_cache(cache, 4)
    outs, fed = [logits[:, -1, :cfg["vocab_size"]]], []
    for _ in range(3):
        tok = outs[-1].argmax(-1)
        fed.append(tok)
        logits, cache = model.decode_step(params, cache, {"token": tok[:, None].int()})
        outs.append(logits[:, -1, :cfg["vocab_size"]])
    port_logits = torch.stack(outs, dim=1)
    ids = torch.cat([prompts, torch.stack(fed, 1).int()], dim=1)
    positions = list(range(prompt_len - 1, prompt_len + 3))
    ref = reference.serve_logits(cfg, SEED, ids, prompt_len, positions, "cpu")
    torch.testing.assert_close(port_logits, ref, rtol=1e-4, atol=1e-5)


def test_routing_drops_past_capacity_in_token_order():
    cfg = _moe_cfg()
    x = torch.randn(2, 40, cfg["hidden_size"], generator=torch.Generator().manual_seed(1))
    router = torch.randn(cfg["hidden_size"], cfg["num_experts"],
                         generator=torch.Generator().manual_seed(2))
    idx, gates = reference.route(router, cfg, x, block=40)
    cap = reference.capacity(40, cfg)
    for b in range(2):
        for e in range(cfg["num_experts"]):
            tokens = [t for t in range(40) if e in idx[b, t].tolist()]
            kept = [t for t in tokens if gates[b, t][idx[b, t] == e].item() > 0]
            assert kept == tokens[:cap]
    assert (gates == 0).any()                     # this block drops some choices


def test_dense_first_steps_match_the_reference():
    from repro_torch.config import SMOKE_MESH, RunConfig, ShapeConfig, TrainConfig
    from repro_torch.optim import init_state
    from repro_torch.runtime.steps import train_bundle
    import importlib.util
    spec = importlib.util.spec_from_file_location("port_bench_loop_train_t",
                                                  tiny.BENCH / "loops" / "train.py")
    loop = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop)
    cfg, tr = tiny.TINY_DENSE, tiny.TRAIN
    rc = RunConfig(model=port.model_config(cfg),
                   shape=ShapeConfig("t", tr["seq_len"], tr["batch"], "train"),
                   mesh=SMOKE_MESH, train=TrainConfig(**loop.train_config(tr)))
    fn = train_bundle(rc).fn
    box = {"state": init_state(W.make(cfg, SEED, "cpu"))}
    data = T.lm_batches(tr, cfg, SEED)

    def step():
        batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
        box["state"], m = fn(box["state"], batch)
        return float(m["loss"])
    prog = loop.first_steps(cfg, tr, SEED, "cpu", step, lambda: box["state"])
    gen = T.lm_batches(tr, cfg, SEED)
    ref = reference.train_steps(cfg, SEED, [next(gen) for _ in range(tr["check_steps"])],
                                tr["optimizer"], "cpu")
    for p, r in zip(prog["losses"], ref["losses"]):
        assert p == pytest.approx(r, rel=1e-5)
    names = sorted(ref["first_grad"])
    assert max(abs(prog["first_grad"][n] - ref["first_grad"][n]) for n in names) <= 1e-5
    nums = check.train_numbers(prog, ref)
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-4 and nums["change_gap"] < 1e-3
    # with rotary embeddings after it the key bias moves the scores: every leaf moves
    assert set(check.moving_leaves(ref["first_grad"])) == set(names)
    assert all(math.isfinite(v) for v in ref["change"].values())


@pytest.mark.parametrize("lowp", ["fp8", "fp8_products"])
def test_the_lower_precisions_round_what_they_name(lowp):
    gen = torch.Generator().manual_seed(5)
    x, w = torch.randn(8, 32, generator=gen), torch.randn(32, 16, generator=gen)
    prec = reference.Precision(lowp)
    # a product's operands are rounded in both, a kept activation in fp8 alone
    assert not torch.equal(prec.mm(x, w), x @ w)
    assert torch.equal(prec.mm(x, w), reference._fp8(x, -1) @ reference._fp8(w, 0)) == (
        lowp == "fp8_products")
    assert torch.equal(prec.store(x), x) == (lowp == "fp8_products")
    with pytest.raises(ValueError):
        reference.Precision("int4")
