"""The published Zamba2 (``zamba2-7b-instruct``, family ``zamba2``) against
the benchmark's plain reference of it (``port_bench/zamba2_reference.py``)
on the CPU in fp32, from the benchmark's own weights at a tiny size; and
that reference against ``transformers``' ``Zamba2ForCausalLM`` where
``transformers`` imports.

The port's forward, and its prefill followed by three decode steps through
the cache, hold to the reference's full forward at a length whose last
chunk of the scan is ragged and at one whose is not; the grouped, ragged
chunked scan holds to the reference's quadratic form and to the
step-by-step recurrence; the two shared blocks take turns, each point with
its own adapter and linear; a traced eager step records the new regions and
counts.  The reference matches ``transformers`` to 2e-5 in fp32 (held at
1e-4).  ``transformers``' plain Mamba2 path (``torch_forward``, 4.57) sums
its chunks' states over the wrong index in Zamba2's copy (the Mamba2 and
Bamba copies transpose ``decay_chunk`` first; Zamba2's does not), so there
it is given one chunk over the whole sequence.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "port_bench" / "tests"))

import zamba2_tiny as tiny  # noqa: E402  (puts port_bench on the path)
import zamba2_port  # noqa: E402
import zamba2_reference as ZR  # noqa: E402
import zamba2_weights as ZW  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch.models import build_model, param_count  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402
from repro_torch.runtime.server import Server  # noqa: E402

SEED = 2_718_281_829
CFG = tiny.TINY
V = CFG["vocab_size"]


def _tokens(s, b=3, seed=0):
    return torch.randint(0, V, (b, s), generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def model():
    mc = zamba2_port.model_config(CFG)
    params = ZW.make(CFG, SEED, "cpu")
    zamba2_port.check_layout(mc, params)
    return build_model(mc), params


@pytest.mark.parametrize("s", [32, 40])
def test_forward_matches_the_reference(model, s):
    """32 tokens: two whole chunks of 16; 40: two and a ragged 8."""
    m, params = model
    tok = _tokens(s)
    ref = ZR.serve_logits(CFG, SEED, tok, s, list(range(s)), "cpu")
    torch.testing.assert_close(m.forward(params, tok)[..., :V], ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [32, 40])
def test_prefill_and_decode_match_the_reference(model, s):
    m, params = model
    tok = _tokens(s, seed=1)
    logits, cache = m.prefill(params, {"tokens": tok})
    assert cache["k"].shape == (3, 3, s, 4, 64) and cache["mamba"]["state"].shape[0] == 7
    cache = Server._grow_cache(cache, 4)
    outs, fed = [logits[:, -1, :V]], []
    for _ in range(3):
        t = outs[-1].argmax(-1)
        fed.append(t)
        logits, cache = m.decode_step(params, cache, {"token": t[:, None].int()})
        outs.append(logits[:, -1, :V])
    ids = torch.cat([tok, torch.stack(fed, 1)], dim=1)
    ref = ZR.serve_logits(CFG, SEED, ids, s, list(range(s - 1, s + 3)), "cpu")
    torch.testing.assert_close(torch.stack(outs, dim=1), ref, rtol=1e-4, atol=1e-4)


def test_blocks_take_turns_and_each_point_has_its_own_adapter_and_linear(model):
    """Block j % 2 at point j (0, 1, 0 here; 7 and 6 of the 13 at full
    width), with point j's adapter and linear: every application reads its
    block's and its point's own storage."""
    full = build_model(C.get("zamba2-7b-instruct").full)
    assert [full.block_of(j) for j in range(13)] == [0, 1] * 6 + [0]
    m, params = model
    seen = []
    orig = m._mlp

    def spy(p_block, p_point, h):
        seen.append((p_block["mlp"]["w_down"].data_ptr(), p_point["adapter_a"].data_ptr(),
                     p_point["adapter_b"].data_ptr(), p_point["linear"].data_ptr()))
        return orig(p_block, p_point, h)
    m._mlp = spy
    try:
        m.forward(params, _tokens(8))
    finally:
        del m._mlp
    want = [(params["blocks"]["mlp"]["w_down"][j % 2].data_ptr(),
             *(params["points"][n][j].data_ptr() for n in ("adapter_a", "adapter_b", "linear")))
            for j in range(3)]
    assert seen == want
    # the last point's own adapter moves the output
    other = {k: v for k, v in params.items()}
    other["points"] = dict(params["points"], adapter_b=params["points"]["adapter_b"].clone())
    other["points"]["adapter_b"][2] += 0.5
    tok = _tokens(8)
    assert not torch.allclose(m.forward(other, tok), m.forward(params, tok))


def _recurrence(x, dt, A, B, C):
    """The scan one step at a time: state_t = exp(dt_t A) state + dt_t x_t B_t."""
    b, s, h, p = x.shape
    per = h // B.shape[2]
    Bh, Ch = B.repeat_interleave(per, dim=2), C.repeat_interleave(per, dim=2)
    state = torch.zeros(b, h, p, B.shape[-1])
    ys = []
    for t in range(s):
        state = (state * torch.exp(dt[:, t] * A)[..., None, None]
                 + torch.einsum("bhn,bhp->bhpn", Bh[:, t], x[:, t] * dt[:, t, :, None]))
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("s", [40, 48])
def test_grouped_ragged_scan_matches_the_quadratic_form_and_the_recurrence(s):
    """Two groups of three heads; chunks of 16 with a ragged last one of 8
    (s = 40) and without (48)."""
    g = torch.Generator().manual_seed(s)
    b, h, p, n, groups = 2, 6, 8, 4, 2
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g) * 0.5
    A = -torch.arange(1, h + 1, dtype=torch.float32) / 2
    B, Cm = (torch.randn(b, s, groups, n, generator=g) for _ in range(2))
    y, state = ssd_chunked(x * dt[..., None], dt * A, B, Cm, torch.zeros(b, h, p, n),
                           chunk=16, ragged=True)
    want_y, want_state = _recurrence(x, dt, A, B, Cm)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, want_state, rtol=1e-5, atol=1e-5)
    quad = torch.stack([ZR.ssd_quadratic(x[i], dt[i], A, B[i], Cm[i], torch.zeros(h))
                        for i in range(b)])
    torch.testing.assert_close(y, quad, rtol=1e-5, atol=1e-5)


def test_a_traced_eager_step_records_the_regions_and_counts(model):
    """SMOKE's prefill of 40 tokens scans 3 chunks in each of its 7 layers
    and applies block 0 twice and block 1 once; a full-width prefill of
    4,088 tokens scans 16 chunks a layer (15 of 256 and a ragged 8), 81 x 16
    in all."""
    from torch.profiler import profile, ProfilerActivity
    m, params = model
    REGISTRY.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits, cache = m.prefill(params, {"tokens": _tokens(40)})
        m.decode_step(params, Server._grow_cache(cache, 2), {"token": _tokens(1).int()})
    names = {e.name for e in prof.events()}
    assert {"repro.ssm.scan", "repro.ssm.mixer", "repro.shared.block",
            "repro.attn.flash_fwd", "repro.attn.core", "repro.lm_head"} <= names
    assert REGISTRY.value("ssm_scan_chunks_total", step="eager") == 7 * 3
    assert REGISTRY.value("shared_block_applications_total", step="eager", block="0") == 2 * 2
    assert REGISTRY.value("shared_block_applications_total", step="eager", block="1") == 2 * 1
    full = C.get("zamba2-7b-instruct").full
    meta = dict(device="meta")
    REGISTRY.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ssd_chunked(torch.empty(1, 4088, 112, 64, **meta), torch.empty(1, 4088, 112, **meta),
                    torch.empty(1, 4088, 2, 64, **meta), torch.empty(1, 4088, 2, 64, **meta),
                    torch.empty(1, 112, 64, 64, **meta), chunk=full.ssm_chunk, ragged=True)
    chunks = REGISTRY.value("ssm_scan_chunks_total", step="eager")
    assert chunks == math.ceil(4088 / 256) == 16
    assert full.num_layers * chunks == 81 * 16
    REGISTRY.clear()


def test_the_full_config_is_the_published_one():
    """FULL is the benchmark's file as the program reads it, and the tiny
    configuration these tests run is SMOKE in fp32."""
    entry = C.get("zamba2-7b-instruct")
    full = entry.full
    assert full == zamba2_port.model_config(tiny.FULL)
    assert zamba2_port.model_config(CFG) == entry.smoke.replace(name=CFG["name"],
                                                                dtype="float32")
    assert param_count(full) == 7_356_749_648


def _transformers():
    try:
        import transformers
        return transformers
    except Exception as e:            # not installed, or its imports fail here
        pytest.skip(f"transformers does not import: {e}")


def test_the_reference_matches_transformers():
    tf = _transformers()
    keys = ["hidden_size", "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
            "intermediate_size", "vocab_size", "mamba_d_state", "mamba_d_conv",
            "mamba_expand", "mamba_ngroups", "n_mamba_heads", "adapter_rank",
            "num_mem_blocks", "layers_block_type", "rope_theta", "rms_norm_eps",
            "use_mem_rope", "use_shared_attention_adapter", "use_shared_mlp_adapter",
            "hidden_act", "add_bias_linear", "use_conv_bias", "max_position_embeddings"]
    s = 37
    # one chunk (see the module's docstring), and a clamp of dt that never binds
    hc = tf.Zamba2Config(**{k: CFG[k] for k in keys}, chunk_size=64, time_step_min=1e-9,
                         tie_word_embeddings=True, attn_implementation="eager")
    hf = tf.Zamba2ForCausalLM(hc).eval()

    def w(path, idx=None, t=False, norm=False):
        x = ZW.draw_leaf(CFG, SEED, path, idx, "cpu").float()
        return 1 + x if norm else (x.T if t else x)
    points = {layer: j for j, layer in enumerate(CFG["hybrid_layer_ids"])}
    with torch.no_grad():
        mm = hf.model
        mm.embed_tokens.weight.copy_(w("embed")[:V])
        mm.final_layernorm.weight.copy_(w("ln_f", norm=True))
        for i, layer in enumerate(mm.layers):
            mamba = layer.mamba_decoder if i in points else layer
            mamba.input_layernorm.weight.copy_(w("layers.ln", i, norm=True))
            mx = mamba.mamba
            mx.in_proj.weight.copy_(w("layers.mixer.in_proj", i, t=True))
            mx.conv1d.weight.copy_(w("layers.mixer.conv_w", i, t=True)[:, None, :])
            mx.conv1d.bias.copy_(w("layers.mixer.conv_b", i))
            mx.dt_bias.copy_(w("layers.mixer.dt_bias", i))
            mx.A_log.copy_(w("layers.mixer.a_log", i))
            mx.D.copy_(w("layers.mixer.d_skip", i))
            mx.norm.weight.copy_(w("layers.mixer.norm", i, norm=True))
            mx.out_proj.weight.copy_(w("layers.mixer.out_proj", i, t=True))
            if i not in points:
                continue
            j = points[i]
            k = j % CFG["num_mem_blocks"]
            layer.linear.weight.copy_(w("points.linear", j, t=True))
            st = layer.shared_transformer
            assert st.block_id == k
            st.input_layernorm.weight.copy_(w("blocks.ln1", k, norm=True))
            st.pre_ff_layernorm.weight.copy_(w("blocks.ln2", k, norm=True))
            for c in "qkvo":
                getattr(st.self_attn, f"{c}_proj").weight.copy_(w(f"blocks.attn.w{c}", k, t=True))
            st.feed_forward.gate_up_proj.weight.copy_(w("blocks.mlp.w_gate_up", k, t=True))
            st.feed_forward.down_proj.weight.copy_(w("blocks.mlp.w_down", k, t=True))
            adapter = st.feed_forward.gate_up_proj_adapter_list[j]
            adapter[0].weight.copy_(w("points.adapter_a", j, t=True))
            adapter[1].weight.copy_(w("points.adapter_b", j, t=True))
        tok = _tokens(s, b=2, seed=5)
        got = hf(input_ids=tok, use_cache=False).logits
    ref = ZR.serve_logits(CFG, SEED, tok, s, list(range(s)), "cpu")
    torch.testing.assert_close(ref, got, rtol=1e-4, atol=1e-4)


def test_the_port_counts_the_parameters_transformers_counts_at_the_published_config():
    tf = _transformers()
    full = tiny.FULL
    hc = tf.Zamba2Config(**{k: v for k, v in full.items() if k in tf.Zamba2Config().to_dict()
                            and k not in ("torch_dtype", "architectures")})
    with torch.device("meta"):
        hf = tf.Zamba2ForCausalLM(hc)
    assert sum(p.numel() for p in hf.parameters()) == 7_356_749_648
    assert param_count(C.get("zamba2-7b-instruct").full) == 7_356_749_648


def test_the_new_modules_import_with_jax_and_repro_blocked():
    script = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT / 'port_bench')!r}]\n"
        "for m in ('repro_torch.models.zamba2', 'repro_torch.configs.zamba2_7b_instruct',\n"
        "          'zamba2_port', 'zamba2_weights', 'zamba2_check', 'zamba2_reference',\n"
        "          'zamba2_yardstick'):\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "import zamba2_reference\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
