"""The port's differential debugger (paper §III-D), functional mode,
checkpoint store and fidelity-switching checkpoint, on the CPU: the
counterparts of ``tests/test_debug.py``, the conv algorithms held to the
reference's ``compare_implementations`` on the same numpy inputs, and
checkpoints that each package restores from the other bit for bit."""
import itertools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro.core import compare_implementations as ref_compare
from repro.models.conv_algos import CONV_FNS as REF_CONV_FNS
from repro_torch import config as C
from repro_torch.checkpoint import (CheckpointManager, latest_step, list_steps,
                                    restore, save)
from repro_torch.core import (H100, Divergence, Engine, Simulator,
                              compare_implementations, first_divergence,
                              run_functional, simulate_from_checkpoint)
from repro_torch.data.synthetic import synthetic_mnist_batches
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.tiled_matmul import matmul
from repro_torch.models.conv_algos import CONV_FNS
from repro_torch.models.lenet import LeNet, sgd_step


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# level 1 and level 2
# ---------------------------------------------------------------------------

def test_paper_rem_bug_level1():
    """The paper's GPGPU-Sim bug: rem on the wrong width and sign.  Level 1
    (API-call level) flags it."""
    def rem_correct(a, b):
        return torch.fmod(a, b)

    def rem_buggy(a, b):          # treats signed ints as unsigned 32-bit
        au, bu = a.long() & 0xFFFFFFFF, b.long() & 0xFFFFFFFF
        return (au % bu).int()

    a = torch.tensor([-7, 7, -5, 5], dtype=torch.int32)
    b = torch.tensor([3, 3, 2, 2], dtype=torch.int32)
    ok, err = compare_implementations(rem_buggy, rem_correct, (a, b))
    assert not ok and err == float("inf"), "planted rem bug not detected"
    assert compare_implementations(rem_correct, rem_correct, (a, b)) == (True, 0.0)


def test_first_divergence_finds_planted_precision_bug():
    """Level 2: a catastrophic cancellation is flagged as the FIRST
    divergent node against the float64 oracle, not a later one."""
    def f(x):
        y = x + 1.0               # node 0: fine
        z = (y + 1e7) - 1e7       # cancellation: diverges from the oracle
        return z * 2.0

    div = first_divergence(f, (torch.full((8,), 0.123),), rtol=1e-6, atol=1e-6)
    assert isinstance(div, Divergence)
    assert div.primitive in ("aten.add.Tensor", "aten.sub.Tensor"), div
    assert div.eqn_index <= 2, f"flagged too late: {div}"


def test_first_divergence_clean_function():
    assert first_divergence(lambda x: x * 2.0 + 1.0, (torch.ones(4),),
                            rtol=1e-3, atol=1e-3) is None


def _products(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(64, 32, generator=g), torch.randn(32, 24, generator=g),
            torch.randn(24, 10, generator=g))


@pytest.mark.parametrize("which", [0, 1])
def test_planted_bf16_rounding_found_at_its_node(which):
    """One product's inputs rounded to bf16 (the first or the second
    product): flagged at that rounding, and nowhere before it."""
    def f(a, b, c, plant):
        h = torch.relu(matmul(a, b) if plant != 0 else
                       matmul(a.bfloat16().float(), b.bfloat16().float()))
        if plant == 1:
            h, c = h.bfloat16().float(), c.bfloat16().float()
        return matmul(h, c)

    a, b, c = _products()
    assert first_divergence(lambda a, b, c: f(a, b, c, None), (a, b, c),
                            rtol=1e-4, atol=1e-6) is None
    div = first_divergence(lambda a, b, c: f(a, b, c, which), (a, b, c),
                           rtol=1e-4, atol=1e-6)
    assert div is not None
    assert div.primitive == "aten._to_copy.default" and div.out_dtypes == ("bfloat16",)
    assert div.out_shapes == ([(64, 32)] if which == 0 else [(64, 24)])
    assert div.eqn_index == (0 if which == 0 else 2)
    assert div.path == ()


def test_hand_kernel_node_localized_in_its_plain_version():
    """Level 3: a bf16 flash-attention node diverges from the float64
    oracle; the walk of its plain version's graph names the op inside it
    that rounds — the output's cast to bf16."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 64, 32, generator=g).bfloat16() for _ in range(3))
    div = first_divergence(lambda q, k, v: flash_attention(q, k, v), (q, k, v),
                           rtol=1e-4, atol=1e-6)
    assert div is not None and len(div.path) == 1
    assert "repro_torch.flash_attention" in div.path[0]
    assert div.primitive == "aten._to_copy.default" and div.out_dtypes == ("bfloat16",)
    shallow = first_divergence(lambda q, k, v: flash_attention(q, k, v), (q, k, v),
                               rtol=1e-4, atol=1e-6, max_depth=0)
    assert shallow.path == () and shallow.primitive == "repro_torch.flash_attention.default"


def test_lenet_step_has_no_divergence_in_fp32():
    cfg = C.get("lenet").smoke
    model = LeNet(cfg, conv_algo="gemm", device="cpu")
    batch = next(synthetic_mnist_batches(cfg, batch=8, seed=0))
    x, y = torch.from_numpy(batch["images"]), torch.from_numpy(batch["labels"]).long()
    assert first_divergence(lambda p, a, b: sgd_step(model, p, a, b, 0.05),
                            (model.param_dict(), x, y), rtol=1e-4, atol=1e-6) is None


@pytest.mark.parametrize("algo", sorted(CONV_FNS))
def test_compare_conv_algorithms(algo):
    """The paper's section V cross-check: every conv algorithm agrees with
    the implicit one — in the port, and in the reference on the same numpy
    inputs, with the same verdict, and the two packages' outputs agree."""
    x_np, w_np = _randn(0, 2, 12, 12, 4), _randn(1, 3, 3, 4, 8)
    x, w = torch.from_numpy(x_np), torch.from_numpy(w_np)
    ref = CONV_FNS["implicit"](x, w, "SAME")
    ok, err = compare_implementations(lambda x_, w_: CONV_FNS[algo](x_, w_, "SAME"),
                                      lambda x_, w_: ref, (x, w), rtol=1e-3, atol=1e-3)
    jx, jw = jnp.asarray(x_np), jnp.asarray(w_np)
    jref = REF_CONV_FNS["implicit"](jx, jw, "SAME")
    jok, jerr = ref_compare(lambda x_, w_: REF_CONV_FNS[algo](x_, w_, "SAME"),
                            lambda x_, w_: jref, (jx, jw), rtol=1e-3, atol=1e-3)
    assert ok and jok, (err, jerr)
    np.testing.assert_allclose(CONV_FNS[algo](x, w, "SAME").numpy(),
                               np.asarray(REF_CONV_FNS[algo](jx, jw, "SAME")),
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# checkpoints, across the two packages
# ---------------------------------------------------------------------------

def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((5, 3)).astype(np.float32),
            "b16": r.standard_normal((4,)).astype(np.float32),
            "nested": {"z": r.integers(0, 9, (3,)).astype(np.int32),
                       "a": [r.standard_normal((2, 2)).astype(np.float64), None]}}


def _torch_tree(t):
    return {"w": torch.from_numpy(t["w"]), "b16": torch.from_numpy(t["b16"]).bfloat16(),
            "nested": {"z": torch.from_numpy(t["nested"]["z"]),
                       "a": [torch.from_numpy(t["nested"]["a"][0]), None]}}


def _jax_tree(t):
    return {"w": jnp.asarray(t["w"]), "b16": jnp.asarray(t["b16"]).astype(jnp.bfloat16),
            "nested": {"z": jnp.asarray(t["nested"]["z"]),
                       "a": [np.asarray(t["nested"]["a"][0]), None]}}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    x = np.asarray(x)
    return (x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x).tobytes()


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [] if tree is None else [tree]


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    t = _tree()
    ref_save(str(tmp_path), 7, _jax_tree(t), blocking=True)
    got = restore(str(tmp_path), 7, _torch_tree(t))
    assert got["b16"].dtype == torch.bfloat16 and got["nested"]["a"][1] is None
    assert [_bits(x) for x in _flat(got)] == [_bits(x) for x in _flat(_torch_tree(t))]


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    t = _tree(1)
    save(str(tmp_path), 3, _torch_tree(t), blocking=True)
    got = ref_restore(str(tmp_path), 3, _jax_tree(t))
    assert np.asarray(got["b16"]).dtype == ml_dtypes.bfloat16
    assert [_bits(x) for x in _flat(got)] == [_bits(x) for x in _flat(_jax_tree(t))]
    # and the two packages wrote the same manifest paths and dtypes
    import json
    ref_dir = tmp_path / "ref"
    ref_save(str(ref_dir), 3, _jax_tree(t), blocking=True)
    mine = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    theirs = json.loads((ref_dir / "step_00000003" / "manifest.json").read_text())
    for key in ("paths", "shapes", "dtypes", "step"):
        assert mine[key] == theirs[key], key


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2, keep=2)
    tree = {"p": torch.arange(4.0)}
    saved = [s for s in range(1, 9) if mgr.maybe_save(s, tree)]
    mgr.wait()
    assert saved == [2, 4, 6, 8]
    assert list_steps(str(tmp_path)) == [6, 8] and latest_step(str(tmp_path)) == 8
    assert torch.equal(restore(str(tmp_path), 8, tree)["p"], tree["p"])
    with pytest.raises(ValueError, match="leaves"):
        restore(str(tmp_path), 8, {"p": tree["p"], "q": tree["p"]})


# ---------------------------------------------------------------------------
# functional mode and the fidelity-switching checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    cfg = C.get("lenet").smoke
    model = LeNet(cfg, conv_algo="gemm", device="cpu")
    batches = [(torch.from_numpy(b["images"]), torch.from_numpy(b["labels"]).long())
               for b in itertools.islice(synthetic_mnist_batches(cfg, batch=8, seed=0), 4)]
    cap = Simulator(hw=H100).capture(lambda p, a, b: sgd_step(model, p, a, b, 0.05),
                                     model.param_dict(), *batches[0])
    return model, batches, cap


def test_run_functional_threads_the_carry(smoke):
    model, batches, _ = smoke
    x, y = batches[0]
    res = run_functional(lambda p, a, b: sgd_step(model, p, a, b, 0.05),
                         model.param_dict(), x, y, steps=3)
    assert res.steps == 3 and res.wall_seconds > 0
    p = model.param_dict()
    for _ in range(3):
        p = sgd_step(model, p, x, y, 0.05)[0]
    for k in p:
        assert torch.equal(res.outputs[0][k], p[k])


def test_simulate_from_checkpoint(smoke, tmp_path):
    model, batches, cap = smoke

    def step(state, batch):
        new, loss, _ = sgd_step(model, state, *batch, 0.05)
        return new, loss

    out = simulate_from_checkpoint(step, model.param_dict(), iter(batches), cap,
                                   fast_forward=2, checkpoint_dir=str(tmp_path))
    assert out.fast_forward_steps == 2 and out.fast_forward_seconds > 0
    assert list_steps(str(tmp_path)) == [2]
    back = restore(str(tmp_path), 2, out.state)
    assert all(torch.equal(back[k], out.state[k]) for k in back)
    full = Engine(H100).simulate(cap.module)
    assert out.report.summary() == full.summary()
    assert out.perf_over_functional > 0
    win = simulate_from_checkpoint(step, model.param_dict(), iter(batches), cap,
                                   window=(0, 20))
    assert win.report.total_flops == pytest.approx(full.total_flops, rel=1e-2)
    assert win.perf_over_functional == float("inf")
