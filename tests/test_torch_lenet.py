"""The port's LeNet against the reference package's, on the same weights.

One set of weights and one batch are made with numpy from a seed and handed
to both packages (``params_from_jax`` is the weight transfer).  Logits,
loss and every gradient must agree for all four conv algorithms.
Tolerance 1e-4 relative / 1e-5 absolute for fp32 math summed in another
order; the fft path is held to 1e-4 absolute, because the two FFT libraries
round differently.  The full config must also learn on the CPU, as the
reference example requires.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as RC
from repro.models import build_model
from repro_torch import config as C
from repro_torch import lenet_repro
from repro_torch.models.conv_algos import ALGOS
from repro_torch.models.lenet import LeNet, params_from_jax, sgd_step


def _np_params(cfg, seed=0):
    """Weights for both packages: the reference's names and layouts."""
    rng = np.random.default_rng(seed)
    specs = build_model(cfg).param_specs()
    return {k: (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in specs.items()}


def _np_batch(cfg, b=8, seed=1):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((b, cfg.image_hw, cfg.image_hw,
                                           cfg.image_c)).astype(np.float32),
            "labels": rng.integers(0, cfg.num_classes, b).astype(np.int32)}


def _tols(algo):
    return dict(rtol=1e-4, atol=1e-4 if algo == "fft" else 1e-5)


@pytest.fixture(scope="module")
def smoke():
    return RC.get("lenet").smoke, C.get("lenet").smoke


@pytest.mark.parametrize("algo", ALGOS)
def test_logits_loss_and_grads_match_jax(algo, smoke):
    jcfg, tcfg = smoke
    params, batch = _np_params(jcfg), _np_batch(jcfg)
    jmodel = build_model(jcfg, conv_algo=algo)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_logits, ((j_loss, j_aux), j_grads) = jax.jit(lambda p, b: (
        jmodel.forward(p, b["images"]),
        jax.value_and_grad(jmodel.loss, has_aux=True)(p, b)))(jparams, jbatch)

    model = LeNet(tcfg, conv_algo=algo, device="cpu")
    tparams = {k: v.requires_grad_() for k, v in params_from_jax(params, tcfg).items()}
    images = torch.from_numpy(batch["images"])
    labels = torch.from_numpy(batch["labels"]).long()
    logits = model.logits(tparams, images)
    loss, aux = model.loss(tparams, {"images": images, "labels": labels})
    grads = torch.autograd.grad(loss, list(tparams.values()))

    tol = _tols(algo)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), **tol)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **tol)
    assert float(aux["accuracy"]) == float(j_aux["accuracy"])
    for (name, _), g in zip(tparams.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[name]),
                                   err_msg=name, **tol)


def test_sgd_step_matches_jax_update(smoke):
    jcfg, tcfg = smoke
    params, batch = _np_params(jcfg, seed=3), _np_batch(jcfg, seed=4)
    jmodel = build_model(jcfg, conv_algo="gemm")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p: jmodel.loss(p, jbatch)[0]))(
        {k: jnp.asarray(v) for k, v in params.items()})
    model = LeNet(tcfg, conv_algo="gemm", device="cpu")
    new, loss, acc = sgd_step(model, params_from_jax(params, tcfg),
                              torch.from_numpy(batch["images"]),
                              torch.from_numpy(batch["labels"]).long(), 0.05)
    for k, v in params.items():
        np.testing.assert_allclose(new[k].numpy(), v - 0.05 * np.asarray(grads[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_loader_copies_weights_into_the_module(smoke):
    jcfg, tcfg = smoke
    params, batch = _np_params(jcfg, seed=5), _np_batch(jcfg)
    model = LeNet(tcfg, conv_algo="implicit", device="cpu")
    model.load_jax_params(params)
    images = torch.from_numpy(batch["images"])
    with torch.no_grad():
        np.testing.assert_array_equal(
            model(images).numpy(),
            model.logits(params_from_jax(params), images).numpy())


def test_params_from_jax_checks_names_and_shapes(smoke):
    jcfg, tcfg = smoke
    params = _np_params(jcfg)
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in params.items() if k != "fb3"}, tcfg)
    bad = dict(params, fc2=params["fc2"].T.copy())
    with pytest.raises(ValueError, match="fc2"):
        params_from_jax(bad, tcfg)
    with pytest.raises(ValueError, match="conv1"):
        params_from_jax(dict(params, conv1=params["conv1"].astype(np.float64)), tcfg)


def test_module_apply_keeps_the_nn_module_contract(smoke):
    """``nn.Module.apply(fn)`` visits the module and returns it."""
    model = LeNet(smoke[1], device="cpu")
    seen = []
    assert model.apply(seen.append) is model
    assert model in seen


def test_full_lenet_learns_on_cpu():
    """The reference example's learning check, through the entry point's
    training loop: accuracy > 0.6 after 60 SGD steps at lr 0.05, batch 128,
    on the gemm (card) path."""
    assert (lenet_repro.STEPS, lenet_repro.BATCH, lenet_repro.LR,
            lenet_repro.CONV_ALGO) == (60, 128, 0.05, "gemm")
    model = lenet_repro.new_model("cpu")
    assert model.cfg == C.get("lenet").full
    out = lenet_repro.train(model, lenet_repro.device_batches(model))
    assert np.isfinite(out["loss"])
    assert out["accuracy"] > 0.6
