"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see 1 device;
only launch/dryrun.py forces the 512-device host platform."""
import jax
import jax.numpy as jnp
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels have "
                   "no CPU mode); skips without one")


def pytest_addoption(parser):
    parser.addoption(
        "--update-golden", action="store_true", default=False,
        help="rewrite tests/golden/*.json snapshots from the current "
             "engine instead of diffing against them (review the diff "
             "before committing — the snapshots ARE the known-good numbers)")


@pytest.fixture
def update_golden(request):
    """True when the run should rewrite golden snapshots."""
    return request.config.getoption("--update-golden")


@pytest.fixture(scope="session")
def rng():
    return jax.random.key(0)


def tiny_lm_batch(cfg, b=2, s=16, seed=1):
    tokens = jax.random.randint(jax.random.key(seed), (b, s), 0, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.frontend != "none":
        batch["frontend_emb"] = jax.random.normal(
            jax.random.key(seed + 1), (b, cfg.frontend_seq, cfg.d_model),
            jnp.bfloat16)
    return batch
