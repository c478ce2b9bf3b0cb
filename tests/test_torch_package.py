"""The port's independence and device rules: ``repro_torch`` and
``chip_smoke.py`` never import ``jax`` or ``repro``, entry points default to
CUDA and raise without it, and a kernel wrapper never falls back to its
plain version on a CUDA tensor."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import config as C
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.tiled_matmul import tiled_matmul
from repro_torch.kernels.winograd import winograd_tiles
from repro_torch.models.lenet import LeNet

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_imports_with_jax_and_repro_blocked():
    script = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_lenet_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LeNet(C.get("lenet").smoke)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_dispatch_is_the_device_and_nothing_else():
    cpu = torch.zeros(2)
    assert use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(2, device="meta"))
    # no environment switch exists to force either side
    src = (PKG / "kernels" / "dispatch.py").read_text()
    assert "os.environ" not in src and "getenv" not in src


def test_kernel_wrappers_refuse_cpu_tensors():
    a = torch.zeros(4, 4)
    before = tiled_matmul.launches, winograd_tiles.launches
    with pytest.raises(ValueError, match="CUDA"):
        tiled_matmul(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        winograd_tiles(torch.zeros(1, 1, 1, 4, 4, 2), torch.zeros(4, 4, 2, 3))
    assert (tiled_matmul.launches, winograd_tiles.launches) == before


def test_unknown_block_shape_raises():
    from repro_torch.kernels.tiled_matmul import matmul
    with pytest.raises(ValueError, match="not compiled"):
        matmul(torch.zeros(4, 4), torch.zeros(4, 4), block_m=32, block_n=32,
               block_k=32)


def test_build_fails_loudly_without_nvcc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_build_names_libraries_by_source_hash():
    paths = {build.lib_path(k) for k in build.KERNELS}
    assert len(paths) == len(build.KERNELS)
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.lib_path(name).parent == ROOT / "build" / "repro_torch"


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env, timeout=120)
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    lone = subprocess.run([sys.executable, str(alone)], capture_output=True,
                          text=True, env=env, timeout=120)
    for out in (here, lone):
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_package_doc_names_the_device_rule():
    assert "cuda" in repro_torch.__doc__
