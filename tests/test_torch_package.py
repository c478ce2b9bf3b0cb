"""The port's independence and device rules: ``repro_torch`` and
``chip_smoke.py`` never import ``jax`` or ``repro``, entry points default to
CUDA and raise without it, a kernel wrapper never falls back to its plain
version on a CUDA tensor, and every launcher binds, launches, checks and
counts through one seam (``kernels/dispatch.py``)."""
import ast
import ctypes
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import repro_torch
from repro_torch import config as C
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import Entry, counted, launch, use_kernel
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.tiled_matmul import tiled_matmul
from repro_torch.kernels.winograd import winograd_conv, winograd_tiles
from repro_torch.launch import serve
from repro_torch.models.lenet import LeNet
from repro_torch.models.transformer import DecoderLM
from repro_torch.obs import regions
from repro_torch.runtime import jit

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


#: the modules of the training slice (and its configs), which the import
#: test above must cover
TRAINING_SLICE = ("repro_torch.configs.qwen15_4b", "repro_torch.configs.gemma3_12b",
                  "repro_torch.configs.gemma3_27b", "repro_torch.optim",
                  "repro_torch.optim.adamw", "repro_torch.optim.schedule",
                  "repro_torch.data.pipeline", "repro_torch.runtime.failure",
                  "repro_torch.runtime.trainer", "repro_torch.runtime.steps",
                  "repro_torch.launch.train")


def test_the_import_block_covers_the_training_slice():
    assert set(TRAINING_SLICE) <= set(_modules())


#: the modules of the distributed slice and the three LM examples, which the
#: import test above must cover
DISTRIBUTED_SLICE = ("repro_torch.distributed", "repro_torch.distributed.mesh",
                     "repro_torch.distributed.sharding", "repro_torch.distributed.compression",
                     "repro_torch.distributed.pipeline", "repro_torch.launch.mesh",
                     "repro_torch.launch.dryrun", "repro_torch.quickstart",
                     "repro_torch.train_lm", "repro_torch.serve_llm")


def test_the_import_block_covers_the_distributed_slice():
    assert set(DISTRIBUTED_SLICE) <= set(_modules())


#: the fleet layers and their CLIs, which the import test above must cover
FLEET_SLICE = tuple(f"repro_torch.{m}" for m in (
    "cluster", "cluster.__main__", "cluster.devices", "cluster.events", "cluster.export",
    "cluster.scheduler", "cluster.workload", "faults", "faults.pricing", "faults.processes",
    "faults.reroute", "validate", "validate.__main__", "validate.fitting", "validate.ingest",
    "validate.queueing", "obs.__main__", "obs.detectors", "obs.diff", "obs.doctor",
    "obs.manifest", "obs.sentinel", "obs.stats", "obs.timelapse", "obs.whatif",
    "cluster_quickstart"))


def test_the_import_block_covers_the_fleet_slice():
    assert set(FLEET_SLICE) <= set(_modules())


def test_every_reference_module_but_the_jax_shim_has_its_counterpart():
    ref = {p.relative_to(ROOT / "src" / "repro") for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(PKG) for p in PKG.rglob("*.py")}
    assert ref - port == {Path("distributed") / "_compat.py"}


def test_example_entry_points_need_cuda(monkeypatch):
    from repro_torch import quickstart, serve_llm, train_lm
    from repro_torch.distributed.mesh import build_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (quickstart.main, serve_llm.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="process group"):
        build_mesh(C.SMOKE_MESH)


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


def test_serving_entry_points_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    smoke = C.get("llama3-8b").smoke
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecoderLM(smoke).init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3-8b", "--smoke"])
    assert DecoderLM(smoke).init(device="cpu")["embed"].device.type == "cpu"


def test_training_entry_points_need_cuda(monkeypatch, tmp_path):
    from repro_torch.launch import train
    from repro_torch.runtime.steps import init_train_state
    from repro_torch.runtime.trainer import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = C.RunConfig(model=C.get("qwen1.5-4b").smoke,
                     shape=C.ShapeConfig("t", 16, 2, "train"), mesh=C.SMOKE_MESH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(rc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(rc, use_mesh=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen1.5-4b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


def test_serve_module_without_device_fails_without_a_gpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "llama3-8b", "--smoke"], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "generated" not in out.stdout


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
    kernels = (tiled_matmul, winograd_conv, winograd_tiles, flash_attention_fwd)
    before = [k.launches for k in kernels]
    with pytest.raises(ValueError, match="CUDA"):
        tiled_matmul(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        winograd_conv(torch.zeros(1, 4, 4, 2), torch.zeros(4, 4, 2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        winograd_tiles(torch.zeros(1, 1, 1, 4, 4, 2), torch.zeros(4, 4, 2, 3))
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, q, q)
    assert [k.launches for k in kernels] == before


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


def test_build_kernels_name_every_source():
    assert build.KERNELS == tuple(sorted(p.stem for p in build.CSRC.glob("*.cu")))
    assert {"tiled_matmul", "winograd", "flash_attention", "flash_attention_bwd",
            "ssd_scan"} <= set(build.KERNELS)


class _FakeFn:
    """A C function as ctypes hands it out: typed by attributes, returning
    an error code."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@counted
def _fake_launcher():
    pass


@pytest.fixture
def fake_entry(monkeypatch):
    """An entry point of a fake library, on a fake stream 7 of the card,
    with its loads counted."""
    fn, loads = _FakeFn(), []
    monkeypatch.setattr(build, "load", lambda name: loads.append(name)
                        or SimpleNamespace(repro_fake=fn))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(_fake_launcher, "launches", 0)
    return Entry("fake", "repro_fake", [ctypes.c_int] * 2), fn, loads


def test_an_entry_is_bound_at_its_first_call_only(fake_entry):
    entry, fn, loads = fake_entry
    assert loads == [] and entry.fn is None
    assert entry(1, 2) == 0 and entry(3, 4) == 0
    assert loads == ["fake"] and entry.fn is fn and fn.calls == [(1, 2), (3, 4)]
    assert fn.argtypes == [ctypes.c_int] * 2 and fn.restype is ctypes.c_int


def test_a_launch_runs_on_the_current_stream_and_counts_once(fake_entry):
    entry, fn, _ = fake_entry
    launch(entry, _fake_launcher, torch.device("cuda"), 1, 2, detail=lambda: "")
    assert fn.calls == [(1, 2, 7)] and _fake_launcher.launches == 1


def test_a_failed_launch_raises_naming_the_kernel_and_counts_nothing(fake_entry):
    entry, fn, _ = fake_entry
    fn.rc = 700
    with pytest.raises(RuntimeError, match=r"_fake_launcher launch failed with CUDA "
                                           r"error 700 at q \(1, 2\)"):
        launch(entry, _fake_launcher, torch.device("cuda"), 1, 2,
               detail=lambda: "q (1, 2)")
    assert _fake_launcher.launches == 0


def test_a_launch_in_a_capture_counts_at_each_replay(fake_entry, monkeypatch):
    """A launch made while a compiled step is captured lands in the capture,
    not on the counter; each replay of the graph adds it."""
    entry, _, _ = fake_entry
    cap = regions.Capture("step", 7)
    monkeypatch.setattr(regions, "capturing", lambda: cap)
    for _ in range(3):
        launch(entry, _fake_launcher, torch.device("cuda"), detail=lambda: "")
    assert _fake_launcher.launches == 0 and cap.launches == {_fake_launcher: 3}
    monkeypatch.setattr(regions, "capturing", lambda: None)
    graph = jit.Graph(SimpleNamespace(replay=lambda: None), [], None, cap)
    assert graph.launches == {"_fake_launcher": 3} and graph.launches["other"] == 0
    graph.replay()
    graph.replay()
    assert _fake_launcher.launches == 6


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
