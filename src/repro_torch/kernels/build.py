"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every kernel is one ``csrc/<name>.cu`` with a plain C interface.  It is
compiled at first use for ``sm_90a`` into ``build/repro_torch/`` at the
root of the checkout (the file name carries a hash of the source, of the
``csrc`` headers it includes and of the compiler and link flags, so an
edited source, header or flag is rebuilt), then loaded with :mod:`ctypes`.
Nothing is compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: every library, one a source: ``csrc/<name>.cu``
KERNELS: Tuple[str, ...] = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: libraries linked beyond the CUDA runtime (the TMA encoder is fetched
#: through the runtime, so none)
LINK_FLAGS: Tuple[str, ...] = ()
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(path: Path, seen: Dict[Path, bytes]) -> Dict[Path, bytes]:
    """``path`` and every file under ``CSRC`` that it includes, transitively."""
    if path not in seen:
        seen[path] = text = path.read_bytes()
        for inc in _INCLUDE.findall(text.decode()):
            dep = (path.parent / inc).resolve()
            if dep.is_file() and CSRC.resolve() in dep.parents:
                _sources(dep, seen)
    return seen


def lib_path(name: str) -> Path:
    """The library's path: its name carries a digest of the source, the
    ``csrc`` headers it includes, and the compiler and link flags."""
    h = hashlib.sha256()
    for path, text in sorted(_sources((CSRC / f"{name}.cu").resolve(), {}).items()):
        h.update(path.name.encode() + b"\0" + text + b"\0")
    h.update("\0".join(NVCC_FLAGS + ("--",) + LINK_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, all in parallel.

    Returns ``{name: seconds}`` (0.0 for a kernel already built).  The
    compiler's ``-Xptxas -v`` report (registers, shared memory, spills) is
    kept beside each library as ``<lib>.log``.  Raises with the compiler's
    output on any failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *LINK_FLAGS]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler report of the built kernel (empty if it has none)."""
    log = lib_path(name).with_name(lib_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def sass(name: str) -> str:
    """The built library's machine code (``cuobjdump -sass``), by function."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path(name))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {name}: {out.stderr.strip()}")
    return out.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
