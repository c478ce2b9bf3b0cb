"""What a run loads, in a process of its own: neither JAX nor the JAX
package (``repro``: the port's name begins with it, so top-level names are
compared whole), and for the reference, nothing of the program either."""
import json
import os
import subprocess
import sys

import port_bench_tiny as tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_RUN = r"""
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root / "port_bench")]
import harness
run = harness.run_cell(root, root / "port_bench", sys.argv[2], 7, 0.2, sys.argv[3] == "1", "cpu")
harness.result(run, harness.device_info(run, 1))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import check, reference, traffic, weights, yardstick
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    root = tiny.checkout(tmp_path)
    (root / "src").symlink_to(tiny.ROOT / "src")
    for cell in ("tiny-moe.serve", "tiny-dense.train"):
        loaded = _modules(_RUN, root, cell, 1)
        assert "repro_torch" in loaded
        assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(_REFERENCE, tiny.BENCH)
    assert not loaded & (FORBIDDEN | {"repro_torch"}), loaded & (FORBIDDEN | {"repro_torch"})


def test_the_harness_refuses_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files
    prints no result and exits non-zero."""
    root = tiny.checkout(tmp_path)
    out = subprocess.run([sys.executable, str(root / "port_bench" / "run.py"), "--workload",
                          "tiny-moe.serve", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=root,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
