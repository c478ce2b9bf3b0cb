"""On the card, at each cell's own size: the control (the reference in the
program's place, computed in float8) fails the cell's comparison on three
seeds, where the program passes it; so does the reference with its
products' operands alone in float8, and for training half of each batch
left out.  Run with ``python -m pytest -m cuda port_bench/tests``
on a machine with an H100; each cell takes some minutes."""
import json
import subprocess
import sys

import pytest

import port_bench_tiny as tiny

SEEDS = "2147483659,3221225473,4294967311"
CELLS = [w["name"] for w in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(card, cell):
    out = subprocess.run([sys.executable, str(tiny.BENCH / "control.py"), "--workload", cell,
                          "--seeds", SEEDS, "--control-seeds", SEEDS], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-3000:]
    readings = json.loads(out.stdout.strip().splitlines()[-1])["readings"]
    limits = json.loads((tiny.BENCH / "limits" / f"{cell}.json").read_text())
    for seed, one in readings.items():
        assert all(one[k] <= lim["limit"] for k, lim in limits.items()), (seed, one)
        for fault in ("control", "fp8_products", "half_batch"):
            found = [one[f"{fault}.{k}"] > lim["limit"] for k, lim in limits.items()
                     if f"{fault}.{k}" in one]
            assert not found or any(found), (seed, fault, one)
        assert any(f"control.{k}" in one for k in limits)
