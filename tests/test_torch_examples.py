"""The port's three LM examples (``examples/{quickstart,train_lm,serve_llm}.py``
as modules of ``repro_torch``) run end to end on the CPU, as a user runs
them, each in a subprocess with a timeout."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", module, "--device", "cpu", *args],
                         capture_output=True, text=True, timeout=240, env=env)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return res.stdout


def test_quickstart_trains_captures_and_simulates():
    out = _run("repro_torch.quickstart")
    for section in ("== 1. train", "== 2. capture", "== 3. performance-simulate on h100",
                    "== 4. AerialVision", "== 5. power breakdown"):
        assert section in out
    assert re.search(r"loss: [\d.]+ -> [\d.]+  checkpoints=2", out)
    assert re.search(r"modeled step time: [\d.]+ ms", out)
    assert "TOTAL," in out


def test_train_lm_restarts_after_an_injected_failure():
    out = _run("repro_torch.train_lm", "--steps", "7", "--batch", "2", "--seq", "32",
               "--fail-at", "5")
    m = re.search(r"steps=(\d+) restarts=(\d+) checkpoints=(\d+) final=([\d.]+)", out)
    assert m, out
    steps, restarts, checkpoints = int(m[1]), int(m[2]), int(m[3])
    # steps 0-4, the failure at 5, then 4-6 again from the step-4 checkpoint
    assert restarts == 1 and steps == 5 + 3 and checkpoints >= 1


@pytest.mark.parametrize("args", [()], ids=["defaults"])
def test_serve_llm_generates_and_simulates_a_decode_step(args):
    out = _run("repro_torch.serve_llm", *args)
    rows = re.findall(r"request \d: \[([\d, ]+)\]", out)
    assert len(rows) == 4 and all(len(r.split(",")) == 12 for r in rows)
    assert re.search(r"modeled decode step: [\d.]+ us", out)
