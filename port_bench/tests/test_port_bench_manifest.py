"""The manifest (``BENCHMARK.json``) against the benchmark's contract: its
keys, every name and unit against the allowed characters, every file found
by name, and the check's time budget."""
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion",
               "experts_per_tok")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in MANIFEST["command"]:
        assert _line(word)
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_lines():
    items = (MANIFEST["configs"] + MANIFEST["workloads"] + MANIFEST["end_to_end"]
             + MANIFEST["per_layer"])
    for it in items:
        assert NAME.match(it["name"]), it["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [it["name"] for it in MANIFEST[group]]
        assert len(names) == len(set(names)), group
    metric_names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
    for c in MANIFEST["configs"]:
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
    for m in MANIFEST["per_layer"]:
        assert _line(m["layer"])


def test_configs_files_and_reduced_keys():
    assert 1 <= len(MANIFEST["configs"]) <= 24
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")) or key == "vocab_size"
            assert not any(w in key for w in WIDTH_WORDS), key


def test_workloads():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def _reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_metrics():
    e2e, per_layer = MANIFEST["end_to_end"], MANIFEST["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in e2e:
        assert set(m) <= METRIC_KEYS | {"bound"} and {"bound"} <= set(m)
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cells
    e2e_names = {m["name"] for m in e2e}
    layers = {}
    for m in per_layer:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e_names
        assert set(m.get("workloads", [])) <= cells
        moved = next(e for e in e2e if e["name"] == m["moves"])
        for cell in m.get("workloads", []):
            assert _reported(moved, cell), (m["name"], cell)
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        reported = [m for m in e2e if _reported(m, cell)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m.get("workloads", []) for m in per_layer)
        # a kernel's roofline that moves a metric has a whole-step share beside it
        for m in per_layer:
            if "_roofline" in m["name"] and cell in m.get("workloads", []):
                assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                           and cell in o.get("workloads", []) for o in per_layer)


def test_check_fits_its_time():
    """2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s of compiling a
    cell and 1200 s spare, for the full 24 cells, inside 43200 s."""
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_has_limits_for_its_loop(cell):
    w = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    want = {"serve": {"logit_gap"}, "train": {"loss_gap", "grad_gap", "change_gap"}}
    assert set(limits) == want[traffic["loop"]]
    assert (BENCH / "loops" / f"{traffic['loop']}.py").is_file()
    for lim in limits.values():
        assert lim["limit"] > 0
