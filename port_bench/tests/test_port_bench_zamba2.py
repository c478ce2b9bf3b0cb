"""The published Zamba2's benchmark files on the CPU at a tiny size: its
weights tree is the port's, leaf for leaf; its reference loads nothing of
the program; its yardstick counts each matrix product once a token; and a
tiny cell of it, added as files, runs through ``loops/serve_hybrid.py``
(``loops/serve.py`` with the configuration's own modules bound in) and
passes its comparison."""
import json
import shutil

import pytest
import torch

import port_bench_tiny as tiny
import zamba2_tiny as zt
import zamba2_port
import zamba2_weights as ZW
import zamba2_yardstick as ZY

SEED = 4_294_967_311
CELL = "tiny-zamba2.serve"
REAL = "zamba2-7b-instruct.serve.doc4k"


def test_weights_tree_is_the_ports_and_draws_again_the_same():
    tree = ZW.make(zt.TINY, SEED, "cpu")
    zamba2_port.check_layout(zamba2_port.model_config(zt.TINY), tree)
    for path, idx, _, _ in ZW.leaves(zt.TINY):
        assert torch.equal(ZW.get(tree, path, idx), ZW.draw_leaf(zt.TINY, SEED, path, idx, "cpu"))
    layers = tree["layers"]["mixer"]
    assert torch.equal(layers["a_log"][0].exp(), torch.arange(1.0, 5.0))
    assert (layers["d_skip"] == 1).all() and not torch.equal(layers["dt_bias"][0],
                                                              layers["dt_bias"][1])
    wrong = dict(tree, points={k: v[:2] for k, v in tree["points"].items()})
    with pytest.raises(ValueError, match="not the port's tree"):
        zamba2_port.check_layout(zamba2_port.model_config(zt.TINY), wrong)


def test_the_reference_and_yardstick_load_nothing_of_the_program():
    import os
    import subprocess
    import sys
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import zamba2_check, zamba2_reference, zamba2_weights, zamba2_yardstick; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(tiny.BENCH)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_program_refuses_keys_it_does_not_implement():
    with pytest.raises(ValueError, match="does not take"):
        zamba2_port.model_config(dict(zt.TINY, hidden_act="silu"))


def test_the_yardstick_counts_each_product_once_a_token():
    """Two operations a weight of every matrix a token passes through, as
    the port's own tree has them; the full prefill at the cell's shape is
    about 23 GFLOP a token."""
    from repro_torch.models import build_model
    mc = zamba2_port.model_config(zt.FULL)
    specs = build_model(mc).param_specs()
    mixer = specs["layers"]["mixer"]
    n = lambda s: s.shape[1] * s.shape[2]  # noqa: E731  (one slice of a stack)
    assert ZY.mamba_proj_flops_per_token(zt.FULL) == 2 * (n(mixer["in_proj"])
                                                          + n(mixer["out_proj"]))
    block, point = specs["blocks"], specs["points"]
    mats = [block["attn"][w] for w in ("wq", "wk", "wv", "wo")] + \
        [block["mlp"][w] for w in ("w_gate_up", "w_down")] + list(point.values())
    assert ZY.shared_flops_per_token(zt.FULL) == 2 * sum(n(s) for s in mats)
    per_token = ZY.prefill_flops(zt.FULL, 4, 4088) / (4 * 4088)
    assert 22e9 < per_token < 24e9


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.checkout(tmp_path_factory.mktemp("checkout"))
    bench = root / tiny.BENCH.name
    (bench / "configs" / "tiny-zamba2.json").write_text(json.dumps(zt.TINY))
    traffic = dict(tiny.SERVE, loop="serve_hybrid", prompt_len=20)
    (bench / "traffic" / "tiny.serve_hybrid.json").write_text(json.dumps(traffic))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-zamba2", "source": "tests", "reduced": [],
                                "file": f"{tiny.BENCH.name}/configs/tiny-zamba2.json",
                                "why": "tests"})
    manifest["workloads"].append({"name": CELL, "config": "tiny-zamba2",
                                  "traffic": "tiny.serve_hybrid", "chips": 1, "why": "tests"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copy(bench / "limits" / f"{REAL}.json", bench / "limits" / f"{CELL}.json")
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_runs_through_the_hybrid_loop_and_passes(root, trace):
    import harness
    run = tiny.run(root, CELL, trace=trace)
    line = harness.result(run, harness.device_info(run, 1))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    if not trace:
        assert set(line["metrics"]) == {"setup_s", "serve_tok_s", "ttft_p95_ms",
                                        "request_p95_ms"}
    else:
        # the CPU has no device trace: the device readers stay silent
        assert "prefill_mfu.hybrid" in line["metrics"]
        assert {"ssm_scan_share.prefill", "shared_block_share.prefill",
                "flash_fwd_roofline.prefill_d224"}.isdisjoint(line["metrics"])


def _replay(t0, durs, names):
    """One replay's device events between its markers (one before, two
    after), from t0 (ns); and the time after it."""
    evs, t = [("spin_kernel", t0, t0 + 1)], t0 + 2
    for n, d in zip(names, durs):
        evs.append((n, t, t + d))
        t += d + 1
    return evs + [("spin_kernel", t, t + 1), ("spin_kernel", t + 2, t + 3)], t + 4


def test_the_hybrid_readers_find_prefill_replays_by_their_node_count():
    """Two prefill replays (4 nodes) around decode replays (2 nodes), the
    device's stamps drifting from the host's by more than the pairing of
    replays with their launches allows: the pairing finds nothing, the
    readers read the prefill replays by their count."""
    from types import SimpleNamespace

    import devtrace as TR
    import replays as RP
    from repro_torch.obs import regions
    from repro_torch.obs.regions import RegionTable
    flash = "void attn_wgmma_kernel<__nv_bfloat16, 224, false>(CUtensorMap_st)"
    names = ("scan", flash, "mlp", "head")
    pre1, t = _replay(1_000, [400, 100, 200, 50], names)
    dec1, t = _replay(t + 10, [5, 5], ("a", "b"))
    dec2, t = _replay(t + 10, [5, 5], ("a", "b"))
    pre2, t = _replay(t + 10, [400, 100, 200, 50], names)
    device = pre1 + dec1 + dec2 + pre2
    starts = [evs[0][1] for evs in (pre1, dec1, dec2, pre2)]
    drift = [0, 0, 0, 300]                       # over half the 24 ns between two launches
    host = [("repro.jit.replay", s - 2 - d, s - 1 - d) for s, d in zip(starts, drift)]
    trace = TR.Trace((0, t), device, {"bench.prefill": [(0, t)]}, host)
    n = len(regions.TABLES)
    regions.TABLES.extend([
        RegionTable("prefill", 4, (("ssm.scan", 0, 1, 1), ("shared.block", 1, 3, 1),
                                   ("attn.flash_fwd", 1, 2, 2), ("ssm.mixer", 0, 1, 0))),
        RegionTable("decode", 2, ())])
    try:
        run = SimpleNamespace(tracer=SimpleNamespace(trace=trace), config=zt.FULL,
                              traffic={"batch": 4, "prompt_len": 4088})
        assert RP.phase_seconds(trace, "prefill", "prefill") is None
        import harness
        read = {m: harness.load_module(tiny.BENCH / "metrics" / f"{m}.py", m.replace(".", "_")).read
                for m in ("ssm_scan_share.prefill", "shared_block_share.prefill",
                          "flash_fwd_roofline.prefill_d224")}
        assert read["ssm_scan_share.prefill"](run) == pytest.approx(100 * 400 / 750)
        assert read["shared_block_share.prefill"](run) == pytest.approx(100 * 300 / 750)
        import yardstick as Y
        bound = Y.flash_fwd_bound_s(4, 32, 32, 4088, 4088, 224)
        assert read["flash_fwd_roofline.prefill_d224"](run) == pytest.approx(
            100 * bound * 2 / (200 / 1e9))
    finally:
        del regions.TABLES[n:]
