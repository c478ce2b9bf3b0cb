"""Whole runs of tiny cells on the CPU: a cell added as files in a copy of
the benchmark is found without an edit, reports its metrics and passes its
comparison; and with the timed path broken underneath, in each way the cell
can be broken, the same run comes out not correct."""
import json

import pytest
import torch

import port_bench_tiny as tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


def _manifest(root):
    return json.loads((root / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_added_as_files_runs_and_reports(root, cell, trace):
    import harness
    run = tiny.run(root, cell, trace=trace)
    line = harness.result(run, harness.device_info(run, 1))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    m = _manifest(root)
    if not trace:
        want = {e["name"] for e in m["end_to_end"]
                if "workloads" not in e or cell in e["workloads"]}
        assert set(line["metrics"]) == want
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        listed = {p["name"] for p in m["per_layer"] if cell in p.get("workloads", [])}
        # the CPU has no device trace: those readers find nothing and stay silent
        assert set(line["metrics"]) <= listed
        assert {"device_idle.decode", "flash_fwd_roofline.prefill"}.isdisjoint(
            k for k, v in line["metrics"].items() if v["value"] == 0)
        assert line["device"]["window_s"] > 0


def _serve_faults():
    from repro_torch.runtime import server, steps

    def unchanged(orig):
        def decode_step(model, params, cache, batch):
            before = {k: v.clone() for k, v in cache.items()}
            logits, _ = orig(model, params, cache, batch)
            for k in ("k", "v"):                              # undo the step's writes
                cache[k].copy_(before[k])
            return logits, before
        return ("decode_step", steps, decode_step)

    def half(orig):
        def prefill_step(model, params, batch):
            b = batch["tokens"].shape[0]
            logits, cache = orig(model, params, {"tokens": batch["tokens"][:b // 2]})
            twice = lambda t: torch.cat([t, t], dim=1) if t.dim() == 5 else t
            return torch.cat([logits, logits]), {k: twice(v) for k, v in cache.items()}
        return ("prefill_step", steps, prefill_step)

    def altered(orig):
        def _sample(self, logits, gen):
            tok = orig(self, logits, gen).clone()
            tok[0] = (tok[0] + 1) % self.run_cfg.model.vocab_size
            return tok
        return ("_sample", server.Server, _sample)

    return {"state unchanged": unchanged, "half the batch": half, "token altered": altered}


def _train_faults():
    from repro_torch.runtime import steps

    def unchanged(orig):
        def adamw_update(state, grads, cfg, lr_fn):
            _, metrics = orig(state._replace(master=_copy(state.master), m=_copy(state.m),
                                             v=_copy(state.v), params=_copy(state.params)),
                              grads, cfg, lr_fn)
            return state, metrics
        return ("adamw_update", steps, adamw_update)

    def half(orig):
        def loss_and_grads(model, params, batch, grads):
            b = batch["tokens"].shape[0]
            return orig(model, params, {k: v[:b // 2] for k, v in batch.items()}, grads)
        return ("loss_and_grads", steps, loss_and_grads)

    def doubled(orig):
        def adamw_update(state, grads, cfg, lr_fn):
            before = state.master["layers"]["attn"]["wq"].clone()
            new, metrics = orig(state, grads, cfg, lr_fn)
            wq = new.master["layers"]["attn"]["wq"]
            wq.add_(wq - before)                                # this leaf's update twice
            new.params["layers"]["attn"]["wq"].copy_(wq)
            return new, metrics
        return ("adamw_update", steps, adamw_update)

    return {"state unchanged": unchanged, "half the batch": half, "answer altered": doubled}


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone()


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(tiny.CELLS)
                                        for f in (("state unchanged", "half the batch",
                                                   "answer altered") if "train" in c else
                                                  ("state unchanged", "half the batch",
                                                   "token altered"))])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    faults = _train_faults() if "train" in cell else _serve_faults()
    name, owner, _ = faults[fault](None)
    orig = getattr(owner, name)
    monkeypatch.setattr(owner, name, faults[fault](orig)[2])
    run = tiny.run(root, cell)
    assert run.correct is False, run.checks
