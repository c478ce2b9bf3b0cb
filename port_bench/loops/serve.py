"""Closed loop over ``Server.generate``: one client sends a batch of
prompts, waits for every token, and sends the next.

Set-up makes the weights from the seed, builds the ``Server`` (its prefill
and decode steps compiled: CUDA graphs on the card), draws the window's
prompts on the card and calls ``generate`` ``warmup_calls`` times on prompts
of the window's shapes (the first call runs both steps eagerly and captures
the decode step, the second captures the prefill).  The window then calls
``generate`` back to back until ``--seconds`` have passed.  Every request is
greedy and runs to ``new_tokens``: the end-of-sequence id lies outside the
vocabulary, so it is never sampled.

The harness times each call itself: from its start to the first decode
step's call, which follows the first token's read to the host (the time to
first token), and to its return (the last token).  A traced run profiles
``trace_calls`` more calls after the window, marking each call's prefill
(its start to the first decode step) and decode (the rest).
"""
from __future__ import annotations

import time

import numpy as np
import torch

import check
import port
import devtrace as TR
import traffic as T
import weights as W
from harness import log, percentile

#: an id no greedy step can return
NEVER_SAMPLED = -1


class _Decode:
    """The server's decode step, with the time of each call's first use."""

    def __init__(self, step, on_first=None):
        self.step = step
        self.first = None
        self.calls = 0
        self.on_first = on_first

    def __call__(self, *args):
        if self.first is None:
            self.first = time.perf_counter()
            if self.on_first is not None:
                self.on_first()
        self.calls += 1
        return self.step(*args)


def run(r) -> None:
    from repro_torch.config import SMOKE_MESH, RunConfig, ShapeConfig
    from repro_torch.runtime.server import Server

    cfg, tr, dev = r.config, r.traffic, r.device
    b, s, n = tr["batch"], tr["prompt_len"], tr["new_tokens"]
    rc = RunConfig(model=port.model_config(cfg), shape=ShapeConfig(r.workload["traffic"], s, b,
                                                                   "prefill"),
                   mesh=SMOKE_MESH)
    port.build_kernels(dev)
    log(r, "kernels built")
    params = W.make(cfg, r.seed, dev)
    port.check_layout(rc.model, params)
    port.sync(dev)
    log(r, "weights made")
    server = Server(rc, params, eos_token=NEVER_SAMPLED, temperature=0.0)
    pool = [T.prompts(tr, cfg, r.seed, i, dev) for i in range(tr["pool_calls"])]
    decode = server._decode = _Decode(server._decode)
    for i in range(tr["warmup_calls"]):
        server.generate({"tokens": T.prompts(tr, cfg, r.seed, tr["pool_calls"] + i, dev)},
                        max_new_tokens=n)
    if r.trace:
        r.tracer = TR.Tracer(dev)
        r.tracer.warm()
    port.sync(dev)
    log(r, "warmed up")

    calls = []

    def call(i):
        st = server.stats
        before = (st.prefill_s, st.decode_s, decode.calls)
        decode.first = None
        t0 = time.perf_counter()
        out = server.generate({"tokens": pool[i % len(pool)]}, max_new_tokens=n)
        t1 = time.perf_counter()
        calls.append({"index": i % len(pool), "t0": t0, "t1": t1,
                      "first": decode.first or t1, "tokens": out,
                      "prefill_s": st.prefill_s - before[0], "decode_s": st.decode_s - before[1],
                      "decode_steps": decode.calls - before[2]})

    start = time.perf_counter()
    r.setup_s = start - r.t0
    i = 0
    while True:
        call(i)
        i += 1
        if calls[-1]["t1"] - start >= r.seconds:
            break
    window = calls[:]
    log(r, f"window closed: {len(window)} calls")
    if r.trace:
        tracer = r.tracer

        def first():
            tracer.leave("prefill")
            tracer.enter("decode")
        decode.on_first = first
        with tracer.segment():
            for _ in range(tr["trace_calls"]):
                tracer.enter("prefill")
                call(i)
                tracer.leave("prefill")
                tracer.leave("decode")
                i += 1
        decode.on_first = None
    r.memory_peak = port.memory_peak(dev)

    took = [c["t1"] - c["t0"] for c in window]
    r.e2e = {"setup_s": r.setup_s,
             "serve_tok_s": sum(c["tokens"].size for c in window) / sum(took),
             "ttft_p95_ms": 1e3 * percentile([c["first"] - c["t0"] for c in window
                                              for _ in range(b)], 95),
             "request_p95_ms": 1e3 * percentile([t for t in took for _ in range(b)], 95)}
    r.records["calls"] = window
    r.attempted = b * len(calls)
    # a request fails that is cut short or returns an id outside the vocabulary
    r.failed = sum(b if c["tokens"].shape != (b, n) else
                   int(((c["tokens"] < 0) | (c["tokens"] >= cfg["vocab_size"])).any(axis=1).sum())
                   for c in calls)

    # the check, with the program's state freed
    server = decode = params = None
    port.free(dev)
    served = [(c, row) for c in calls for row in range(b)]
    pick = check.sample_requests([c["tokens"].shape[1] for c, _ in served],
                                 tr["check_requests"], r.seed)
    prompts = torch.stack([pool[served[j][0]["index"]][served[j][1]] for j in pick])
    tokens = np.stack([served[j][0]["tokens"][served[j][1]] for j in pick])
    ref = check.serve_reference(cfg, r.seed, prompts, tokens, dev)
    gaps = check.gaps(ref, torch.as_tensor(tokens))
    log(r, f"reference done over {len(pick)} requests")
    r.records["check"] = {"prompts": prompts, "tokens": tokens, "ref_logits": ref,
                          "gaps": gaps}
    r.check("logit_gap", float(gaps.max()))
