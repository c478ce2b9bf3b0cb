"""The published Zamba2's prefill share of the bf16 peak: its operations
(:mod:`zamba2_yardstick`'s count: the Mamba2 projections and chunked scan,
the shared blocks with their adapters and linears, causal pairs, the last
position's head) over the time the server spent in its prefill phase
(``ServeStats.prefill_s``), summed over the window's calls."""
import yardstick as Y
import zamba2_yardstick as ZY


def read(run):
    calls = run.records.get("calls")
    if not calls:
        return None
    tr = run.traffic
    flops = ZY.prefill_flops(run.config, tr["batch"], tr["prompt_len"]) * len(calls)
    return 100.0 * flops / sum(c["prefill_s"] for c in calls) / Y.PEAK_BF16_FLOPS
