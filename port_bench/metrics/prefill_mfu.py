"""The prefill's share of the bf16 peak: its operations (the yardstick's
count: the last position's head, causal pairs) over the time the server
spent in its prefill phase (``ServeStats.prefill_s``), summed over the
window's calls."""
import yardstick as Y


def read(run):
    calls = run.records.get("calls")
    if not calls:
        return None
    tr = run.traffic
    flops = Y.prefill_flops(run.config, tr["batch"], tr["prompt_len"]) * len(calls)
    return 100.0 * flops / sum(c["prefill_s"] for c in calls) / Y.PEAK_BF16_FLOPS
