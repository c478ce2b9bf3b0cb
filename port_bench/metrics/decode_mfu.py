"""The decode steps' share of the bf16 peak: their operations (every
valid key of each step) over the time the server spent decoding
(``ServeStats.decode_s``), summed over the window's calls."""
import yardstick as Y


def read(run):
    calls = run.records.get("calls")
    if not calls:
        return None
    tr = run.traffic
    flops = Y.generate_decode_flops(run.config, tr["batch"], tr["prompt_len"],
                                    tr["new_tokens"]) * len(calls)
    return 100.0 * flops / sum(c["decode_s"] for c in calls) / Y.PEAK_BF16_FLOPS
