"""The training step's share of the bf16 peak: three times the forward's
operations, no recompute, over the window's time a step."""
import yardstick as Y


def read(run):
    steps = run.records.get("steps")
    if not steps:
        return None
    tr = run.traffic
    secs = (steps[-1]["t1"] - steps[0]["t0"]) / len(steps)
    return 100.0 * Y.train_step_flops(run.config, tr["batch"], tr["seq_len"]) / secs \
        / Y.PEAK_BF16_FLOPS
