"""The attention backward's share of the traced training steps' replays:
the device time of the region ``attn.bwd`` (the flash op's backward,
``attention_ref`` recomputed and differentiated) over the step replays'
device time (their kernels', copies' and fills' summed time), each whole
replay launched in a traced step put down to the step graph's regions
(``replays.py``).  A program that records no regions gives nothing."""
import replays as RP


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    secs = RP.phase_seconds(trace, "train", "step") if trace is not None else None
    if not secs or not sum(secs.values()):
        return None
    return 100.0 * secs.get("attn.bwd", 0.0) / sum(secs.values())
