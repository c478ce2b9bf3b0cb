"""The MoE's routing overhead in the traced prefills: the device time of
the regions ``moe.route``, ``moe.dispatch`` and ``moe.combine`` over the
prefill replays' device time (their kernels', copies' and fills' summed
time), each whole replay launched in a prefill phase put down to the
prefill graph's regions (``replays.py``).  A program that records no
regions gives nothing."""
import replays as RP

OVERHEAD = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    secs = RP.phase_seconds(trace, "prefill", "prefill") if trace is not None else None
    if not secs or not sum(secs.values()):
        return None
    return 100.0 * sum(secs.get(r, 0.0) for r in OVERHEAD) / sum(secs.values())
