"""The time a traced training step waited for its batch, as the program
records it: the mean of its ``data.wait`` spans (``DataPipeline.__next__``)
inside the traced steps; a program without the span gives nothing."""
import devtrace as TR


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    if trace is None:
        return None
    steps = trace.ranges.get(TR.PREFIX + "step", [])
    times = [e - s for name, s, e in trace.host if name == "repro.data.wait"
             and any(lo <= s < hi for lo, hi in steps)]
    if not times:
        return None
    return sum(times) / len(times) / 1e6
