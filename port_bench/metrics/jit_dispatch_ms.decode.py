"""The compiled decode step's dispatch in the traced calls: the mean of
the program's ``jit.dispatch`` spans (the flatten, the signature, the
input checks and copies, up to the launch) inside its
``server.decode_step`` spans, as the profiler recorded them on the host; a
program without these spans gives nothing."""


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    if trace is None:
        return None
    steps = [(s, e) for name, s, e in trace.host if name == "repro.server.decode_step"]
    times = [e - s for name, s, e in trace.host if name == "repro.jit.dispatch"
             and any(lo <= s and e <= hi for lo, hi in steps)]
    if not times:
        return None
    return sum(times) / len(times) / 1e6
