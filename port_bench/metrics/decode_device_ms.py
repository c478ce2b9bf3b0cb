"""The decode graph's device time a step in the traced calls: from the end
of the marker the program launches before a replay to the start of those
it launches after, the mean over the whole replays launched in a decode
phase that hold the decode graph's node count (``replays.py``; a replay
the profiler cut is left out).  A program that marks no replays gives
nothing."""
import replays as RP


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    got = RP.phase_replays(trace, "decode", "decode") if trace is not None else None
    if not got or not got[1]:
        return None
    return 1e3 * sum(r.elapsed_s for r in got[1]) / len(got[1])
