"""The share of the traced calls' decode phases (host ranges) in which no
kernel, copy or fill ran on the card."""


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    share = trace.idle_share("decode") if trace is not None else None
    return None if share is None else 100.0 * share
