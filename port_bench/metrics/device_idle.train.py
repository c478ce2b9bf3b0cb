"""The share of the traced training steps (host ranges, from the batch's
fetch to the loss on the host) in which no kernel, copy or fill ran on the
card."""


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    share = trace.idle_share("step") if trace is not None else None
    return None if share is None else 100.0 * share
