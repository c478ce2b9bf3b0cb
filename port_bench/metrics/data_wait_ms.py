"""The time a training step waited in ``next(data)`` for its batch, mean
over the window's steps."""


def read(run):
    steps = run.records.get("steps")
    if not steps:
        return None
    return 1e3 * sum(s["fetched"] - s["t0"] for s in steps) / len(steps)
