"""The server's time a decode step: ``ServeStats.decode_s`` over the decode
steps called, summed over the window's calls (a step's sampling and its
token's read to the host included)."""


def read(run):
    calls = run.records.get("calls")
    steps = sum(c["decode_steps"] for c in calls or [])
    if not steps:
        return None
    return 1e3 * sum(c["decode_s"] for c in calls) / steps
