"""The Mamba2 scans' share of the traced prefills: the device time of the
region ``ssm.scan`` (the chunk loop of every layer's scan) over the prefill
replays' device time, each whole prefill replay put down to the prefill
graph's regions (``zamba2_trace.py``).  A program that records no such
region gives nothing."""
import zamba2_trace as ZT


def read(run):
    secs = ZT.prefill_seconds(run)
    if not secs or "ssm.scan" not in secs or not sum(secs.values()):
        return None
    return 100.0 * secs["ssm.scan"] / sum(secs.values())
