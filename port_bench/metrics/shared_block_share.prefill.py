"""The shared blocks' share of the traced prefills: the device time of the
regions ``shared.block`` (the concatenation, norms, q/k/v/o, RoPE, the MLP
with its adapter and the point's linear) and ``attn.flash_fwd`` (the flash
call nested in it) over the prefill replays' device time, each whole
prefill replay put down to the prefill graph's regions
(``zamba2_trace.py``).  A program that records no such region gives
nothing."""
import zamba2_trace as ZT

REGIONS = ("shared.block", "attn.flash_fwd")


def read(run):
    secs = ZT.prefill_seconds(run)
    if not secs or "shared.block" not in secs or not sum(secs.values()):
        return None
    return 100.0 * sum(secs.get(r, 0.0) for r in REGIONS) / sum(secs.values())
