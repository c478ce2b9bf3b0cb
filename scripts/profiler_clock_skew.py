"""How far ``torch.profiler`` stamps a kernel from the host call that
launched it, near the start of a profile.

Each trial opens a profile and launches six small kernels, three at once and
three after a pause of 0.1, 1 and 10 ms.  For each kernel it prints the
kernel's start minus the start of its launching call (matched by correlation
id), in microseconds, and how many of the six the profile kept.  A kernel
cannot start before its launch, so a negative value is the error of the
profiler's mapping of the card's clock onto the host's; work it stamps before
its window opens is dropped, which is why ``repro_torch.core.correlate.
profile_runs`` keeps the measured calls away from the profile's edges.

Two modes: ``plain`` (the profile starts at ``__enter__``) and ``schedule``
(one warm-up step, then one recorded step).  Run on a machine with a card:

    python scripts/profiler_clock_skew.py [--trials 8]
"""
import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

DELAYS = (0, 0, 0, 1e-4, 1e-3, 1e-2)


def trial(x, mode):
    cpu = torch.autograd.DeviceType.CPU
    kwargs = {"activities": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    if mode == "schedule":
        kwargs["schedule"] = schedule(wait=0, warmup=1, active=1, repeat=1)
    torch.cuda.synchronize()
    with profile(**kwargs) as prof:
        if mode == "schedule":
            x.fill_(0)
            torch.cuda.synchronize()
            prof.step()
        for d in DELAYS:
            time.sleep(d)
            with record_function(f"launch after {d} s"):
                x.add_(1)
        torch.cuda.synchronize()
        if mode == "schedule":
            prof.step()
    events = prof.events()
    launched_at = {e.id: e.time_range.start for e in events
                   if e.device_type == cpu and e.name.startswith("cu")}
    kernels = sorted((launched_at[e.id], e.time_range.start) for e in events
                     if e.device_type != cpu and e.id in launched_at
                     and not getattr(e, "is_user_annotation", False)
                     and not e.name.startswith("launch after"))
    return len(kernels), [round(k - l, 1) for l, k in kernels]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=8)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_clock_skew: no CUDA device")
    x = torch.zeros(1024, device="cuda")
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    for mode in ("plain", "schedule"):
        worst = 0.0
        for i in range(args.trials):
            kept, skew = trial(x, mode)
            worst = min([worst] + skew)
            print(f"{mode} trial {i}: kept {kept} of {len(DELAYS)}; kernel start - "
                  f"launch (us): {skew}")
        print(f"{mode}: most negative {worst} us")


if __name__ == "__main__":
    main()
