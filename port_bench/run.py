"""Run one cell of the port's benchmark on this machine's cards.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It makes the cell's inputs and weights from
the seed on the card, warms the cell's own shapes (set-up), measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``,
and the numbers compared beside their limits (``checks``), which also end
standard error.  Without a card, with fewer than the cell asks for, or with
JAX or the JAX package loaded, it prints no result and exits non-zero.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))
# CUDA's JIT cache, were any PTX compiled, stays inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in manifest["workloads"] if w["name"] == args.workload),
                 None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    run = harness.run_cell(ROOT, BENCH, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: no result", file=sys.stderr)
        return 3
    line = harness.result(run, harness.device_info(run, chips))
    harness.print_checks(run)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
