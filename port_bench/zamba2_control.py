"""The readings the published Zamba2's limits are set from
(:mod:`control`'s serving readings, run unchanged with the configuration's
own modules): the program's sound runs over many seeds, and over a few of
them the reference computed in float8 e4m3 (``control``) and with its
products' operands alone in float8 (``fp8_products``), each held to the fp32
reference by ``logit_gap``.

    python3 port_bench/zamba2_control.py --workload zamba2-7b-instruct.serve.doc4k \\
        --seeds 1,2,... --control-seeds 1,2,3 [--out readings.json]

:mod:`control` imports ``check``, ``port`` and ``weights`` where it reads;
this script, a process of its own, has those names stand for
:mod:`zamba2_check`, :mod:`zamba2_port` and :mod:`zamba2_weights` first.
Prints one JSON object, as :mod:`control` does.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

import control  # noqa: E402
import harness  # noqa: E402
import zamba2_check  # noqa: E402
import zamba2_port  # noqa: E402
import zamba2_weights  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    lower = {int(x) for x in args.control_seeds.split(",") if x}
    sys.modules.update(check=zamba2_check, port=zamba2_port, weights=zamba2_weights)
    r = harness.prepare(ROOT, BENCH, args.workload, seeds[0], 0.0, False, "cuda", T0)
    out = {"workload": args.workload, "readings": control.serve_readings(r, seeds, lower)}
    if args.out:
        Path(args.out).write_text(json.dumps(out))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
