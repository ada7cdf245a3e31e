"""Run a cell with the control or a planted fault in the program's place
(faults.py), or the program itself ("none"), on several seeds in one
process, and print one JSON line per seed with the compared numbers.

    python3 h100_bench/control.py --workload <cell> --plant <name> \
        --seeds <n,n,...> --seconds <s>

The readings of the correctness check's limits come from these lines: the
program's own on a dozen seeds or more, the control's on three or more.
Not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from h100_bench.host import pin_malloc  # noqa: E402

pin_malloc()                # as run.py does

from h100_bench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--plant", required=True,
                   choices=["none", *faults.PLANTS])
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.resolve(args.workload, False)
    form = cell["traffic"]["input"]
    for seed in map(int, args.seeds.split(",")):
        fn = None
        if args.plant != "none":
            fn = faults.PLANTS[args.plant](harness.entry(cell["traffic"]),
                                           form)
        t = time.monotonic()
        res = harness.run_cell(cell, seed, args.seconds, False, args.device,
                               fn=fn, t_start=time.monotonic())
        print(json.dumps({"workload": args.workload, "plant": args.plant,
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": {k: v["value"]
                                     for k, v in res["checks"].items()},
                          "metrics": {k: v["value"]
                                      for k, v in res["metrics"].items()},
                          "s": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
