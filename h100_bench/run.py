"""Run one cell of the benchmark once and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (lizard_tpu_torch). The
last line of standard output is the result as one JSON object; the numbers
the correctness check compared, each beside its limit, are the last lines
of standard error. Exits with 2, printing no result, without as many CUDA
devices as the cell asks for, and with 3 when JAX or the JAX package was
loaded by the end of the window.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from h100_bench.host import pin_malloc  # noqa: E402

PINNED = pin_malloc()       # before numpy, torch and the program allocate
CACHE = os.path.join(ROOT, ".cache", "h100_bench")
# Kernel caches at fixed paths inside the checkout, so only a checkout's
# first run builds (the program's own nvcc builds go to build/ there).
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")

from h100_bench import harness  # noqa: E402


def _power() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.resolve(args.workload, bool(args.trace))
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda")
    if res["forbidden"]:
        print(f"modules of JAX or the JAX package were loaded: "
              f"{res['forbidden']}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    print(f"card: {_power()}; malloc thresholds pinned: {PINNED}",
          file=sys.stderr)
    for name, m in res["metrics"].items():
        print(f"metric {name} {m['value']!r} {m['unit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
