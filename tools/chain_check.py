"""One frame block of a frame-decode cell, decoded by the port on the card
and by the benchmark's plain reference, outside any timed window. Run from
the root of a checkout:

    python3 tools/chain_check.py --workload l46-frame-b4 --seed <n>

makes the cell's inputs from the seed as h100_bench/run.py does, draws one
request and one of its frame blocks from the seed, and decodes that
block's payload (one compressed stream; at -B4 a chain of 32 inner
blocks) with the port's api.decompress on the card, with spans recording
so that lz_decode's pass-2 counters are read, and with
h100_bench/reference/block_decode.decompress, the serial reference. Prints
one JSON line: whether each equals the input's bytes and the other, the
counters of the port's call, both times and the card. Exits 1 if the
bytes differ.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from h100_bench import harness, native
    from h100_bench.reference import block_decode
    from h100_bench.reference import frame as ref_frame
    from lizard_tpu_torch import api
    from lizard_tpu_torch.utils import profiling
    cell = harness.resolve(args.workload, False)
    config, traffic = cell["config"], cell["traffic"]
    if traffic["input"] != "frame":
        raise SystemExit(f"{args.workload} does not send frames")
    work = harness.prepare(config, traffic, args.seed)
    rng = np.random.default_rng([args.seed % (1 << 64), 3])
    r = int(rng.integers(len(work.inputs)))
    parsed = ref_frame.parse(work.inputs[r], native.xxh32)
    k = int(rng.integers(len(parsed["blocks"])))
    stored, payload = parsed["blocks"][k]
    size = parsed["block_size"]
    want = work.expected[r][k * size:(k + 1) * size]
    api.decompress(payload, device=args.device)         # builds, warms up
    if args.device != "cpu":
        torch.cuda.synchronize()
    profiling.reset()
    t = time.perf_counter()
    with profiling.recording():
        port = api.decompress(payload, device=args.device)
    port_s = time.perf_counter() - t
    counts = {n: v for n, v in profiling.counters().items()
              if n.startswith("lz_decode.") or n.startswith("huf_decode.")}
    t = time.perf_counter()
    ref = block_decode.decompress(payload)
    ref_s = time.perf_counter() - t
    same = port == want == ref
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "request": r,
        "frame_block": k, "stored": stored, "block_bytes": len(want),
        "payload_bytes": len(payload), "port_equals_input": port == want,
        "reference_equals_input": ref == want,
        "port_equals_reference": port == ref, "counters": counts,
        "port_s": port_s, "reference_s": ref_s,
        "device": (torch.cuda.get_device_name() if args.device != "cpu"
                   else "cpu")}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
