#!/usr/bin/env python3
"""Time the device encoder of the lizard_tpu_torch package that lies in the
current directory end to end, beside the native host encoder, on one NVIDIA
card, so that two checkouts of the port can be compared in turns in one
call (parent, change, change, parent):

    cd <checkout> && python3 <this repo>/tools/encode_ab.py LABEL

The checkout is driven only through what every version of the port has
(enc_lanes.encode_blocks_lanes, runtime.compress and runtime.decompress,
utils.datagen.build_corpus). On the 32 MB corpus of bench.py::build_corpus
in 256 x 128 KB blocks, at levels 11 and 49: one untimed call (it builds
the kernels), then REPS rounds, each one encode_blocks_lanes call on the
card and one pass of the native host encoder over the same blocks, both on
the host's clock. The native encoder runs no code of the card's path, so it
shows how fast the host was in that run. Every stream is decoded natively
and checked against its block. Prints one JSON line {"label", "card",
"levels"}: per level the runs and medians of both, in ms.
"""

import json
import os
import statistics
import subprocess
import sys
import time

BLOCK = 128 * 1024
CORPUS_BYTES = 32 << 20
LEVELS = (11, 49)
REPS = 5


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("encode_ab: no CUDA device", file=sys.stderr)
        return 2
    label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    sys.path.insert(0, os.getcwd())
    from lizard_tpu_torch import runtime
    from lizard_tpu_torch.ops import enc_lanes as te
    from lizard_tpu_torch.utils.datagen import build_corpus

    corpus = build_corpus(CORPUS_BYTES)
    chunks = [corpus[i:i + BLOCK] for i in range(0, len(corpus), BLOCK)]
    levels = {}
    for level in LEVELS:
        streams = te.encode_blocks_lanes(chunks, level)
        if [runtime.decompress(s, BLOCK) for s in streams] != chunks:
            raise AssertionError(f"level {level}: decode != input")
        card, host = [], []
        for _ in range(REPS):
            t = time.perf_counter()
            te.encode_blocks_lanes(chunks, level)
            card.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            for c in chunks:
                runtime.compress(c, level)
            host.append((time.perf_counter() - t) * 1e3)
        levels[str(level)] = {
            "encode_ms": statistics.median(card), "encode_runs_ms": card,
            "native_ms": statistics.median(host), "native_runs_ms": host}
    print(json.dumps({"label": label, "card": smi_line(),
                      "levels": levels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
