"""Cells of the benchmark cut to a size the CPU runs in a second, with
the plain versions of the program's kernels (device="cpu")."""

import json
import os

from h100_bench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cell(cell_name: str, metrics=("setup_s",)) -> dict:
    """The resolved cell, its corpus 64 KiB in 16 KiB parts and blocks,
    its requests 32 KiB (frames 16 KiB) and one warm-up call."""
    c = harness.resolve(cell_name, False)
    c["config"].update(corpus_bytes=1 << 16, corpus_part_bytes=1 << 14,
                       block_bytes=1 << 14)
    t = c["traffic"]
    t.update(request_bytes=1 << (14 if t["input"] == "frame" else 15),
             warmup=1)
    c["metrics"] = [(m, "u") for m in metrics]
    return c


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
