#!/usr/bin/env python3
"""Time the LZ decode kernel of the lizard_tpu_torch package that lies in
the current directory, on one NVIDIA card, so that two checkouts of the
port can be compared in turns in one call:

    cd <checkout> && python3 <this repo>/tools/lz_decode_ab.py LABEL

The checkout is driven only through what every version of the port has
(lane_decode.stage_batch and lz_decode, split.split_streams,
runtime.compress, utils.datagen.build_corpus); the timing is this repo's
chip_smoke.cuda_ms. Prints one JSON line {"label", "card", "cases"}: for
each case the kernel's CUDA-event median with L2 warm (the inputs stay in
L2 from one repetition to the next) and with L2 flushed (a 128 MB buffer
written before every repetition), its decoded bytes checked against the
input. Cases: the 32 MB corpus of bench.py::build_corpus as 256
independent 128 KB streams, and its first 8 MB as one stream (one chain of
64 inner blocks), at levels 10 and 21.
"""

import importlib.util
import json
import os
import sys

BLOCK = 128 * 1024
CORPUS_BYTES = 32 << 20
STREAM_BYTES = 8 << 20
LEVELS = (10, 21)
REPS = {"batch": 10, "stream": 5}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lz_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.getcwd())
    from lizard_tpu_torch import runtime
    from lizard_tpu_torch.ops import lane_decode as tld
    from lizard_tpu_torch.ops.split import split_streams
    from lizard_tpu_torch.utils.datagen import build_corpus

    corpus = build_corpus(CORPUS_BYTES)
    chunks = [corpus[i:i + BLOCK] for i in range(0, len(corpus), BLOCK)]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    cases = {}
    for level in LEVELS:
        for kind, datas in (("batch", chunks),
                            ("stream", [corpus[:STREAM_BYTES]])):
            args = tld.stage_batch(
                split_streams([runtime.compress(d, level) for d in datas]),
                "cuda")
            out, lens, status = tld.lz_decode(**args)
            got = [bytes(t.cpu().numpy())
                   for t in tld.chain_outputs(out, lens, args["chains"])]
            if (status != 0).any() or got != datas:
                raise AssertionError(f"{kind} level {level}: decode != input")
            run = lambda: tld.lz_decode(**args)  # noqa: E731
            cases[f"{kind}_{level}"] = {
                "chains": len(datas), "inner_blocks": int(lens.numel()),
                "decoded_bytes": sum(map(len, datas)),
                "warm_ms": smoke.cuda_ms(run, REPS[kind]),
                "flushed_ms": smoke.cuda_ms(run, REPS[kind], flush)}
    print(json.dumps({"label": sys.argv[1] if len(sys.argv) > 1 else "",
                      "card": smoke.smi_line(), "cases": cases}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
