#!/usr/bin/env python3
"""Time and profile the first design of huf_pack (tools/huf_pack_v1.cu:
the port's csrc/huf_encode.cu before its redesign for Hopper, with clocks)
beside the current kernel, on one NVIDIA card, from the repo's root:

    python3 tools/huf_pack_ab.py

Builds the .cu with the port's nvcc flags into build/lizard_tpu_torch/.
Then, on the Huff0 batches of the encode path (chip_smoke.py phase 9: the
32 MB corpus of bench.py::build_corpus in 256 x 128 KB blocks encoded on
the card at levels 35 and 49, their flags and literals streams planned by
enc_huf.plan_huf_streams):

- both designs' words, bits and status equal to each other and to
  huf_pack_plain (also on tests/torch_cases.py::huf_pack_cases);
- the times in turns, first design, current, current, first: each
  design's call as its wrapper makes it (CUDA-event median of REPS single
  calls, L2 warm: the host's time to issue the call included, as
  chip_smoke.py's cuda_ms times it), and the device's time a call (the
  median over REPS of BURST calls issued back to back, over BURST: the
  host runs ahead, so its issue time is hidden), and the host's time to
  issue a call; the memset of the words alone (device time);
- the first design's clock: ns a 32-symbol step (every warp's ns over
  every warp's steps), the steps of the longest segment and its warp's ns,
  and steps x ns a step beside the measured time;
- the current kernel's profile (enc_huf.huf_pack_profile): shares of a
  block's cycles, rounds a segment, the longest block's ns.

Prints one JSON line. Nothing in the package imports this file.
"""

import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "tools", "huf_pack_v1.cu")
BLOCK = 128 * 1024
CORPUS_BYTES = 32 << 20
LEVELS = (35, 49)
REPS = 20
BURST = 20


def load_v1():
    """The first design's C launch function: the built
    tools/huf_pack_v1.cu (nvcc, the port's flags)."""
    from lizard_tpu_torch.ops import _build
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_build.FLAGS).encode())
    so = os.path.join(_build.BUILD_DIR,
                      f"libhuf_pack_v1-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", so, SRC],
                       check=True)
    fn = ctypes.CDLL(so).huf_pack_v1_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events, after two
    warm-up runs."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def burst_ms(fn, reps: int = REPS, burst: int = BURST) -> float:
    """Median over `reps` of the CUDA-event milliseconds of `burst` calls
    issued back to back, over `burst`: the device's time a call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return statistics.median(times)


def host_us(fn, n: int = BURST) -> float:
    """Host microseconds to issue one call, over `n` calls issued back to
    back (the device catches up after)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    issued = time.perf_counter() - t
    torch.cuda.synchronize()
    return issued / n * 1e6


def pack_v1(fn, data, segs, tables, n_words, prof=None):
    """The first design's call as its wrapper made it: the words zeroed
    (torch.zeros), then the launch."""
    import torch
    words = torch.zeros(n_words, dtype=torch.int32, device="cuda")
    bits = torch.empty(segs.shape[0], dtype=torch.int64, device="cuda")
    status = torch.empty(segs.shape[0], dtype=torch.int32, device="cuda")
    err = fn(data.data_ptr(), data.numel(), segs.data_ptr(), segs.shape[0],
             tables.data_ptr(), tables.shape[0], words.data_ptr(), n_words,
             bits.data_ptr(), status.data_ptr(),
             None if prof is None else prof.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"huf_pack_v1 launch failed: cudaError {err}")
    return words, bits, status


def huf_plan(te, teh, chunks, level: int):
    """The Huff0 plan of the encode path at `level`, as encode_blocks_lanes
    makes it (the kernels on the card, emission on the host)."""
    cfg = te.cfg_for_level(level)
    data, lens = te.pack_blocks(chunks, cfg, "cuda")
    maps = te.match_find(data, lens, cfg)
    if cfg.chain:
        maps = te.chain_walk(data, lens, maps, cfg)
    tok, counts = te.parse_tokens(data, lens, maps, te._parse_cfg(cfg))
    emitted = [te.emit_streams(d, *a, level)
               for d, a in zip(chunks, te.token_arrays(tok, counts))]
    return teh.plan_huf_streams(te.huf_candidates(emitted))


def same(a, b) -> bool:
    import torch
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("huf_pack_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from lizard_tpu_torch.ops import enc_huf as teh
    from lizard_tpu_torch.ops import enc_lanes as te
    from lizard_tpu_torch.utils.datagen import build_corpus
    from tests.torch_cases import huf_pack_cases

    fn = load_v1()
    for name, (data, segs, tables, n_words), _ in huf_pack_cases():
        args = [t.cuda() for t in (data, segs, tables)] + [n_words]
        if not same(pack_v1(fn, *args), teh.huf_pack(*args)):
            raise AssertionError(f"case {name}: the designs differ")
    corpus = build_corpus(CORPUS_BYTES)
    chunks = [corpus[i:i + BLOCK] for i in range(0, len(corpus), BLOCK)]
    out = {}
    for level in LEVELS:
        plan = huf_plan(te, teh, chunks, level)
        a = plan.stage("cuda")
        args = (a["data"], a["segs"], a["tables"], a["n_words"])
        new = teh.huf_pack(*args)
        if not (same(pack_v1(fn, *args), new)
                and same(new, teh.huf_pack_plain(*args))
                and bool((new[2] == teh.OK).all())):
            raise AssertionError(f"level {level}: outputs differ")
        calls = {"first": lambda: pack_v1(fn, *args),
                 "current": lambda: teh.huf_pack(*args)}
        turns = [{"design": who, "call_ms": cuda_ms(calls[who]),
                  "device_ms": burst_ms(calls[who]),
                  "host_issue_us": host_us(calls[who])}
                 for who in ("first", "current", "current", "first")]
        words = torch.empty(args[3], dtype=torch.int32, device="cuda")
        memset_ms = burst_ms(words.zero_)
        prof = torch.zeros((args[1].shape[0], 3), dtype=torch.int64,
                           device="cuda")
        if not same(pack_v1(fn, *args, prof=prof), new):
            raise AssertionError(f"level {level}: the clocked first "
                                 "design differs")
        p = prof.cpu().double()
        lens = plan.segs[:, 1]
        longest = int(lens.argmax())
        ns_per_step = float(p[:, 2].sum() / p[:, 0].sum())
        first_ms = statistics.median(t["call_ms"] for t in turns
                                     if t["design"] == "first")
        *_, cp = teh.huf_pack_profile(*args)
        c = cp.cpu().double()
        s = c.sum(0).tolist()
        out[str(level)] = {
            "segments": int(lens.numel()),
            "symbol_bytes": int(plan.data.numel()),
            "longest_segment": int(lens.max()),
            "n_words": int(args[3]),
            "turns": turns,
            "memset_device_ms": memset_ms,
            "first_profile": {
                "ns_per_step": ns_per_step,
                "longest_steps": int(p[longest, 0]),
                "longest_warp_ms": float(p[longest, 2]) / 1e6,
                "slowest_warp_ms": float(p[:, 2].max()) / 1e6,
                "steps_x_ns_ms": p[longest, 0].item() * ns_per_step / 1e6,
                "measured_call_ms": first_ms,
                "sm_mhz": float(p[:, 1].sum() / p[:, 2].sum() * 1e3)},
            "current_profile": {
                "setup_share": s[1] / s[0], "load_share": s[2] / s[0],
                "count_share": s[3] / s[0], "scan_share": s[4] / s[0],
                "scatter_share": s[5] / s[0], "store_share": s[6] / s[0],
                "rounds_per_segment": s[7] / c.shape[0],
                "block_ns_max": float(c[:, 8].max()),
                "block_ns_mean": s[8] / c.shape[0]}}
    print(json.dumps({"card": smi_line(), "torch": torch.__version__,
                      "levels": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
