#!/usr/bin/env python3
"""Profile the first designs of the device encoder's match_find and
chain_walk (tools/enc_v1_profile.cu: the port's kernels before their
redesign for Hopper, with clocks) on one NVIDIA card, from the repo's root:

    python3 tools/enc_v1_profile.py

Builds the .cu with the port's nvcc flags into build/lizard_tpu_torch/,
then on the 32 MB corpus of bench.py::build_corpus in 256 x 128 KB blocks
at levels 11, 21, 35 and 49: the first match_find's maps (equal to the
port's match_find, else it fails) and its per-block split (lookups,
verify, probes, chk13 and stores; the wait for the slowest lane; the
insert with its 128-wide duplicate count); at 49 the first chain_walk's
output (equal to the port's) and its split of a walked position's cycles
into delta loads and the byte loop, with the nodes walked. The current
kernels' profiles are chip_smoke.py's (match_profile, chain_profile).
Prints one JSON line.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "tools", "enc_v1_profile.cu")
BLOCK = 128 * 1024
CORPUS_BYTES = 32 << 20
LEVELS = (11, 21, 35, 49)
MAX_PROBES = 16                # the first design's parameter block


def load_v1():
    """The built tools/enc_v1_profile.cu (nvcc, the port's flags)."""
    from lizard_tpu_torch.ops import _build
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_build.FLAGS).encode())
    so = os.path.join(_build.BUILD_DIR, f"libenc_v1-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", so, SRC],
                       check=True)
    lib = ctypes.CDLL(so)
    lib.match_find_v1_scratch_ints.restype = ctypes.c_longlong
    lib.match_find_v1_scratch_ints.argtypes = [ctypes.c_int] * 2
    lib.match_find_v1_launch.restype = ctypes.c_int
    lib.match_find_v1_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    lib.chain_walk_v1_launch.restype = ctypes.c_int
    lib.chain_walk_v1_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p] * 3
    return lib


def v1_params(cfg, pad: int):
    """The first match_find's int32 parameter block, from the config."""
    vals = [cfg.n, cfg.n + pad, cfg.hl, cfg.maxoff, cfg.min_offset, cfg.k5,
            cfg.far, cfg.far_dist, cfg.chain, cfg.nmaps, len(cfg.probes)]
    vals += list(cfg.probes) + [0] * (MAX_PROBES - len(cfg.probes))
    return (ctypes.c_int32 * len(vals))(*vals)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("enc_v1_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from lizard_tpu_torch.ops import enc_lanes as te
    from lizard_tpu_torch.utils.datagen import build_corpus

    lib = load_v1()
    corpus = build_corpus(CORPUS_BYTES)
    chunks = [corpus[i:i + BLOCK] for i in range(0, len(corpus), BLOCK)]
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for level in LEVELS:
        cfg = te.cfg_for_level(level)
        data, lens = te.pack_blocks(chunks, cfg, "cuda")
        B = len(chunks)
        maps = te.match_find(data, lens, cfg)
        v1 = torch.empty_like(maps)
        prof = torch.zeros((B, 5), dtype=torch.int64, device="cuda")
        ints = lib.match_find_v1_scratch_ints(cfg.ntab, cfg.hl)
        if ints < 0:
            raise RuntimeError("match_find_v1: no shared-memory limit")
        scratch = (torch.empty(B * ints, dtype=torch.int32, device="cuda")
                   if ints else None)
        err = lib.match_find_v1_launch(
            data.data_ptr(), lens.data_ptr(), B,
            ctypes.cast(v1_params(cfg, te.PAD), ctypes.c_void_p),
            v1.data_ptr(), None if scratch is None else scratch.data_ptr(),
            prof.data_ptr(), stream)
        torch.cuda.synchronize()
        if err or not torch.equal(v1, maps):
            raise AssertionError(f"level {level}: match_find_v1 err {err} "
                                 "or maps differ from match_find's")
        p = prof.cpu().double().sum(0).tolist()
        rec = {"match_find_v1": {
            "table_scratch": bool(ints),
            "lookup_verify_store_share": p[1] / p[0],
            "wait_slowest_lane_share": p[2] / p[0],
            "insert_share": p[3] / p[0],
            "ns_per_segment": p[4] / (B * cfg.nseg),
            "sm_mhz": p[0] / p[4] * 1e3}}
        if cfg.chain:
            won = te.chain_walk(data, lens, maps, cfg)
            v1 = torch.empty_like(won)
            prof = torch.zeros((B, 6), dtype=torch.int64, device="cuda")
            err = lib.chain_walk_v1_launch(
                data.data_ptr(), maps.data_ptr(), B, cfg.n, cfg.n + te.PAD,
                cfg.nmaps, cfg.ncand, cfg.chain, cfg.pref, cfg.maxoff,
                v1.data_ptr(), prof.data_ptr(), stream)
            torch.cuda.synchronize()
            if err or not torch.equal(v1, won):
                raise AssertionError(f"level {level}: chain_walk_v1 err "
                                     f"{err} or output differs")
            p = prof.cpu().double().sum(0).tolist()
            rec["chain_walk_v1"] = {
                "delta_share": p[1] / p[0], "rank_share": p[2] / p[0],
                "nodes_per_position": p[3] / (B * cfg.n),
                "nodes_per_walk": p[3] / p[4],
                "walked_share": p[4] / (B * cfg.n),
                "cycles_per_node": p[0] / max(p[3], 1)}
        out[str(level)] = rec
    print(json.dumps({"card": smi_line(), "levels": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
