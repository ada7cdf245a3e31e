#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lizard_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from lizard_tpu_torch/csrc with nvcc (into
build/lizard_tpu_torch/), then runs the port's main paths, decoding
independent compressed streams and blockIndependent frames and compressing
on the card, and checks every result against the input bytes:

1. device: the card, and nvidia-smi's name and power limit;
2. build: every kernel source, one nvcc each, all started together;
3. full-size decode: the 32 MB corpus of bench.py::build_corpus in 128 KB
   independent blocks, compressed at levels 10 and 21, decoded by
   decompress_lanes on the card (lz_decode); kernel-only time (CUDA
   events, median, L2 warm), the kernel launches of one call (counted
   by the wrapper), the deferred share (bytes of the matches
   that pass 1 deferred / decoded bytes) and the most pointer-jumping
   rounds of a block in pass 2, end-to-end time, and the HBM floor;
4. Huffman full-size decode: the same corpus at levels 35 and 41, decoded
   by decompress_lanes (huf_decode then lz_decode, no host round trip
   between them); both kernels' times and floors, the steps of the path,
   and huf_decode's synchronisation rounds per segment (the share that
   needed the serial fallback);
5. kernel against plain: lz_decode against lz_decode_plain on the card, on
   the first 32 streams of the batch of levels 10 and 21, and at 35 and 41
   huf_decode against huf_decode_plain and lz_decode against
   lz_decode_plain on the filled inputs of the first 32 streams (the plain
   versions are Python loops over tokens and symbols: the whole batch
   took ~150 s);
6. level sweep: ~1 MB at levels 12, 19, 29, 31, 35, 41, 45, 49;
7. frames: a level-21 frame with 4 MB blocks (32 chained inner blocks,
   off24 matches present), a level-41 frame with 4 MB blocks (32 chained
   inner blocks with Huffman streams) and a level-10 frame with 128 KB
   blocks; each sweep level and frame is held against the plain versions
   too, on the kernel inputs that its own path gives;
8. corruption: truncated and altered streams, and altered Huff0 blobs,
   raise CorruptError;
9. full-size encode: the same corpus in 256 x 128 KB blocks compressed on
   the card by encode_blocks_lanes (match_find, chain_walk at 49,
   parse_tokens, native emission, at 35 and 49 the Huff0 stage on the card
   by huf_pack) at levels 11, 21, 35 and 49: end-to-end time, the steps,
   each kernel's time and HBM floor, the profiling instances' clocks
   (match_find: the serial table loop's busy share and ns a segment, the
   worker warps' shares; chain_walk: nodes a position, the delta-load and
   ranking shares of a walk; parse_tokens: walker and picker busy shares,
   walker cycles and ns per token; huf_pack: the set-up, load, lookup and
   count, scan, scatter and store shares of a block's cycles, rounds and
   warp steps a segment; the call's device time, calls issued back to
   back, and a memset of the same words beside it, what the prep kernel's
   zeroing costs), the native host encoder beside it, at
   35 and 49 the host entropy route beside it (the same bytes), and every
   stream decoded on the card and by the native decoder;
10. encoder kernels against plain: the four kernels against their plain
   versions on the card at full width at the four levels (maps, token
   counts, tokens, packed words, bit counts and status exactly);
11. encode sweep: every level 10-49 at ~1 MB, decoded back, huf_pack
   launched at 30-49 and not below; one level per distinct encoder tier
   held against the plain versions;
12. encode edge blocks (sizes 0-4097, a run, random, a 4-symbol alphabet,
   a block whose flags stream is one byte value) at 11, 21 and 49, held
   against the plain versions at 11 and 49, each Huff0 gate taken at 49
   (RLE, not compressible, stored, coded); the blocks that bound the
   parse (tests/torch_cases.py::parse_edge_blocks) and those that bound
   match_find and chain_walk (match_edge_blocks; chain_walk also on
   chain_tail_maps, walks into the zero pad) at 11, 21, 35 and 49, round
   trip and kernels against plain; the plans that bound huf_pack's split
   (huf_pack_cases: segment lengths around its steps, rounds and word
   buffer, 1- to 32-bit codes, overflow, a missing code in the last step,
   rows out of bounds) against plain; and 4 MB-block frames at -21 and -41
   compressed on the card and decoded by the port;
13. slot-layout batch decode: decode_batch_pallas (ops/pallas_decode.py,
   one lz_decode launch) on the full-size batches of levels 10 and 21:
   every block equals its input and lz_decode's output on the same staged
   batch; kernel and end-to-end times, the HBM floor;
14. single-stream decode: decompress_pallas on one 8 MB stream (64
   chained inner blocks, one chain: 64 CTAs in pass 1, the cross-block
   matches deferred to pass 2) at levels 10, 21 (off24 matches asserted)
   and 41 (one huf_decode launch first); equal to the input and the native
   decoder; at 21 lz_decode against lz_decode_plain on that single chain;
   13 and 14 report lz_decode as phase 3 does;
15. batch Huff0 decode: huf_decompress_lanes (ops/lane_huf.py, one
   huf_decode launch) on the Huff0 blobs of the level-41 batch, a
   tableLog-12 blob and an RLE blob, blob by blob equal to the native
   Huff0; huf_decode against huf_decode_plain on that plan, and on the
   blobs that bound its lane split (tests/torch_cases.py::
   lane_split_cases: codes that never self-synchronise, 1-bit and 11-bit
   codes, segments of 1-33 and 25,000 symbols, tableLog 12) with their
   corruptions;
16. real files: 16 MB of the Python standard library's files
   (utils/datagen.py::build_corpus_realfiles) at level 49 in 128 KB
   blocks, decoded by decompress_lanes whole and as streams 112-128 alone
   (the batch in which the TPU lane decoder corrupted block 120 on its own
   machine's files); skipped with a printed reason if the files come
   short of 16 MB;
17. linked frame: the 32 MB corpus compressed at level 21 by the native
   encoder as one stream, cut at inner-block boundaries into 4 MB frame
   blocks of a linked frame (frame.linked_frame), decoded by
   decompress_frame on the card (one chain of 256 inner blocks, one
   lz_decode call), equal to the input and to the native stream decode;
18. sharded lane decode: the corpus's streams at levels 10, 21 and 41
   through parallel/pipeline.py::decode_streams_sharded_lanes with
   devices=None (one shard, the card) and over ["cuda:0"] * 4, equal to the
   input, one lz_decode (and at 41 one huf_decode) call a shard, each timed
   end to end in turns with decompress_lanes on the same streams (what
   sharding costs on one card);
19. all-XLA decode: the same streams at 10 and 21 through
   decode_streams_sharded (ops/decode.py, plain PyTorch operations: no
   kernel of ours), equal to the input; end-to-end time, the token parse's
   loop steps and ms a step, the other steps, and the first 64 parse steps
   under torch.profiler (kernels launched, the device's busy share);
20. all-XLA encode at 10: frame.compress_frame_tpu(engine="xla") of the
   corpus and encode_streams_tpu of its 128 KB chunks, decoded on the card
   and natively, the card's bytes equal to the CPU run on 8 blocks, timed
   and sized beside encode_streams_lanes;
21. sharded encode at 11 and 49 over ["cuda:0"] * 4 (encode_blocks_sharded):
   byte-equal to encode_blocks_lanes, one call of each kernel a shard,
   both timed in turns;
22. parallel/multihost.py::decode_streams_global over a torch.distributed
   group of one rank on NCCL: results equal the input, the offsets
   (all-gathered by NCCL) the host's cumsum of the block lengths;
23. entry.entry()'s decode step and entry.dryrun_multichip(4,
   ["cuda:0"] * 4), each sharded path once on tiny shapes;
   phases 18-23 time their host steps as spans of utils/profiling.py
   recorded in memory, and their kernels' launches join the kernels
   line's launches_by_path;
24. the oracle (ref/, serial Python on the host: liblizard's bytes): its
   streams at every level 10-49 (64 KB of gen; 16 KB of a 16-symbol
   alphabet at the 11 optimal-parser levels, a Huffman stream asserted at
   30-49), each family decoded by one decompress_lanes call and every
   stream by api.decompress, equal to the input and to the native decoder,
   lz_decode and huf_decode held against their plain versions on each
   family's batch; its linked frames of 512 KB at -10, -21 and -41 (four
   128 KB frame blocks, matches across them) and an independent -35 frame
   with a content size, decoded by decompress_frame, equal to the input and
   the native frame decoder; decode_frame_sharded over ["cuda:0"] * 4
   refusing a wrong content size, trailing bytes and a second frame; the
   oracle's encode time per level (the card machine's CPU) and the phase's
   wall time;
25. the incremental layer (streaming.py, frame.FrameEncoder and
   FrameDecoder, cli.py) on the card: FrameDecoder on a 32 MB linked -21
   frame of 4 MB frame blocks (frame.linked_frame of a native stream) fed in
   64 KB updates, each block's chain headed by the window (the history
   staged reaches 16 MB from the fifth block on), on an independent -41
   frame (compress_frame_lanes) fed in 1 MB updates and on that frame
   between skippable frames and before a -10 frame; lz_decode and
   huf_decode calls counted from 0 for each run against one a (update,
   frame) pair that completes a compressed block, every output equal to
   the input and the native decoder, each run timed beside
   decompress_frame, and the history bytes staged per frame block;
   DecompressStream on 1 MB of CompressStream's -11 streams (the oracle on
   the host) in 64 KB calls, decompress_using_dict, decompress_partial;
   FrameEncoder(backend="gpu") over the corpus at -35 in 64 KB updates,
   one call of each encoder kernel an update that completes a block,
   byte-equal to compress_frame_lanes and decoded natively; python -m
   lizard_tpu_torch.cli -z -41, -d and -t in subprocesses on a 32 MB file
   (-z's frame equal to compress_frame_lanes', -d's output to the input)
   and a 1 MB -BD round trip; lz_decode against lz_decode_plain on a
   history-headed batch (1 MB of history and one 128 KB -21 block whose
   matches reach into it);
26. the kernels line (one JSON object per kernel);
27. the last line: {"ok": true, "device": {...}}.

Any mismatch or exception exits non-zero; with no CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak
BLOCK = 128 * 1024
CORPUS_BYTES = 32 << 20
MAIN_LEVELS = (10, 21)
HUF_LEVELS = (35, 41)
SWEEP_LEVELS = (12, 19, 29, 31, 35, 41, 45, 49)
KERNEL_REPS = 10
PLAIN_TOLERANCE = 0            # decoded bytes, lengths, status: exact
PLAIN_STREAMS = 32             # streams of a full batch held against plain
ENC_LEVELS = (11, 21, 35, 49)
ENC_REPS = 3
# one level per distinct encoder tier (EncCfg): both codeword families,
# both Huff0 stages, every k5 / chain / far variant
ENC_TIER_LEVELS = (10, 20, 31, 41, 12, 22, 33, 43, 15, 45, 16, 37, 18, 49)
ENC_TOLERANCE = 0              # maps, token counts and tokens: exact
# (kernels-line name, wrapper, source, the TPU kernel it replaces, the level
# whose time heads its entry)
ENC_KERNELS = (
    ("match_find", "match_find", "enc_match",
     "lizard_tpu/ops/enc_lanes.py:219::_p1_kernel", 11),
    ("chain_walk", "chain_walk", "enc_chain",
     "lizard_tpu/ops/enc_lanes.py:538::_p15_kernel", 49),
    ("parse_tokens", "parse_tokens", "enc_parse",
     "lizard_tpu/ops/enc_lanes.py:762::_pA_kernel", 11),
    ("huf_encode", "huf_pack", "huf_encode",
     "lizard_tpu/ops/enc_huf.py:41::_henc_kernel", 35),
)
ENC_WRAPPERS = ("match_find", "chain_walk", "parse_tokens", "huf_pack")
SMOKE = "smoke."               # this script's own spans (timed)
# the encode record's profile of each kernel that has a profiling instance
PROFILES = {"match_find": "match_profile", "chain_walk": "chain_profile",
            "parse_tokens": "parse_profile", "huf_pack": "huf_profile"}
STREAM_BYTES = 8 << 20         # one stream of 64 chained inner blocks
STREAM_LEVELS = (10, 21, 41)
STREAM_REPS = 3
LINKED_LEVEL = 21
LINKED_BSID = 4                # 4 MB frame blocks: 32 inner blocks each
REALFILE_BYTES = 16 << 20
REALFILE_LEVEL = 49
REALFILE_PART = (112, 128)     # streams of the batch decoded alone
REALFILE_BLOCK = 120           # the block the TPU lane decoder corrupted
SHARDS = 4                     # shards of the sharded phases on one card
SHARDED_LEVELS = (10, 21, 41)  # sharded lane decode
XLA_LEVELS = (10, 21)          # all-XLA decode
XLA_ENC_LEVEL = 10             # all-XLA encode (fastLZ4 only)
SHARDED_ENC_LEVELS = (11, 49)  # sharded encode
SHARDED_REPS = 3
XLA_TRACE_STEPS = 64           # parse steps under torch.profiler
ORACLE_BYTES = 64 << 10        # oracle streams, the 29 levels that are not
ORACLE_OPT_BYTES = 16 << 10    # optimal-parser, and the 11 that are
ORACLE_FRAME_BYTES = 512 << 10
ORACLE_LINKED_LEVELS = (10, 21, 41)   # linked, four 128 KB frame blocks
ORACLE_FRAME_LEVEL = 35        # an independent frame with a content size
C2_BYTES = 20_000              # the frame the sharded decode must refuse
INC_BSID = 4                   # phase 25: 4 MB frame blocks
INC_CHUNK = 64 << 10           # the CLI's read size (cli.IO_CHUNK)
INC_BIG_CHUNK = 1 << 20
INC_LINKED_LEVEL = 21
INC_INDEP_LEVEL = 41
INC_ENC_LEVEL = 35
INC_STREAM_BYTES = 1 << 20     # DecompressStream's input, INC_CHUNK a call
INC_STREAM_LEVEL = 11
INC_BD_BYTES = 1 << 20         # the CLI's -BD round trip
INC_HISTORY = 1 << 20          # the history-headed batch against plain
INC_REPS = 3


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Median milliseconds of fn() over `reps` runs, timed by CUDA events
    (two warm-up runs first). With `flush`, a device buffer larger than
    the L2, it is written before every run, outside the timed span."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def e2e_ms(decompress_lanes, streams, reps: int = 5) -> list[float]:
    """Host-clock milliseconds of `reps` whole decompress_lanes calls (host
    bytes in, host bytes out; the call ends in a device-to-host copy)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        decompress_lanes(streams)
        times.append((time.perf_counter() - t) * 1e3)
    return times


def staged_bytes(args: dict) -> int:
    """Bytes lz_decode must read: the four streams and both tables."""
    return sum(args[k].numel() * args[k].element_size()
               for k in ("flags", "literals", "off16", "off24", "blocks",
                         "chains"))


def hold_against_plain(tld, args: dict, what: str) -> dict:
    """lz_decode against lz_decode_plain on the same staged inputs on the
    card: block lengths and status exactly (every chain OK), the decoded
    bytes within PLAIN_TOLERANCE. Emits and returns the comparison; the
    plain version's time is host-clock, synchronised."""
    import torch
    k = tld.lz_decode(**args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    p = tld.lz_decode_plain(**args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    for name, a, b in (("block_len", k[1], p[1]), ("status", k[2], p[2])):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs from the plain "
                                 "version")
    if (k[2] != tld.OK).any():
        raise AssertionError(f"{what}: a chain did not decode")
    kb = torch.cat(tld.chain_outputs(k[0], k[1], args["chains"]))
    pb = torch.cat(tld.chain_outputs(p[0], p[1], args["chains"]))
    err = int((kb.int() - pb.int()).abs().max()) if kb.numel() else 0
    if err > PLAIN_TOLERANCE:
        raise AssertionError(f"{what}: bytes differ from the plain version")
    rec = {"what": what, "chains": int(args["chains"].shape[0]),
           "inner_blocks": int(args["blocks"].shape[0]),
           "bytes": int(kb.numel()), "max_abs_err": err, "plain_ms": plain_ms}
    emit("kernel_vs_plain", **rec)
    return rec


def huf_against_plain(th, batch, plan, what: str):
    """huf_decode against huf_decode_plain on the card on one plan, each
    writing into its own copy of the batch's staged (holed) streams: status
    exactly (every segment OK), the filled streams within PLAIN_TOLERANCE.
    Emits the comparison; returns it and the kernel's filled streams. The
    plain version's time is host-clock, synchronised."""
    import torch
    from lizard_tpu_torch.ops.split import STREAMS
    staged = plan.stage("cuda")
    runs = []
    for fn in (th.huf_decode, th.huf_decode_plain):
        dests = {k: getattr(batch, k).to("cuda") for k in STREAMS}
        torch.cuda.synchronize()
        t = time.perf_counter()
        status = fn(**staged, **dests)
        torch.cuda.synchronize()
        runs.append((status, dests, (time.perf_counter() - t) * 1e3))
    (ks, kd, _), (ps, pd, plain_ms) = runs
    if not torch.equal(ks, ps):
        raise AssertionError(f"{what}: huf status differs from the plain "
                             "version")
    if (ks != th.OK).any():
        raise AssertionError(f"{what}: a Huff0 segment did not decode")
    err = max((int((kd[k].int() - pd[k].int()).abs().max())
               if kd[k].numel() else 0) for k in STREAMS)
    if err > PLAIN_TOLERANCE:
        raise AssertionError(f"{what}: huf bytes differ from the plain "
                             "version")
    rec = {"what": what, "blobs": int(plan.table_log.numel()),
           "segments": int(plan.segs.shape[0]),
           "bytes": int(plan.segs[:, 4].sum()), "max_abs_err": err,
           "plain_ms": plain_ms}
    emit("huf_vs_plain", **rec)
    return rec, kd


def both_against_plain(th, tld, streams, what: str) -> tuple:
    """The kernels of the default route against their plain versions on
    the inputs that route gives `streams`: huf_decode (if the batch has a
    Huffman stream), then lz_decode on the kernel-filled streams. Returns
    (huf record or None, lz record)."""
    from lizard_tpu_torch.ops.fuse import build_fused_plan
    batch, plan = build_fused_plan(streams)
    args = tld.stage_batch(batch, "cuda")
    huf = None
    if plan.segs.shape[0]:
        huf, filled = huf_against_plain(th, batch, plan, what)
        args.update(filled)
    return huf, hold_against_plain(tld, args, what)


def huf_sync(th, hargs) -> dict:
    """The synchronisation rounds of every segment of a staged Huff0 batch
    (huf_decode_rounds, a comparison launch): how many segments took each
    count, and the share that needed more than one round (a lane whose
    path never met the true one inside its range: the serial fallback)."""
    _, rounds = th.huf_decode_rounds(**hargs)
    r = rounds.cpu()
    values, counts = r.unique(return_counts=True)
    return {"segments_by_rounds": dict(zip(map(str, values.tolist()),
                                           counts.tolist())),
            "fallback_share": float((r > 1).double().mean()),
            "max_rounds": int(r.max())}


def huf_lane_split(th) -> dict:
    """huf_decode against huf_decode_plain on the card on the blobs that
    bound its lane split and their corruptions
    (tests/torch_cases.py::lane_split_against_plain: codes of one length
    that never self-synchronise, a 1-bit code among 11-bit ones, segments
    of 1-33 and of 25,000 symbols, tableLog 12; a segment cut by a byte,
    an end mark of 0, a flipped bit, a row out of bounds), and the rounds
    each case took. Emits and returns the comparison."""
    import torch
    from tests.torch_cases import lane_split_against_plain
    r = lane_split_against_plain(torch.device("cuda"))
    cases, (data, segs, tables, table_log) = r["cases"], r["args"]
    out = torch.zeros(sum(len(d) for _, _, d in cases), dtype=torch.uint8,
                      device="cuda")
    e = torch.empty(0, dtype=torch.uint8, device="cuda")
    _, rounds = th.huf_decode_rounds(data, segs[:r["n_ok_rows"]], tables,
                                     table_log, out, e, e, e)
    by_case = rounds.cpu().view(-1, 4).max(1).values.tolist()
    rec = {"what": "lane split cases and corruptions",
           "cases": [n for n, _, _ in cases], "blobs": r["blobs"],
           "segments": int(segs.shape[0]), "statuses": r["statuses"],
           "max_rounds_by_case": dict(zip((n for n, _, _ in cases), by_case)),
           "max_abs_err": r["max_abs_err"], "plain_ms": r["plain_ms"]}
    emit("huf_vs_plain", **rec)
    return rec


def huf_floor_bytes(plan) -> tuple[int, int]:
    """(bytes read, bytes written) by huf_decode on a plan: the segment
    bytes, the segment table, the decode table entries it uses (2 << tableLog
    each) and the tableLogs in; the decoded bytes and statuses out."""
    read = (plan.data.numel() + plan.segs.numel() * 8
            + sum(2 << tl for tl in plan.table_log.tolist())
            + plan.table_log.numel() * 4)
    written = int(plan.segs[:, 4].sum()) + 4 * plan.segs.shape[0]
    return read, written


@contextlib.contextmanager
def timed(profiling, name: str):
    """The block as this script's span SMOKE + name, recorded in memory
    (utils/profiling.py), the program's spans inside it under it."""
    with profiling.recording(), profiling.span(SMOKE + name, "host"):
        yield


def smoke_ms(profiling) -> dict[str, list[float]]:
    """The ms of each of this script's spans (timed) since the last
    profiling.reset(), by name, in the order they ran."""
    ms = {}
    for r in profiling.records():
        if r.name.startswith(SMOKE):
            ms.setdefault(r.name[len(SMOKE):], []).append(
                (r.end_ns - r.start_ns) / 1e6)
    return ms


def counted(name: str) -> int:
    """utils/profiling.py's counter `name`: a kernel wrapper's calls
    ("<kernel>.launches") or the kernels it launched
    ("<kernel>.kernel_launches") since the last reset_counts()."""
    from lizard_tpu_torch.utils import profiling
    return profiling.counters()[name]


def reset_counts() -> None:
    """Set every counter of utils/profiling.py to 0 (and drop its spans)."""
    from lizard_tpu_torch.utils import profiling
    profiling.reset()


def enc_launches() -> tuple[int, int, int, int]:
    """The launch counts of match_find, chain_walk, parse_tokens and
    huf_pack."""
    return (counted("match_find.launches"), counted("chain_walk.launches"),
            counted("parse_tokens.launches"), counted("huf_pack.launches"))


def check_enc_launches(te, cfg, level: int,
                       what: str) -> tuple[int, int, int, int]:
    """The encoder kernels' launches since the last reset; raises unless
    match_find and parse_tokens launched, chain_walk launched exactly at
    the chain tiers and huf_pack exactly at the Huffman levels 30-49 (every
    input here has a stream that its gates code)."""
    got = enc_launches()
    if (got[0] < 1 or got[2] < 1 or (got[1] >= 1) != bool(cfg.chain)
            or (got[3] >= 1) != te.huffman_level(level)):
        raise AssertionError(f"{what}: encoder kernel launches {got}")
    return got


def huf_pack_floor_bytes(plan, bits) -> int:
    """Bytes huf_pack must move: the symbols, the segment rows and the
    tables read once; the words that hold each segment's bits and end mark,
    the bit counts and the statuses written once."""
    used = int(((bits.cpu() + 1 + 31) // 32).sum())
    n_seg = plan.segs.shape[0]
    return (plan.data.numel() + 8 * plan.segs.numel()
            + 4 * plan.tables.numel() + 4 * used + 12 * n_seg)


def enc_floor_bytes(te, cfg, n_blocks: int, tokens: int) -> dict:
    """Bytes each encoder kernel must move, each input read once and each
    output written once: the packed rows (and lengths), the uint16 maps
    in and out, and 12 bytes per token plus a count per block."""
    rows = n_blocks * (cfg.n + te.PAD)
    lens = 4 * n_blocks
    one_map = 2 * n_blocks * cfg.n
    return {"match_find": rows + lens + cfg.nmaps * one_map,
            "chain_walk": rows + (cfg.nmaps + cfg.ncand) * one_map,
            "parse_tokens": rows + lens + cfg.ncand * one_map + 12 * tokens
            + 4 * n_blocks}


def encode_against_plain(te, teh, blocks, level: int, what: str) -> dict:
    """match_find, chain_walk (chain tiers), parse_tokens and (levels 30-49)
    huf_pack against their plain versions on the card, on the inputs the
    encode path gives them at `level`: maps, token counts, the used token
    slots, and the packed words, bit counts and statuses of the batch's
    Huff0 plan within ENC_TOLERANCE. Emits the comparison; returns
    {wrapper: (max_abs_err, plain host ms)}, the plain versions timed on
    the host clock, synchronised."""
    import torch
    cfg = te.cfg_for_level(level)
    data, lens = te.pack_blocks(blocks, cfg, "cuda")

    def plain(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*args)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    def err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    out = {}
    maps = te.match_find(data, lens, cfg)
    pmaps, ms = plain(te.match_find_plain, data, lens, cfg)
    out["match_find"] = (err(maps, pmaps), ms)
    if cfg.chain:
        won = te.chain_walk(data, lens, maps, cfg)
        pwon, ms = plain(te.chain_walk_plain, data, lens, maps, cfg)
        out["chain_walk"] = (err(won, pwon), ms)
        maps = won
    pcfg = te._parse_cfg(cfg)
    tok, counts = te.parse_tokens(data, lens, maps, pcfg)
    (ptok, pcounts), ms = plain(te.parse_tokens_plain, data, lens, maps, pcfg)
    used = (torch.arange(cfg.max_tokens, device=counts.device)[None, :]
            < counts[:, None].long())
    out["parse_tokens"] = (max(err(counts, pcounts),
                               err(tok[used], ptok[used])), ms)
    huf_ok = True
    if te.huffman_level(level):
        emitted = [te.emit_streams(d, *a, level)
                   for d, a in zip(blocks, te.token_arrays(tok, counts))]
        cands = te.huf_candidates(emitted)
        plan = teh.plan_huf_streams(cands)
        if not same_huf_plan(plan, teh.plan_huf_streams_plain(cands)):
            raise AssertionError(f"{what}: the native Huff0 plan differs "
                                 f"from the plain plan")
        if plan.coded:
            hargs = plan.stage("cuda")
            k = teh.huf_pack(**hargs)
            p, ms = plain(teh.huf_pack_plain, *hargs.values())
            out["huf_pack"] = (max(err(a, b) for a, b in zip(k, p)), ms)
            huf_ok = bool((k[2] == teh.OK).all())
    if (max(v[0] for v in out.values()) > ENC_TOLERANCE
            or bool((counts < 0).any()) or not huf_ok):
        raise AssertionError(f"{what}: an encoder kernel differs from its "
                             f"plain version: {out}")
    emit("encoder_vs_plain", what=what, level=level, blocks=len(blocks),
         tokens=int(counts.sum()),
         max_abs_err={k: v[0] for k, v in out.items()},
         plain_ms={k: v[1] for k, v in out.items()})
    return out


def e2e_encode_ms(te, chunks, level: int, **kw) -> list[float]:
    """Host-clock milliseconds of ENC_REPS whole encode_blocks_lanes calls
    (host bytes in, host streams out)."""
    runs = []
    for _ in range(ENC_REPS):
        t = time.perf_counter()
        te.encode_blocks_lanes(chunks, level, **kw)
        runs.append((time.perf_counter() - t) * 1e3)
    return runs


def same_huf_plan(a, b) -> bool:
    """Two HufEncPlans are equal field for field."""
    import torch
    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in ("data", "segs", "tables"))
            and all(getattr(a, f) == getattr(b, f)
                    for f in ("n_words", "coded", "headers", "blobs")))


def encode_level(te, teh, tld, runtime, chunks, level: int, smi: str) -> dict:
    """The encode path at full width: encode_blocks_lanes on the card (its
    launches counted), timed whole; at 30-49 the host entropy route timed
    beside it and byte-equal to it; every stream decoded on the card and by
    the native decoder; the steps, each synchronised; each kernel's CUDA
    event median and HBM floor; the native host encoder beside it. Emits
    the record and returns it."""
    import torch
    cfg = te.cfg_for_level(level)
    huff = te.huffman_level(level)
    reset_counts()
    streams = te.encode_blocks_lanes(chunks, level)      # device=None: card
    torch.cuda.synchronize()
    launches = check_enc_launches(te, cfg, level,
                                  f"encode level {level}")
    huf_kernels = counted("huf_pack.kernel_launches")
    e2e_runs = e2e_encode_ms(te, chunks, level)
    host_runs = None
    if huff:
        if te.encode_blocks_lanes(chunks, level, entropy="host") != streams:
            raise AssertionError(f"encode level {level}: the entropy routes "
                                 "gave other streams")
        host_runs = e2e_encode_ms(te, chunks, level, entropy="host")
    if tld.decompress_lanes(streams) != chunks:
        raise AssertionError(f"encode level {level}: card decode != input")
    if [runtime.decompress(s, BLOCK) for s in streams] != chunks:
        raise AssertionError(f"encode level {level}: native decode != input")
    # the same path step by step, each step synchronised
    steps = {}
    t = time.perf_counter()
    data, lens = te.pack_blocks(chunks, cfg, "cuda")
    torch.cuda.synchronize()
    steps["pack_h2d_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    found = maps = te.match_find(data, lens, cfg)
    torch.cuda.synchronize()
    steps["match_find_ms"] = (time.perf_counter() - t) * 1e3
    if cfg.chain:
        t = time.perf_counter()
        maps = te.chain_walk(data, lens, found, cfg)
        torch.cuda.synchronize()
        steps["chain_walk_ms"] = (time.perf_counter() - t) * 1e3
    pcfg = te._parse_cfg(cfg)
    t = time.perf_counter()
    tok, counts = te.parse_tokens(data, lens, maps, pcfg)
    torch.cuda.synchronize()
    steps["parse_tokens_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    arrs = te.token_arrays(tok, counts)
    steps["d2h_tokens_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    emitted = [te.emit_streams(d, *a, level) for d, a in zip(chunks, arrs)]
    steps["emit_ms"] = (time.perf_counter() - t) * 1e3
    blobs, huf = None, None
    if huff:
        cands = te.huf_candidates(emitted)
        t = time.perf_counter()
        plan = teh.plan_huf_streams(cands)
        steps["huf_plan_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        pplan = teh.plan_huf_streams_plain(cands)
        steps["huf_plan_plain_ms"] = (time.perf_counter() - t) * 1e3
        if not same_huf_plan(plan, pplan):
            raise AssertionError("the native Huff0 plan differs from the "
                                 "plain plan")
        t = time.perf_counter()
        hargs = plan.stage("cuda")
        torch.cuda.synchronize()
        steps["huf_h2d_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        words, bits, status = teh.huf_pack(**hargs)
        torch.cuda.synchronize()
        steps["huf_pack_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        words, bits, status = words.cpu(), bits.cpu(), status.cpu()
        steps["huf_d2h_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        teh.raise_on_status(status, plan)
        blobs = dict(zip(cands, teh.finish(plan, words, bits)))
        steps["huf_finish_ms"] = (time.perf_counter() - t) * 1e3
        huf = {"candidate_streams": len(cands),
               "coded_streams": len(plan.coded),
               "rle_streams": sum(1 for b in plan.blobs
                                  if b is not None and len(b) == 1),
               "segments": int(plan.segs.shape[0]),
               "symbol_bytes": int(plan.data.numel()),
               "longest_segment": int(plan.segs[:, 1].max()),
               "packed_bits": int(bits.sum()),
               "blob_bytes": sum(len(b) for b in plan.blobs if b),
               "floor_bytes": huf_pack_floor_bytes(plan, bits)}
    t = time.perf_counter()
    again = [bytes([level]) + te.assemble_block(d, f, lits, o16, huff, o24,
                                                blobs)
             for d, (f, lits, o16, o24) in zip(chunks, emitted)]
    steps["containers_ms"] = (time.perf_counter() - t) * 1e3
    if again != streams:
        raise AssertionError(f"encode level {level}: the steps gave other "
                             "streams than encode_blocks_lanes")
    tokens = int(counts.sum())
    kernel_ms = {"match_find": cuda_ms(
        lambda: te.match_find(data, lens, cfg), KERNEL_REPS)}
    if cfg.chain:
        kernel_ms["chain_walk"] = cuda_ms(
            lambda: te.chain_walk(data, lens, found, cfg), KERNEL_REPS)
    kernel_ms["parse_tokens"] = cuda_ms(
        lambda: te.parse_tokens(data, lens, maps, pcfg), KERNEL_REPS)
    parse_prof = parse_profile(te, data, lens, maps, pcfg)
    match_prof = match_profile(te, data, lens, cfg)
    chain_prof = (chain_profile(te, data, lens, found, cfg) if cfg.chain
                  else None)
    floors = enc_floor_bytes(te, cfg, len(chunks), tokens)
    huf_prof = None
    if huff:
        kernel_ms["huf_pack"] = cuda_ms(lambda: teh.huf_pack(**hargs),
                                        KERNEL_REPS)
        floors["huf_pack"] = huf["floor_bytes"]
        huf_prof = huf_profile(teh, hargs, kernel_ms["huf_pack"])
    bound_ms = {k: floors[k] / HBM_BYTES_PER_S * 1e3 for k in kernel_ms}
    t = time.perf_counter()
    native = [runtime.compress(c, level) for c in chunks]
    native_ms = (time.perf_counter() - t) * 1e3
    size = sum(map(len, chunks))
    comp = sum(map(len, streams))
    e2e = statistics.median(e2e_runs)
    rec = {"level": level, "blocks": len(chunks), "bytes": size,
           "compressed_bytes": comp, "ratio": comp / size,
           "tokens": tokens, "launches": dict(zip(ENC_WRAPPERS, launches)),
           "huf_pack_kernel_launches": huf_kernels,
           "e2e_ms": e2e, "e2e_runs_ms": e2e_runs,
           "e2e_gbps": size / e2e / 1e6,
           "host_entropy_e2e_ms": (statistics.median(host_runs)
                                   if host_runs else None),
           "host_entropy_e2e_runs_ms": host_runs, "huf": huf,
           "steps": steps,
           "kernel_ms": kernel_ms, "hbm_floor_ms": bound_ms,
           "hbm_floor_bytes": {k: floors[k] for k in kernel_ms},
           "native_compressed_bytes": sum(map(len, native)),
           "native_ratio": sum(map(len, native)) / size,
           "native_host_ms": native_ms, "parse_profile": parse_prof,
           "match_profile": match_prof, "chain_profile": chain_prof,
           "huf_profile": huf_prof, "card": smi}
    emit("encode", **rec)
    return rec


def parse_profile(te, data, lens, maps, pcfg) -> dict:
    """parse_tokens' own clock (parse_tokens_profile, a comparison launch)
    on one batch: the walker warp's and the first picking warp's busy
    share of the blocks' cycles, the walker's cycles, ns (the card's global
    timer over the same spans) and steps per token, and the SM clock those
    spans ran at."""
    tok, counts, prof = te.parse_tokens_profile(data, lens, maps, pcfg)
    p = prof.cpu().double().sum(0).tolist()
    tokens = max(int(counts.sum()), 1)
    return {"walker_share": p[1] / p[0], "picker_share": p[2] / p[0],
            "walker_cycles_per_token": p[1] / tokens,
            "walker_ns_per_token": p[4] / tokens,
            "walker_steps_per_token": p[3] / tokens,
            "walker_sm_mhz": p[1] / p[4] * 1e3}


def match_profile(te, data, lens, cfg) -> dict:
    """match_find's own clock (match_find_profile, a comparison launch) on
    one batch: the serial table loop's busy share of the blocks' cycles and
    its ns per segment (the card's global timer), the worker warps' mean
    busy shares (keys, verify), the share of positions that walked the
    probe ladder, the blocks' ns per segment, and the SM clock over the
    loop's spans."""
    _, prof = te.match_find_profile(data, lens, cfg)
    p = prof.cpu().double().sum(0).tolist()
    segs = data.shape[0] * cfg.nseg
    return {"table_loop_share": p[1] / p[0],
            "table_loop_ns_per_segment": p[4] / segs,
            "key_warp_share": p[2] / p[0], "verify_warp_share": p[3] / p[0],
            "probed_share": p[5] / (data.shape[0] * cfg.n),
            "block_ns_per_segment": p[6] / segs,
            "table_loop_sm_mhz": p[1] / p[4] * 1e3}


def chain_profile(te, data, lens, maps, cfg) -> dict:
    """chain_walk's own clock (chain_walk_profile, a comparison launch) on
    one batch: the nodes walked per position and per walk, the lanes' use
    of the walk loop's slots (a node or a walk's end), the cycles of a
    node's delta read and of its ranking (each timed alone) and their
    shares, and the CTAs' mean ns (a CTA walks 8192 positions)."""
    _, prof = te.chain_walk_profile(data, lens, maps, cfg)
    p = prof.cpu().double().sum(0).tolist()
    node = max(p[1] + p[2], 1)
    return {"nodes_per_position": p[3] / (data.shape[0] * cfg.n),
            "nodes_per_walk": p[3] / max(p[4], 1),
            "walked_share": p[4] / (data.shape[0] * cfg.n),
            "lane_use": (p[3] + p[4]) / max(p[0], 1),
            "delta_cycles_per_node": p[1] / max(p[3], 1),
            "rank_cycles_per_node": p[2] / max(p[3], 1),
            "delta_share": p[1] / node, "rank_share": p[2] / node,
            "cta_ns": p[5] / prof.shape[0]}


def burst_ms(fn, burst: int = 10) -> float:
    """Median over KERNEL_REPS of the CUDA-event milliseconds of `burst`
    calls issued back to back, over `burst`: the device's time a call, the
    host's time to issue one hidden behind the calls before it."""
    return cuda_ms(lambda: [fn() for _ in range(burst)], KERNEL_REPS) / burst


def huf_profile(teh, hargs, kernel_ms: float) -> dict:
    """huf_pack's own clock (huf_pack_profile, a comparison launch) on one
    batch: the shares of the pack blocks' cycles (thread 0's, summed over
    the blocks, one a segment) in setting up (row, table, buffer), loading
    the symbols, looking up and counting their bits, the scan across the
    block (its barriers, so the wait for the block's slowest warp,
    included), scattering the codes into shared memory and storing the
    words; rounds and warp steps a segment (means); the blocks' mean and
    longest ns (global timer); the SM clock. Beside it the call's device
    time (burst_ms) and a memset of the same words alone (what the prep
    kernel's zeroing of them costs), each with its share of `kernel_ms`,
    the call as cuda_ms times it."""
    import torch
    *_, prof = teh.huf_pack_profile(**hargs)
    p = prof.cpu().double()
    p = p[p[:, 0] > 0]
    c = p.sum(0).tolist()
    device_ms = burst_ms(lambda: teh.huf_pack(**hargs))
    words = torch.empty(hargs["n_words"], dtype=torch.int32, device="cuda")
    zero_ms = burst_ms(words.zero_)
    return {"setup_share": c[1] / c[0], "load_share": c[2] / c[0],
            "count_share": c[3] / c[0], "scan_share": c[4] / c[0],
            "scatter_share": c[5] / c[0], "store_share": c[6] / c[0],
            "rounds_per_segment": c[7] / p.shape[0],
            "steps_per_segment": float(
                ((hargs["segs"][:, 1] + teh.PACK_STEP - 1)
                 // teh.PACK_STEP).double().mean()),
            "block_ns_mean": c[8] / p.shape[0],
            "block_ns_max": float(p[:, 8].max()),
            "sm_mhz": c[0] / c[8] * 1e3,
            "device_ms": device_ms, "device_share": device_ms / kernel_ms,
            "zero_words_ms": zero_ms, "zero_words_share": zero_ms / kernel_ms}


def encoder_entry(name, wrapper, src, replaces, main_level, enc, enc_err,
                  enc_plain_ms, n_blocks, other_paths: dict) -> dict:
    """The kernels-line entry of one encoder kernel from the full-size
    encode records `enc` (launches summed over their main-path runs and the
    runs of `other_paths`, {path: launches})."""
    levels = [lv for lv in ENC_LEVELS if wrapper in enc[lv]["kernel_ms"]]
    paths = {"encode_blocks_lanes": sum(enc[lv]["launches"][wrapper]
                                        for lv in ENC_LEVELS),
             **other_paths}
    launches = sum(paths.values())
    kernels = sum(enc[lv]["huf_pack_kernel_launches"] for lv in ENC_LEVELS)
    shape = f"level {main_level}, {n_blocks} blocks x 128 KB"
    if wrapper == "huf_pack":
        shape += (f": {enc[main_level]['huf']['coded_streams']} Huff0 "
                  "streams of their flags and literals")
    return {
        "name": name,
        "wrapper": wrapper,
        "route": "cuda",
        "source": f"lizard_tpu_torch/csrc/{src}.cu",
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": paths,
        "max_abs_err": enc_err[wrapper],
        "tolerance": ENC_TOLERANCE,
        "matches_plain": enc_err[wrapper] <= ENC_TOLERANCE,
        "ms": enc[main_level]["kernel_ms"][wrapper],
        "plain_ms": enc_plain_ms[wrapper][main_level],
        "bound_ms": enc[main_level]["hbm_floor_ms"][wrapper],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": shape,
        **({"kernel_launches": kernels,
            "kernel_launches_per_call":
                kernels / max(paths["encode_blocks_lanes"], 1)}
           if wrapper == "huf_pack" else {}),
        "ms_by_level": {str(lv): enc[lv]["kernel_ms"][wrapper]
                        for lv in levels},
        "plain_ms_by_level": {str(lv): enc_plain_ms[wrapper][lv]
                              for lv in levels},
        "bound_ms_by_level": {str(lv): enc[lv]["hbm_floor_ms"][wrapper]
                              for lv in levels},
        **({"profile_by_level": {str(lv): enc[lv][PROFILES[wrapper]]
                                 for lv in levels}}
           if wrapper in PROFILES else {}),
    }


def lz_floor_ms(args: dict, decoded: int) -> float:
    """HBM floor of lz_decode on a staged batch that decodes to `decoded`
    bytes: its inputs read once, the bytes, block lengths and chain
    statuses written once."""
    return (staged_bytes(args) + decoded + 4 * args["blocks"].shape[0]
            + 4 * args["chains"].shape[0]) / HBM_BYTES_PER_S * 1e3


def lz_profile(tld, args: dict, decoded: int, reps: int) -> dict:
    """lz_decode on a staged batch: the kernel's CUDA-event median (L2
    warm: the inputs stay in L2 between repetitions, as in every earlier
    run of this script), the kernel launches of one call (counted by the
    wrapper), pass 1's deferred copies (their count and bytes, and the
    deferred share: deferred bytes / decoded bytes) and the most
    pointer-jumping rounds of a block in pass 2 (jump; 0 when pass 2 did
    not run)."""
    reset_counts()
    _, _, status, meta = tld.lz_decode_meta(**args)
    per_call = counted("lz_decode.kernel_launches")
    if (status != tld.OK).any():
        raise AssertionError("lz_decode_meta: a chain did not decode")
    deferred = int(meta[:, tld.META_DEFERRED_BYTES].sum())
    return {"kernel_ms": cuda_ms(lambda: tld.lz_decode(**args), reps),
            "l2": "warm",
            "kernel_launches_per_call": per_call,
            "deferred_copies": int(meta[:, tld.META_DEFERRED].sum()),
            "deferred_bytes": deferred, "deferred_share": deferred / decoded,
            "jump_rounds_max": int(meta[:, tld.META_ROUNDS].max())}


def pallas_batch(tld, tpd, split_streams, level: int, streams, chunks,
                 smi: str) -> dict:
    """decode_batch_pallas on a full-size batch of independent streams on
    the card: exactly one lz_decode launch, every block equal to its input,
    the slot bytes equal to lz_decode's output on the same staged batch;
    the kernel's CUDA-event median, the end-to-end time (host bytes to
    host bytes: split, decode, copy back) and the HBM floor. Emits and
    returns the record."""
    import torch
    batch = split_streams(streams)
    reset_counts()
    out, block_len = tpd.decode_batch_pallas(batch)      # device=None: card
    torch.cuda.synchronize()
    launches = counted("lz_decode.launches")
    kernel_launches = counted("lz_decode.kernel_launches")
    if launches != 1:
        raise AssertionError(f"pallas_batch level {level}: {launches} "
                             "lz_decode launches, not 1")
    lens = block_len.cpu().tolist()
    if lens != [len(c) for c in chunks]:
        raise AssertionError(f"pallas_batch level {level}: block lengths")
    host = out.cpu().numpy()
    for b, c in enumerate(chunks):
        if host[b * BLOCK:b * BLOCK + len(c)].tobytes() != c:
            raise AssertionError(f"pallas_batch level {level}: block {b} "
                                 "!= input")
    # the same staged batch through lz_decode alone (a comparison launch)
    args = tld.stage_batch(batch, "cuda")
    ref, ref_len, ref_status = tld.lz_decode(**args)
    ref = tpd.to_slots(ref, ref_len, args["chains"])
    valid = (torch.arange(BLOCK, device="cuda")[None, :]
             < block_len[:, None]).flatten()
    if (not torch.equal(ref_len, block_len) or (ref_status != tld.OK).any()
            or not torch.equal(out[valid], ref[valid])):
        raise AssertionError(f"pallas_batch level {level}: slots differ "
                             "from lz_decode's output")
    runs = []
    for _ in range(5):
        t = time.perf_counter()
        o, _ = tpd.decode_batch_pallas(split_streams(streams))
        o.cpu()
        runs.append((time.perf_counter() - t) * 1e3)
    rec = {"level": level, "streams": len(streams), "blocks": len(chunks),
           "launches": launches, "kernel_launches": kernel_launches,
           "equal_to_input": True,
           "equal_to_lz_decode": True,
           **lz_profile(tld, args, sum(lens), KERNEL_REPS),
           "e2e_ms": statistics.median(runs), "e2e_runs_ms": runs,
           "hbm_floor_ms": lz_floor_ms(args, sum(lens)), "card": smi}
    emit("pallas_batch", **rec)
    return rec


def pallas_stream(tld, th, tpd, runtime, split_streams, level: int,
                  data: bytes, smi: str) -> dict:
    """decompress_pallas on one stream of 64 chained inner blocks (one
    chain: 64 CTAs of lz_decode's pass 1): exactly one lz_decode call and, at
    levels 30-49, one huf_decode launch before it (none below);
    equal to the input and to the native decoder; at level 21 off24
    matches present and lz_decode held against lz_decode_plain on this
    single chain. Times: decompress_pallas on the host clock, the kernel
    by CUDA events. Emits and returns the record."""
    import torch
    s = runtime.compress(data, level)
    batch = split_streams([s])
    if batch.n_blocks != STREAM_BYTES // BLOCK:
        raise AssertionError(f"pallas_stream level {level}: "
                             f"{batch.n_blocks} inner blocks")
    if level == 21 and batch.off24.numel() == 0:
        raise AssertionError("the 8 MB level-21 stream has no off24 matches")
    reset_counts()
    got = tpd.decompress_pallas(s, len(data))             # device=None: card
    torch.cuda.synchronize()
    launches = counted("lz_decode.launches")
    kernel_launches = counted("lz_decode.kernel_launches")
    if launches != 1 or counted("huf_decode.launches") != (level >= 30):
        raise AssertionError(f"pallas_stream level {level}: launches "
                             f"lz {launches}, huf "
                             f"{counted('huf_decode.launches')}")
    if got != data:
        raise AssertionError(f"pallas_stream level {level}: decode != input")
    if runtime.decompress(s, len(data)) != data:
        raise AssertionError(f"pallas_stream level {level}: native decode "
                             "!= input")
    runs = []
    for _ in range(STREAM_REPS):
        t = time.perf_counter()
        tpd.decompress_pallas(s, len(data))
        runs.append((time.perf_counter() - t) * 1e3)
    args = tld.stage_batch(batch, "cuda")
    rec = {"level": level, "bytes": len(data), "compressed_bytes": len(s),
           "inner_blocks": batch.n_blocks, "chains": 1,
           "off24_bytes": int(batch.off24.numel()), "launches": launches,
           "kernel_launches": kernel_launches,
           "e2e_ms": statistics.median(runs), "e2e_runs_ms": runs,
           **lz_profile(tld, args, len(data), STREAM_REPS),
           "hbm_floor_ms": lz_floor_ms(args, len(data)), "card": smi}
    if level == 21:
        rec["against_plain"] = hold_against_plain(
            tld, args, f"level 21, one stream of {batch.n_blocks} chained "
            "inner blocks")
    emit("pallas_stream", **rec)
    return rec


def fib_blob() -> tuple[bytes, bytes]:
    """(blob, data): a Huff0 blob of tableLog 12, the construction of
    tests/test_torch_huf.py::_fib_blob with the port's encoder pieces:
    Fibonacci counts of 16 symbols give a code tree deeper than 12, cut to
    12; the segments are packed back to front, each with its end mark."""
    import numpy as np
    from lizard_tpu_torch.ref import huf_encode as hr
    fib = [1, 1]
    while len(fib) < 16:
        fib.append(fib[-1] + fib[-2])
    data = bytes(np.random.default_rng(4).permutation(np.repeat(
        np.arange(16, dtype=np.uint8), fib)))
    count, max_sym, _ = hr.fse_count(data, 255)
    nb, val, log = hr.huf_build_ctable(count, max_sym, 12)
    if log != 12:
        raise AssertionError(f"the Fibonacci blob has tableLog {log}")
    seg = (len(data) + 3) // 4
    parts = []
    for i in range(4):
        bw = hr.BitWriter()
        for sym in reversed(data[i * seg:(i + 1) * seg]):
            bw.add(val[sym], nb[sym])
        parts.append(bw.close())
    blob = (hr.huf_write_ctable(nb, max_sym, log)
            + b"".join(len(p).to_bytes(2, "little") for p in parts[:3])
            + b"".join(parts))
    return blob, data


def lane_huf(th, tlh, runtime, split_into, new_accumulator, streams,
             smi: str) -> dict:
    """huf_decompress_lanes on the card on every Huff0 blob of `streams`,
    a tableLog-12 blob and an RLE blob: exactly one huf_decode launch, each
    blob equal to the native Huff0's decode. Then, on the host plan of the
    same blobs: the plan's time (host clock), the kernel's CUDA-event
    median, the HBM floor, and huf_decode against huf_decode_plain (status
    and bytes exactly). Emits and returns the record."""
    import torch
    blobs = []
    split_into(streams, new_accumulator(),
               lambda b, n, k: blobs.append((b, n)) or bytes(n))
    blob12, data12 = fib_blob()
    blobs += [(blob12, len(data12)), (b"\x41", 100)]
    reset_counts()
    got = tlh.huf_decompress_lanes(blobs)                 # device=None: card
    torch.cuda.synchronize()
    launches = counted("huf_decode.launches")
    if launches != 1:
        raise AssertionError(f"lane_huf: {launches} huf_decode launches")
    for i, ((b, n), g) in enumerate(zip(blobs, got)):
        if g != runtime.huf_decompress(b, n):
            raise AssertionError(f"lane_huf: blob {i} of {len(blobs)} "
                                 "differs from the native Huff0")
    if got[-2:] != [data12, b"A" * 100]:
        raise AssertionError("lane_huf: the tableLog-12 or RLE blob")
    t = time.perf_counter()
    plan = th.prepare_huf128(blobs)
    plan_ms = (time.perf_counter() - t) * 1e3
    staged = plan.stage("cuda")
    total = sum(n for _, n in blobs)
    empty = torch.empty(0, dtype=torch.uint8, device="cuda")
    runs = []
    for fn in (th.huf_decode, th.huf_decode_plain):      # comparison launches
        out = torch.zeros(total, dtype=torch.uint8, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        status = fn(**staged, flags=out, literals=empty, off16=empty,
                    off24=empty)
        torch.cuda.synchronize()
        runs.append((status, out, (time.perf_counter() - t) * 1e3))
    (ks, ko, _), (ps, po, plain_ms) = runs
    if not torch.equal(ks, ps) or (ks != th.OK).any():
        raise AssertionError("lane_huf: huf status differs from the plain "
                             "version")
    err = int((ko.int() - po.int()).abs().max())
    if err > PLAIN_TOLERANCE:
        raise AssertionError("lane_huf: huf bytes differ from the plain "
                             "version")
    out = torch.zeros(total, dtype=torch.uint8, device="cuda")
    k_ms = cuda_ms(lambda: th.huf_decode(**staged, flags=out, literals=empty,
                                         off16=empty, off24=empty),
                   KERNEL_REPS)
    read, written = huf_floor_bytes(plan)
    rec = {"blobs": len(blobs), "coded_blobs": int(plan.table_log.numel()),
           "segments": int(plan.segs.shape[0]), "decoded_bytes": total,
           "table_logs": sorted(set(plan.table_log.tolist())),
           "launches": launches, "equal_to_native": True,
           "host_plan_ms": plan_ms, "kernel_ms": k_ms,
           "hbm_floor_ms": (read + written) / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err, "plain_ms": plain_ms, "card": smi}
    emit("lane_huf", **rec)
    return rec


def realfiles(tld, th, runtime, decompress_lanes, build_corpus_realfiles,
              smi: str) -> dict | None:
    """16 MB of real files at level 49 in 128 KB independent blocks
    (native encoder), decoded on the card by decompress_lanes as a whole
    batch and as streams 112-128 alone; every block must equal its input.
    The TPU lane decoder corrupted block 120 of that sub-batch on the
    files of its own machine (ROADMAP.md, known fault 1); this machine has
    other files, so this is a real-file check, not a reproduction. Emits a
    skip with its reason, and returns None, if the files come short of
    16 MB."""
    import torch
    data = build_corpus_realfiles(REALFILE_BYTES)
    if data is None or len(data) < REALFILE_BYTES:
        emit("realfiles", skipped=f"only {len(data or b'')} bytes of real "
             f"files, not {REALFILE_BYTES}")
        return None
    chunks = [data[i:i + BLOCK] for i in range(0, len(data), BLOCK)]
    t = time.perf_counter()
    streams = [runtime.compress(c, REALFILE_LEVEL) for c in chunks]
    compress_ms = (time.perf_counter() - t) * 1e3
    reset_counts()
    whole = decompress_lanes(streams)
    torch.cuda.synchronize()
    lo, hi = REALFILE_PART
    part = decompress_lanes(streams[lo:hi])
    torch.cuda.synchronize()
    launches = {"lz_decode": counted("lz_decode.launches"),
                "huf_decode": counted("huf_decode.launches"),
                "lz_decode_kernels": counted("lz_decode.kernel_launches")}
    for name, got, first in (("whole batch", whole, 0),
                             (f"streams {lo}:{hi}", part, lo)):
        want = chunks[first:first + len(got)]
        if len(got) != (hi - lo if first else len(chunks)):
            raise AssertionError(f"realfiles, {name}: {len(got)} blocks")
        for b, (g, w) in enumerate(zip(got, want)):
            if g != w:
                raise AssertionError(f"realfiles, {name}: block "
                                     f"{first + b} != input")
    if launches["lz_decode"] != 2 or not 1 <= launches["huf_decode"] <= 2:
        raise AssertionError(f"realfiles: launches {launches}")
    rec = {"bytes": len(data), "level": REALFILE_LEVEL,
           "blocks": len(chunks),
           "compressed_bytes": sum(map(len, streams)),
           "native_compress_ms": compress_ms, "launches": launches,
           "sub_batch": [lo, hi],
           f"block_{REALFILE_BLOCK}": {
               "bytes": len(part[REALFILE_BLOCK - lo]),
               "equal_alone_and_in_batch": True},
           "all_blocks_equal": True,
           "note": "this machine's files, not the TPU run's corpus",
           "card": smi}
    emit("realfiles", **rec)
    return rec


def linked(tld, runtime, corpus: bytes, smi: str) -> dict:
    """A linked frame of the corpus, made without encoding anew: the
    native encoder's level-LINKED_LEVEL stream of the whole corpus cut at
    inner-block boundaries into frame blocks of 4 MB, each with the level
    byte, plus a content checksum (frame.linked_frame). decompress_frame on
    the card: exactly one lz_decode call (one chain of every inner block),
    equal to the input and to the native decode of the stream. Times:
    decompress_frame on the host clock, the kernel (lz_profile) on the
    frame's staged batch. Emits and returns the record."""
    import torch
    from lizard_tpu_torch import frame as tframe
    from lizard_tpu_torch.ops.split import split_streams
    s = runtime.compress(corpus, LINKED_LEVEL)
    fr = tframe.linked_frame(s, corpus, LINKED_BSID)
    info = tframe.parse_frame_header(fr)
    blocks = tframe._frame_blocks(fr, info.header_size)[0]
    if not info.block_linked or len(blocks) != len(corpus) >> 22:
        raise AssertionError("linked frame: not a linked frame of 4 MB "
                             "blocks")
    reset_counts()
    got = tframe.decompress_frame(fr)                     # device=None: card
    torch.cuda.synchronize()
    launches = counted("lz_decode.launches")
    kernel_launches = counted("lz_decode.kernel_launches")
    if launches != 1:
        raise AssertionError(f"linked frame: {launches} lz_decode calls")
    if got != corpus or runtime.decompress(s, len(corpus)) != corpus:
        raise AssertionError("linked frame: decode != input")
    runs = []
    for _ in range(STREAM_REPS):
        t = time.perf_counter()
        tframe.decompress_frame(fr)
        runs.append((time.perf_counter() - t) * 1e3)
    # the frame's batch: every frame block's inner blocks in one chain,
    # as decompress_frame stages it
    batch = split_streams([s])
    args = tld.stage_batch(batch, "cuda")
    rec = {"level": LINKED_LEVEL, "block_size_id": LINKED_BSID,
           "bytes": len(corpus), "frame_bytes": len(fr),
           "frame_blocks": len(blocks), "inner_blocks": batch.n_blocks,
           "chains": 1, "off24_bytes": int(batch.off24.numel()),
           "launches": launches, "kernel_launches": kernel_launches,
           "equal_to_input": True, "equal_to_native": True,
           "e2e_ms": statistics.median(runs), "e2e_runs_ms": runs,
           **lz_profile(tld, args, len(corpus), STREAM_REPS),
           "hbm_floor_ms": lz_floor_ms(args, len(corpus)), "card": smi}
    emit("linked_frame", **rec)
    return rec


def sharded_lanes(pp, tld, th, profiling, level: int, streams,
                  corpus: bytes, smi: str) -> dict:
    """Phase 18 at one level: decode_streams_sharded_lanes on the card with
    devices=None (one shard: the card) and over ["cuda:0"] * SHARDS, each
    equal to the input, the kernels' calls counted from 0 just before each
    run (one lz_decode call a shard, one huf_decode call a shard at 30-49);
    then each, and decompress_lanes on the same streams, timed whole on the
    host clock in turns (timed spans), SHARDED_REPS times. Emits and
    returns the record."""
    import torch
    runs = {"one_card": None, "sharded": ["cuda:0"] * SHARDS}
    launches = {}
    for name, devices in runs.items():
        reset_counts()
        outs = pp.decode_streams_sharded_lanes(streams, devices)
        torch.cuda.synchronize()
        launches[name] = {"lz_decode": counted("lz_decode.launches"),
                          "huf_decode": counted("huf_decode.launches")}
        shards = 1 if devices is None else SHARDS
        if b"".join(outs) != corpus:
            raise AssertionError(f"sharded lanes {name} level {level}: "
                                 "decode != input")
        if (launches[name]["lz_decode"] != shards
                or launches[name]["huf_decode"]
                != (shards if level >= 30 else 0)):
            raise AssertionError(f"sharded lanes {name} level {level}: "
                                 f"launches {launches[name]}")
    profiling.reset()
    for _ in range(SHARDED_REPS):
        with timed(profiling, "decompress_lanes"):
            tld.decompress_lanes(streams)
        for name, devices in runs.items():
            with timed(profiling, name):
                pp.decode_streams_sharded_lanes(streams, devices)
    ms = smoke_ms(profiling)
    rec = {"level": level, "streams": len(streams), "shards": SHARDS,
           "launches": launches,
           **{f"{k}_e2e_ms": statistics.median(v) for k, v in ms.items()},
           "e2e_runs_ms": ms, "card": smi}
    emit("sharded_lanes_decode", **rec)
    return rec


def xla_decode(pp, xd, profiling, level: int, streams, corpus: bytes,
               smi: str) -> dict:
    """Phase 19 at one level: the all-XLA decoder (ops/decode.py, plain
    PyTorch operations, no kernel of ours) through decode_streams_sharded
    on the card (devices=None: one shard), equal to the input, timed whole;
    then its steps on the same batch, each synchronised (timed spans):
    split, H2D, the token parse (max_steps + 1 loop steps), resolve, D2H;
    and the first XLA_TRACE_STEPS parse steps timed alone and traced by
    torch.profiler: the CUDA kernels they launch and their summed time
    beside the wall time (the device's busy share). Emits and returns the
    record."""
    import tempfile
    import torch
    from lizard_tpu_torch.format.levels import Codewords
    profiling.reset()
    with timed(profiling, "e2e"):
        outs = pp.decode_streams_sharded(streams, BLOCK)
    if b"".join(outs) != corpus:
        raise AssertionError(f"all-XLA decode level {level}: decode != input")
    with timed(profiling, "split"):
        batch = pp.split_shard(streams, list(range(len(streams))))
    liz = batch.codewords == Codewords.LIZv1
    with timed(profiling, "h2d"):
        args = xd.stage_batch(batch, "cuda")
        torch.cuda.synchronize()
    with timed(profiling, "parse"):
        parsed = xd.token_parse(args, liz, batch.max_tokens)
        torch.cuda.synchronize()
    with timed(profiling, "resolve"):
        out, blk_len = xd.resolve_output(
            *parsed, args["flags_len"], args["literals"],
            len(streams) * BLOCK, int((batch.flags_len + 1).sum()))
        torch.cuda.synchronize()
    with timed(profiling, "d2h"):
        data, lens = out.cpu(), blk_len.cpu()
    if bytes(data[:int(lens.sum())].numpy()) != corpus:
        raise AssertionError(f"all-XLA decode level {level}: steps != input")
    steps = batch.max_tokens + 1
    ms = {k: v[0] for k, v in smoke_ms(profiling).items()}
    # the first XLA_TRACE_STEPS steps alone, then under torch.profiler (a
    # one-step trace first, which pays the tracer's start-up): the CUDA
    # kernels' count and summed time beside the untraced wall time
    torch.cuda.synchronize()
    t = time.perf_counter()
    xd.token_parse(args, liz, XLA_TRACE_STEPS - 1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            xd.token_parse(args, liz, 0)
            torch.cuda.synchronize()
        with profiling.trace(tmp) as prof:
            xd.token_parse(args, liz, XLA_TRACE_STEPS - 1)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    rec = {"level": level, "streams": len(streams), "blocks": batch.n_blocks,
           "parse_steps": steps, "e2e_ms": ms["e2e"],
           "steps_ms": {k: ms[k] for k in ("split", "h2d", "parse",
                                           "resolve", "d2h")},
           "parse_ms_per_step": ms["parse"] / steps,
           "first_steps": XLA_TRACE_STEPS, "first_steps_wall_ms": wall_ms,
           "first_steps_kernel_ms": busy_ms,
           "first_steps_device_busy_share": busy_ms / wall_ms,
           "first_steps_kernels": sum(e.count for e in kernels),
           "gbps": len(corpus) / ms["e2e"] / 1e6, "card": smi}
    emit("xla_decode", **rec)
    return rec


def xla_encode(xe, te, tld, runtime, frame, ltt, profiling, chunks,
               corpus: bytes, smi: str) -> dict:
    """Phase 20: the all-XLA encoder (ops/encode_tpu.py, plain PyTorch
    operations) at XLA_ENC_LEVEL: compress_frame_tpu(engine="xla") of the
    corpus in 4 MB frame blocks, decoded on the card; encode_streams_tpu of
    the 128 KB chunks, every stream decoded on the card and natively, timed
    whole in turns with encode_streams_lanes (the device encoder) on the
    same chunks, and both ratios; on the first 8 blocks the card's bytes
    equal the CPU run of the same function; one batch of _encode_batch
    timed by CUDA events. Emits and returns the record."""
    import torch
    level = XLA_ENC_LEVEL
    profiling.reset()
    with timed(profiling, "frame"):
        fr = frame.compress_frame_tpu(corpus, level, block_size_id=4,
                                      engine="xla")
    if ltt.decompress_frame(fr) != corpus:
        raise AssertionError("all-XLA encode: the frame did not decode")
    for _ in range(SHARDED_REPS):
        with timed(profiling, "encode_streams_tpu"):
            xs = xe.encode_streams_tpu(chunks, level)
        with timed(profiling, "encode_streams_lanes"):
            ls = te.encode_streams_lanes(chunks, level)
    if (tld.decompress_lanes(xs) != chunks
            or [runtime.decompress(s, BLOCK) for s in xs] != chunks):
        raise AssertionError("all-XLA encode: a stream did not decode")
    cpu = xe.encode_blocks_tpu(chunks[:8], level, device="cpu")
    if cpu != xe.encode_blocks_tpu(chunks[:8], level) or cpu != xs[:8]:
        raise AssertionError("all-XLA encode: card bytes != CPU bytes")
    u8 = torch.zeros((xe.BATCH, xe.N), dtype=torch.uint8)
    for k, c in enumerate(chunks[:xe.BATCH]):
        u8[k] = torch.frombuffer(bytearray(c), dtype=torch.uint8)
    u8 = u8.cuda()
    n = torch.full((xe.BATCH,), xe.N, dtype=torch.int64, device="cuda")
    batch_ms = cuda_ms(lambda: xe._encode_batch(u8, n), SHARDED_REPS)
    ms = smoke_ms(profiling)
    rec = {"level": level, "blocks": len(chunks), "bytes": len(corpus),
           "frame_bytes": len(fr), "frame_ms": ms["frame"][0],
           "xla_e2e_ms": statistics.median(ms["encode_streams_tpu"]),
           "lanes_e2e_ms": statistics.median(ms["encode_streams_lanes"]),
           "e2e_runs_ms": {k: ms[k] for k in ("encode_streams_tpu",
                                              "encode_streams_lanes")},
           "xla_ratio": sum(map(len, xs)) / len(corpus),
           "lanes_ratio": sum(map(len, ls)) / len(corpus),
           "encode_batch_ms": batch_ms, "encode_batch_blocks": xe.BATCH,
           "cpu_equal_blocks": 8, "card": smi}
    emit("xla_encode", **rec)
    return rec


def sharded_encode(pp, te, teh, tld, profiling, chunks, level: int,
                   smi: str) -> dict:
    """Phase 21 at one level: encode_blocks_sharded over ["cuda:0"] *
    SHARDS, the encoder kernels' calls counted from 0 just before it (one
    call a shard of each kernel the level runs), byte-equal to
    encode_blocks_lanes on the card and decoded on the card; both timed
    whole in turns, SHARDED_REPS times. Emits and returns the record."""
    import torch
    cfg = te.cfg_for_level(level)
    devices = ["cuda:0"] * SHARDS
    reset_counts()
    got = pp.encode_blocks_sharded(chunks, level, devices=devices)
    torch.cuda.synchronize()
    launches = dict(zip(ENC_WRAPPERS, enc_launches()))
    want = {"match_find": SHARDS, "parse_tokens": SHARDS,
            "chain_walk": SHARDS if cfg.chain else 0,
            "huf_pack": SHARDS if te.huffman_level(level) else 0}
    if launches != want:
        raise AssertionError(f"sharded encode level {level}: launches "
                             f"{launches}, expected {want}")
    if got != te.encode_blocks_lanes(chunks, level):
        raise AssertionError(f"sharded encode level {level}: bytes differ "
                             "from encode_blocks_lanes")
    if tld.decompress_lanes(got) != chunks:
        raise AssertionError(f"sharded encode level {level}: decode != "
                             "input")
    profiling.reset()
    for _ in range(SHARDED_REPS):
        with timed(profiling, "encode_blocks_lanes"):
            te.encode_blocks_lanes(chunks, level)
        with timed(profiling, "encode_blocks_sharded"):
            pp.encode_blocks_sharded(chunks, level, devices=devices)
    ms = smoke_ms(profiling)
    rec = {"level": level, "blocks": len(chunks), "shards": SHARDS,
           "launches": launches,
           **{f"{k}_e2e_ms": statistics.median(v) for k, v in ms.items()},
           "e2e_runs_ms": ms,
           "compressed_bytes": sum(map(len, got)), "card": smi}
    emit("sharded_encode", **rec)
    return rec


def nccl_global(pm, streams, chunks, smi: str) -> dict:
    """Phase 22: a torch.distributed group of one rank over NCCL (a file
    store in a temporary directory), then decode_streams_global over it
    (the all-XLA decoder; the lengths all-gathered by NCCL): results equal
    the input, the offsets the host's exclusive cumsum of the block
    lengths; the group destroyed afterwards. Emits and returns the
    record."""
    import tempfile
    import torch
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            backend = dist.get_backend()
            t = time.perf_counter()
            results, offs = pm.decode_streams_global(streams, BLOCK)
            torch.cuda.synchronize()
            e2e_ms = (time.perf_counter() - t) * 1e3
        finally:
            dist.destroy_process_group()
    lens = torch.tensor([len(c) for c in chunks], dtype=torch.int64)
    if results != chunks:
        raise AssertionError("decode_streams_global: results != input")
    if offs.device.type != "cuda" or not torch.equal(
            offs.cpu().reshape(-1), torch.cumsum(lens, 0) - lens):
        raise AssertionError("decode_streams_global: offsets != the host's "
                             "cumsum")
    rec = {"backend": backend, "world_size": 1, "streams": len(streams),
           "offs_shape": list(offs.shape), "e2e_ms": e2e_ms, "card": smi}
    emit("nccl_global", **rec)
    return rec


def entry_phase(entry, te, teh, tld, th) -> dict:
    """Phase 23: entry.entry()'s all-XLA step on the card equal to its
    batch's bytes; entry.dryrun_multichip(SHARDS, ["cuda:0"] * SHARDS),
    every kernel's calls counted from 0 just before it. Emits and returns
    the record."""
    import torch
    from lizard_tpu_torch.utils.datagen import gen
    fn, args = entry.entry()
    out, blk_len = fn(*args)
    if bytes(out.cpu().numpy()) != gen(3000, seed=0) + gen(3000, seed=1):
        raise AssertionError("entry(): the decode step != its batch")
    reset_counts()
    t = time.perf_counter()
    entry.dryrun_multichip(SHARDS, ["cuda:0"] * SHARDS)
    torch.cuda.synchronize()
    rec = {"entry_blocks": int(blk_len.numel()),
           "dryrun_s": time.perf_counter() - t,
           "launches": {"lz_decode": counted("lz_decode.launches"),
                        "huf_decode": counted("huf_decode.launches"),
                        **dict(zip(ENC_WRAPPERS, enc_launches()))}}
    if min(rec["launches"][k] for k in ("lz_decode", "match_find",
                                        "chain_walk", "parse_tokens")) < 1:
        raise AssertionError(f"dryrun_multichip: launches {rec['launches']}")
    emit("entry", **rec)
    return rec


def oracle_phase(tld, th, runtime, smi: str) -> dict:
    """Phase 24: the oracle's streams and frames (ref/block_encode.py,
    frame.compress_frame: liblizard's bytes, serial on the host) decoded on
    the card. Every level 10-49: ORACLE_BYTES of gen (ORACLE_OPT_BYTES of
    tests/torch_cases.py::alphabet16 at the optimal-parser levels), a
    Huffman flag asserted in a block at 30-49; each family's streams
    decoded by one decompress_lanes call and each stream by api.decompress,
    all equal to the input and to the native decoder; lz_decode and
    huf_decode held against their plain versions on each family's staged
    batch. Linked frames of ORACLE_FRAME_BYTES at ORACLE_LINKED_LEVELS (a
    match crosses frame blocks: a later frame block does not decode alone)
    and an independent frame at ORACLE_FRAME_LEVEL with a content size,
    decoded by frame.decompress_frame, equal to the input and to the native
    frame decoder. Then C2: decode_frame_sharded over ["cuda:0"] * SHARDS
    raises FrameError for a content size one off, 4 junk bytes after the
    frame and a second frame appended (a -12 frame of C2_BYTES, one block:
    the all-XLA decoder takes a parse step a token), and decodes the frame
    itself. The kernels' calls are counted from 0 just before each path
    and read just after. Emits and returns the record."""
    import torch
    from lizard_tpu_torch import api
    from lizard_tpu_torch import frame as tframe
    from lizard_tpu_torch.errors import CorruptError
    from lizard_tpu_torch.format.constants import FLAG_FLAGS, FLAG_LITERALS
    from lizard_tpu_torch.format.levels import LEVELS
    from lizard_tpu_torch.ops.split import inner_block_spans
    from lizard_tpu_torch.parallel import pipeline as pp
    from lizard_tpu_torch.ref import block_decode, block_encode
    from lizard_tpu_torch.utils.datagen import gen
    from tests.torch_cases import alphabet16, is_optimal
    t_phase = time.perf_counter()
    plain_input = gen(ORACLE_BYTES, seed=24)
    opt_input = alphabet16(ORACLE_OPT_BYTES, 1)
    datas, streams, encode_s = {}, {}, {}
    for level in range(10, 50):
        datas[level] = opt_input if is_optimal(level) else plain_input
        t = time.perf_counter()
        streams[level] = block_encode.compress(datas[level], level)
        encode_s[level] = time.perf_counter() - t
        if level >= 30 and not any(
                streams[level][a] & (FLAG_FLAGS | FLAG_LITERALS)
                for a, _ in inner_block_spans(streams[level])):
            raise AssertionError(f"oracle level {level}: no Huffman stream")
        if runtime.decompress(streams[level],
                              len(datas[level])) != datas[level]:
            raise AssertionError(f"oracle level {level}: native decode")
    # [huf_decode, lz_decode] calls of each path
    launches = {"decompress_lanes": [0, 0], "api_decompress": [0, 0]}
    families = {}
    for level in streams:
        families.setdefault(LEVELS[level].codewords, []).append(level)
    errs = {"lz": 0, "huf": 0}
    plain = {}
    for fam, levels in families.items():
        ss = [streams[lv] for lv in levels]
        reset_counts()
        got = tld.decompress_lanes(ss)
        torch.cuda.synchronize()
        launches["decompress_lanes"][0] += counted("huf_decode.launches")
        launches["decompress_lanes"][1] += counted("lz_decode.launches")
        if got != [datas[lv] for lv in levels]:
            raise AssertionError(f"oracle {fam.name}: decompress_lanes")
        huf, rec = both_against_plain(th, tld, ss,
                                      f"oracle streams, {fam.name} levels")
        errs["lz"] = max(errs["lz"], rec["max_abs_err"])
        errs["huf"] = max(errs["huf"], huf["max_abs_err"])
        plain[fam.name] = {"lz_plain_ms": rec["plain_ms"],
                           "huf_plain_ms": huf["plain_ms"]}
    for level, s in streams.items():
        reset_counts()
        got = api.decompress(s)                       # device=None: card
        torch.cuda.synchronize()
        launches["api_decompress"][0] += counted("huf_decode.launches")
        launches["api_decompress"][1] += counted("lz_decode.launches")
        if got != datas[level]:
            raise AssertionError(f"oracle level {level}: api.decompress")
    if (launches["api_decompress"] != [20, 40]
            or launches["decompress_lanes"] != [2, 2]):
        raise AssertionError(f"oracle streams: launches {launches}")
    # frames of the oracle, decoded on the card
    fdata = gen(ORACLE_FRAME_BYTES, seed=25)
    kinds = [(f"linked -{lv}", lv, {"block_linked": True})
             for lv in ORACLE_LINKED_LEVELS]
    kinds.append((f"independent -{ORACLE_FRAME_LEVEL}", ORACLE_FRAME_LEVEL,
                  {"content_size": True}))
    launches["decompress_frame"] = [0, 0]
    frame_recs = {}
    for name, level, kw in kinds:
        t = time.perf_counter()
        fr = tframe.compress_frame(fdata, level, block_size_id=1, **kw)
        host_encode_s = time.perf_counter() - t
        info = tframe.parse_frame_header(fr)
        blocks = tframe._frame_blocks(fr, info.header_size)[0]
        if info.block_linked != name.startswith("linked"):
            raise AssertionError(f"oracle frame {name}: linked flag")
        reset_counts()
        got = tframe.decompress_frame(fr)             # device=None: card
        torch.cuda.synchronize()
        n = [counted("huf_decode.launches"), counted("lz_decode.launches")]
        launches["decompress_frame"] = [
            a + b for a, b in zip(launches["decompress_frame"], n)]
        if got != fdata or runtime.decompress_frame(fr, len(fdata)) != fdata:
            raise AssertionError(f"oracle frame {name}: decode != input")
        if n[1] != 1 or (level >= 30) != (n[0] == 1):
            raise AssertionError(f"oracle frame {name}: launches {n}")
        crossing = 0
        if info.block_linked:                   # later blocks need earlier
            for stored, blob in blocks[1:]:
                try:
                    if not stored:
                        block_decode.decompress(blob)
                except CorruptError:
                    crossing += 1
            if not crossing:
                raise AssertionError(f"oracle frame {name}: no match "
                                     "crosses a frame block")
        frame_recs[name] = {"host_encode_s": host_encode_s,
                            "frame_bytes": len(fr),
                            "frame_blocks": len(blocks),
                            "blocks_reaching_back": crossing,
                            "launches": n}
    # C2: the sharded frame decode refuses what decompress_frame refuses
    c2_frame = tframe.compress_frame(gen(C2_BYTES, seed=26), 12,
                                     content_size=True)
    size = bytearray(c2_frame)
    size[6:14] = (C2_BYTES + 1).to_bytes(8, "little")
    size[14] = (runtime.xxh32(bytes(size[4:14])) >> 8) & 0xFF
    devices = ["cuda:0"] * SHARDS
    c2 = {}
    for name, bad in (("content_size", bytes(size)),
                      ("junk", c2_frame + b"\x01\x02\x03\x04"),
                      ("second_frame", c2_frame + c2_frame)):
        try:
            pp.decode_frame_sharded(bad, devices)
        except tframe.FrameError as e:
            c2[name] = str(e)
        else:
            raise AssertionError(f"C2 {name}: decode_frame_sharded accepted")
    if pp.decode_frame_sharded(c2_frame, devices) != gen(C2_BYTES, seed=26):
        raise AssertionError("C2: the good frame did not decode")
    rec = {"levels": 40, "bytes": ORACLE_BYTES, "opt_bytes": ORACLE_OPT_BYTES,
           "compressed_bytes": {str(lv): len(s) for lv, s in streams.items()},
           "host_encode_s_by_level": {str(lv): v
                                      for lv, v in encode_s.items()},
           "host_encode_s": sum(encode_s.values()),
           "host": "the card machine's CPU (the oracle is serial Python)",
           "launches": launches, "max_abs_err": errs, "plain": plain,
           "frames": frame_recs, "c2_raised": c2,
           "phase_s": time.perf_counter() - t_phase, "card": smi}
    emit("oracle", **rec)
    return rec


def decode_batches(src: bytes, chunk: int) -> tuple[int, int]:
    """The decode calls FrameDecoder must make on `src` (frames,
    skippable ones included) fed `chunk` bytes an update, from the frame
    layout alone: one a (update, frame) pair in which a compressed block
    completes. Returns (all of them, those of frames at levels 30-49)."""
    from lizard_tpu_torch import frame as tframe
    pairs, huf = set(), set()
    p = f = 0
    while p < len(src):
        magic = int.from_bytes(src[p:p + 4], "little")
        if magic & 0xFFFFFFF0 == tframe.LIZARDF_MAGIC_SKIPPABLE_START:
            p += 8 + int.from_bytes(src[p + 4:p + 8], "little")
            continue
        info = tframe.parse_frame_header(src[p:])
        blocks, end = tframe._frame_blocks(src, p + info.header_size)
        q = p + info.header_size
        for stored, blob in blocks:
            q += 4 + len(blob)
            if not stored:
                pairs.add(((q - 1) // chunk, f))
                if blob[0] >= 30:
                    huf.add(((q - 1) // chunk, f))
        p, f = end + 4 * info.content_checksum, f + 1
    return len(pairs), len(huf)


def feed_decoder(tframe, src: bytes, chunk: int):
    """A FrameDecoder on the card fed `src` in `chunk`-byte updates:
    (the decoder, the joined output, host-clock ms end to end)."""
    t = time.perf_counter()
    dec = tframe.FrameDecoder()
    out = b"".join(dec.update(src[i:i + chunk])
                   for i in range(0, len(src), chunk))
    ms = (time.perf_counter() - t) * 1e3
    if dec.buf or not dec.finished:
        raise AssertionError("FrameDecoder: the input did not end a frame")
    return dec, out, ms


def incremental_phase(tld, th, te, teh, runtime, corpus: bytes,
                      smi: str) -> dict:
    """Phase 25: the incremental layer on the card. FrameDecoder on a
    linked -INC_LINKED_LEVEL frame of the corpus in 4 MB frame blocks
    (frame.linked_frame of a native stream) fed INC_CHUNK bytes an update:
    each block's chain headed by the window (the history staged reaches the
    16 MB cap from the fifth block on); on an independent -INC_INDEP_LEVEL
    frame (compress_frame_lanes) fed INC_BIG_CHUNK, then the same
    concatenated with skippable frames and a -10 frame; lz_decode and
    huf_decode calls counted from 0 for each run against decode_batches,
    outputs equal to the input and the native frame decoder, each run timed
    (median of INC_REPS) beside decompress_frame. DecompressStream on
    INC_STREAM_BYTES of CompressStream's -INC_STREAM_LEVEL streams (the
    oracle, host) a chunk a call, decompress_using_dict and
    decompress_partial. FrameEncoder(backend="gpu") at -INC_ENC_LEVEL over
    the corpus in INC_CHUNK updates: one call of each encoder kernel per
    update that completes a block, byte-equal to compress_frame_lanes,
    decoded natively. The CLI in subprocesses on a file of the corpus (-z
    -INC_INDEP_LEVEL, -d, -t) and its -BD round trip in this process.
    lz_decode against lz_decode_plain on a history-headed batch (INC_HISTORY
    of history and one 128 KB -21 block whose matches reach into it). Emits
    and returns the record."""
    import tempfile

    import torch
    from lizard_tpu_torch import cli
    from lizard_tpu_torch import frame as tframe
    from lizard_tpu_torch import streaming
    from lizard_tpu_torch.errors import CorruptError
    from lizard_tpu_torch.format.levels import Codewords
    from lizard_tpu_torch.ops.split import (
        finalize, inner_block_spans, new_accumulator, split_stored,
        split_stream)
    from lizard_tpu_torch.format.constants import LIZARDF_BLOCK_SIZES
    from lizard_tpu_torch.ref import block_decode
    t_phase = time.perf_counter()
    rec = {"launches": {}, "e2e_ms": {}, "card": smi}
    block = LIZARDF_BLOCK_SIZES[INC_BSID]

    def lanes_frame(data, level):
        return tframe.compress_frame_lanes(data, level,
                                           block_size_id=INC_BSID)

    def count_lz():
        torch.cuda.synchronize()
        return [counted("huf_decode.launches"), counted("lz_decode.launches")]

    def decoder_run(name, src, chunk, expect):
        reset_counts()
        dec, out, _ = feed_decoder(tframe, src, chunk)
        n = count_lz()
        want = list(reversed(decode_batches(src, chunk)))   # [huf, lz]
        if n != want or len(dec.restaged) != want[1]:
            raise AssertionError(f"FrameDecoder {name}: calls [huf, lz] {n}"
                                 f", batches {len(dec.restaged)}, expected "
                                 f"{want}")
        if out != expect:
            raise AssertionError(f"FrameDecoder {name}: output != input")
        runs = [feed_decoder(tframe, src, chunk)[2] for _ in range(INC_REPS)]
        rec["launches"][name] = n
        rec["e2e_ms"][name] = {"frame_decoder": statistics.median(runs),
                               "runs": runs}
        return dec

    def one_shot_ms(name, src):
        runs = []
        for _ in range(INC_REPS):
            t = time.perf_counter()
            tframe.decompress_frame(src)
            runs.append((time.perf_counter() - t) * 1e3)
        rec["e2e_ms"][name]["decompress_frame"] = statistics.median(runs)
    # FrameDecoder on a linked frame in 64 KB updates
    linked = tframe.linked_frame(runtime.compress(corpus, INC_LINKED_LEVEL),
                                 corpus, INC_BSID)
    if runtime.decompress_frame(linked, len(corpus)) != corpus:
        raise AssertionError("linked frame: native decode != input")
    dec = decoder_run("linked", linked, INC_CHUNK, corpus)
    one_shot_ms("linked", linked)
    want = [min(k * block, 1 << 24)
            for k in range(len(corpus) // block)]
    if dec.restaged != want:
        raise AssertionError(f"linked frame: history staged {dec.restaged}")
    rec["history_h2d_bytes_per_frame_block"] = dec.restaged
    # FrameDecoder on an independent frame in 1 MB updates, then a
    # concatenation with skippable frames
    indep = lanes_frame(corpus, INC_INDEP_LEVEL)
    if runtime.decompress_frame(indep, len(corpus)) != corpus:
        raise AssertionError("independent frame: native decode != input")
    decoder_run("independent", indep, INC_BIG_CHUNK, corpus)
    one_shot_ms("independent", indep)
    skip = (0x184D2A5A).to_bytes(4, "little") + (4096).to_bytes(
        4, "little") + bytes(4096)
    small = lanes_frame(corpus[:1 << 20], 10)
    cat = skip + indep + skip + small
    decoder_run("concatenated", cat, INC_BIG_CHUNK, corpus + corpus[:1 << 20])
    # DecompressStream: the oracle's chained streams, a chunk a call
    data = corpus[:INC_STREAM_BYTES]
    chunks = [data[i:i + INC_CHUNK] for i in range(0, len(data), INC_CHUNK)]
    t = time.perf_counter()
    cs = streaming.CompressStream(INC_STREAM_LEVEL)
    streams = [cs.compress_continue(c) for c in chunks]
    host_encode_s = time.perf_counter() - t
    reset_counts()
    t = time.perf_counter()
    ds = streaming.DecompressStream()
    got = [ds.decompress_continue(s, len(c)) for s, c in zip(streams, chunks)]
    stream_ms = (time.perf_counter() - t) * 1e3
    n = count_lz()
    if got != chunks or n != [0, len(chunks)]:
        raise AssertionError(f"DecompressStream: calls [huf, lz] {n}")
    rec["launches"]["decompress_stream"] = n
    k = len(chunks) // 2
    if streaming.decompress_using_dict(streams[k], INC_CHUNK,
                                       data[:k * INC_CHUNK]) != chunks[k]:
        raise AssertionError("decompress_using_dict != input")
    if streaming.decompress_partial(streams[k], 1000, INC_CHUNK,
                                    data[:k * INC_CHUNK]) != chunks[k][:1000]:
        raise AssertionError("decompress_partial != input")
    rec["decompress_stream"] = {
        "bytes": len(data), "calls": len(chunks), "level": INC_STREAM_LEVEL,
        "host_encode_s": host_encode_s, "e2e_ms": stream_ms}
    # FrameEncoder(backend="gpu") over the corpus in 64 KB updates
    reset_counts()
    t = time.perf_counter()
    enc = tframe.FrameEncoder(INC_ENC_LEVEL, INC_BSID)
    fr = bytearray(enc.begin())
    for i in range(0, len(corpus), INC_CHUNK):
        fr += enc.update(corpus[i:i + INC_CHUNK])
    fr += enc.end()
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t) * 1e3
    got = enc_launches()
    calls = len(corpus) // block
    cfg = te.cfg_for_level(INC_ENC_LEVEL)
    if got != (calls, calls if cfg.chain else 0, calls,
               calls if te.huffman_level(INC_ENC_LEVEL) else 0):
        raise AssertionError(f"FrameEncoder: encoder kernel calls {got}")
    rec["launches"]["frame_encoder"] = dict(zip(ENC_WRAPPERS, got))
    t = time.perf_counter()
    one_shot = lanes_frame(corpus, INC_ENC_LEVEL)
    lanes_ms = (time.perf_counter() - t) * 1e3
    if bytes(fr) != one_shot:
        raise AssertionError("FrameEncoder != compress_frame_lanes")
    if runtime.decompress_frame(bytes(fr), len(corpus)) != corpus:
        raise AssertionError("FrameEncoder: native decode != input")
    rec["frame_encoder"] = {"level": INC_ENC_LEVEL, "frame_bytes": len(fr),
                            "e2e_ms": enc_ms, "compress_frame_lanes_ms":
                            lanes_ms}
    # the CLI: -z, -d and -t in subprocesses on a file of the corpus, and
    # a -BD round trip here
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        src, liz, back = (os.path.join(tmp, n) for n in
                          ("corpus.bin", "corpus.liz", "corpus.out"))
        with open(src, "wb") as f:
            f.write(corpus)
        cli_s = {}
        for name, args in (("z", ["-z", f"-{INC_INDEP_LEVEL}",
                                  f"-B{INC_BSID}", src, liz]),
                           ("d", ["-d", liz, back]), ("t", ["-t", liz])):
            t = time.perf_counter()
            subprocess.run([sys.executable, "-m", "lizard_tpu_torch.cli",
                            "-f", "-q", *args], cwd=here, check=True,
                           timeout=300)
            cli_s[name] = time.perf_counter() - t
        with open(liz, "rb") as f:
            if f.read() != indep:
                raise AssertionError("cli -z != compress_frame_lanes")
        with open(back, "rb") as f:
            if f.read() != corpus:
                raise AssertionError("cli -d != input")
        with open(src, "wb") as f:
            f.write(corpus[:INC_BD_BYTES])
        t = time.perf_counter()
        cli.main(["-z", "-BD", "-B1", "-f", "-q", src, liz])
        cli_s["BD_z"] = time.perf_counter() - t
        with open(liz, "rb") as f:
            if tframe.parse_frame_header(f.read(15)).block_linked is not True:
                raise AssertionError("cli -BD: not a linked frame")
        reset_counts()
        t = time.perf_counter()
        cli.main(["-d", "-f", "-q", liz, back])
        cli_s["BD_d"] = time.perf_counter() - t
        rec["launches"]["cli_linked"] = count_lz()
        with open(back, "rb") as f:
            if f.read() != corpus[:INC_BD_BYTES]:
                raise AssertionError("cli -BD round trip != input")
    rec["cli_s"] = cli_s
    # lz_decode against plain on a history-headed batch: the last inner
    # block of a -21 stream of INC_HISTORY + 128 KB, headed by the history
    s = runtime.compress(corpus[:INC_HISTORY + BLOCK], 21)
    a, b = inner_block_spans(s)[-1]
    tail = s[:1] + s[a:b]
    try:
        block_decode.decompress(tail)
        raise AssertionError("history batch: no match reaches the history")
    except CorruptError:
        pass
    acc = new_accumulator()
    split_stored(corpus[:INC_HISTORY], acc, 0)
    split_stream(tail, acc, 0)
    args = tld.stage_batch(finalize(acc, Codewords.LIZv1), "cuda")
    rec["history_vs_plain"] = hold_against_plain(
        tld, args, "history-headed batch, -21")
    got = tframe.decode_blocks([(False, tail)], True, "cuda",
                               history=corpus[:INC_HISTORY])
    if got != [corpus[INC_HISTORY:INC_HISTORY + BLOCK]]:
        raise AssertionError("history-headed decode != input")
    rec["phase_s"] = time.perf_counter() - t_phase
    emit("incremental", **rec)
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lizard_tpu_torch as ltt
    from lizard_tpu_torch import runtime
    from lizard_tpu_torch.errors import CorruptError
    from lizard_tpu_torch.format.constants import LIZARDF_BLOCK_SIZES
    from lizard_tpu_torch.frame import (compress_frame_fast,
                                        compress_frame_lanes)
    from lizard_tpu_torch.ops import _build
    from lizard_tpu_torch.ops import enc_huf as teh
    from lizard_tpu_torch.ops import enc_lanes as te
    from lizard_tpu_torch.ops import huf128 as th
    from lizard_tpu_torch.ops import lane_decode as tld
    from lizard_tpu_torch.ops import lane_huf as tlh
    from lizard_tpu_torch.ops import pallas_decode as tpd
    from lizard_tpu_torch.ops.fuse import build_fused_plan
    from lizard_tpu_torch.ops.huf128 import huf_decode, prepare_huf128
    from lizard_tpu_torch.ops.lane_decode import (
        decode_batch_lanes, decompress_lanes, lz_decode, stage_batch)
    from lizard_tpu_torch.ops.split import (
        STREAMS, new_accumulator, split_into, split_streams)
    from lizard_tpu_torch.ref.huf import huf_read_stats
    from lizard_tpu_torch.utils.datagen import (
        build_corpus, build_corpus_realfiles, gen)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    emit("device", kind=kind, count=count, torch=torch.__version__,
         cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build: the kernels (one nvcc per source, all started together),
    # then the native host runtime (g++) if it is missing
    t0 = time.perf_counter()
    logs = _build.build()
    for name in _build.sources():
        _build.load(name)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runtime.xxh32(b"")
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("build", seconds=build_s, native_seconds=time.perf_counter() - t0,
         kernels=_build.sources(), ptxas=ptxas)

    # 3. full-size decode at levels 10 and 21
    corpus = build_corpus(CORPUS_BYTES)
    chunks = [corpus[i:i + BLOCK] for i in range(0, len(corpus), BLOCK)]
    main_launches = main_kernel_launches = 0
    timing = {}
    deferred = {}
    staged = {}
    for level in MAIN_LEVELS:
        streams = [runtime.compress(c, level) for c in chunks]
        comp = sum(map(len, streams))
        reset_counts()
        outs = decompress_lanes(streams)          # the card: device=None
        torch.cuda.synchronize()
        launches = counted("lz_decode.launches")
        main_kernel_launches += counted("lz_decode.kernel_launches")
        if b"".join(outs) != corpus:
            raise AssertionError(f"level {level}: decode != corpus")
        if launches < 1:
            raise AssertionError(f"level {level}: lz_decode never launched")
        main_launches += launches
        e2e_runs = e2e_ms(decompress_lanes, streams)
        e2e_s = statistics.median(e2e_runs) / 1e3
        # the same path once more, step by step: host split, H2D, kernel,
        # D2H (each step synchronised), then decode_batch_lanes whole (the
        # last three steps plus cutting the output into blocks)
        steps = {}
        t = time.perf_counter()
        batch = split_streams(streams)
        steps["split_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        args = stage_batch(batch, "cuda")
        torch.cuda.synchronize()
        steps["h2d_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        out, block_len, _ = lz_decode(**args)
        torch.cuda.synchronize()
        steps["kernel_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        out.cpu(), block_len.cpu()
        steps["d2h_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        decode_batch_lanes(batch)
        steps["decode_batch_lanes_ms"] = (time.perf_counter() - t) * 1e3
        staged[level] = (streams, args)
        prof = lz_profile(tld, args, len(corpus), KERNEL_REPS)
        k_ms = prof.pop("kernel_ms")
        bound_ms = lz_floor_ms(args, len(corpus))
        timing[level] = {"ms": k_ms, "bound_ms": bound_ms}
        deferred[level] = prof["deferred_share"]
        emit("decode", level=level, streams=len(streams),
             compressed_bytes=comp, decoded_bytes=len(corpus),
             launches=launches, kernel_ms=k_ms, **prof,
             kernel_gbps=len(corpus) / k_ms / 1e6,
             e2e_ms=e2e_s * 1e3, e2e_gbps=len(corpus) / e2e_s / 1e9,
             e2e_runs_ms=e2e_runs, hbm_floor_ms=bound_ms, steps=steps,
             card=smi)
    # the first level's end-to-end time again, after the other level's
    again = e2e_ms(decompress_lanes, staged[MAIN_LEVELS[0]][0])
    emit("decode_again", level=MAIN_LEVELS[0],
         e2e_ms=statistics.median(again), e2e_runs_ms=again)

    # 4. Huffman full-size decode at levels 35 and 41: huf_decode then
    # lz_decode on the card
    huf_launches = 0
    huf_timing = {}
    for level in HUF_LEVELS:
        streams = [runtime.compress(c, level) for c in chunks]
        comp = sum(map(len, streams))
        reset_counts()
        outs = decompress_lanes(streams)          # the card
        torch.cuda.synchronize()
        launches = (counted("huf_decode.launches"),
                    counted("lz_decode.launches"))
        main_kernel_launches += counted("lz_decode.kernel_launches")
        if b"".join(outs) != corpus:
            raise AssertionError(f"level {level}: decode != corpus")
        if min(launches) < 1:
            raise AssertionError(f"level {level}: a kernel never launched "
                                 f"(huf, lz launches {launches})")
        huf_launches += launches[0]
        main_launches += launches[1]
        e2e_runs = e2e_ms(decompress_lanes, streams)
        # the steps, each synchronised: split with the Huff0 plan (of which
        # the plan alone: header parse and table build; and of that the
        # weights headers alone), H2D, huf kernel, LZ kernel, D2H of the
        # output buffer
        steps = {}
        t = time.perf_counter()
        batch, plan = build_fused_plan(streams)
        steps["split_and_plan_ms"] = (time.perf_counter() - t) * 1e3
        blobs = []
        split_into(streams, new_accumulator(),
                   lambda b, n, k: blobs.append((b, n)) or bytes(n))
        t = time.perf_counter()
        prepare_huf128(blobs)
        steps["of_which_plan_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        for blob, n in blobs:               # the weights headers alone
            if 1 < len(blob) < n:
                huf_read_stats(blob)
        steps["of_which_headers_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        args = stage_batch(batch, "cuda")
        hargs = {**plan.stage("cuda"), **{k: args[k] for k in STREAMS}}
        torch.cuda.synchronize()
        steps["h2d_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        status = huf_decode(**hargs)
        torch.cuda.synchronize()
        steps["huf_kernel_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        out, block_len, _ = lz_decode(**args)
        torch.cuda.synchronize()
        steps["lz_kernel_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        out.cpu(), block_len.cpu(), status.cpu()
        steps["d2h_ms"] = (time.perf_counter() - t) * 1e3
        huf_ms = cuda_ms(lambda: huf_decode(**hargs), KERNEL_REPS)
        lz_ms = cuda_ms(lambda: lz_decode(**args), KERNEL_REPS)
        sync = huf_sync(th, hargs)
        hread, hwritten = huf_floor_bytes(plan)
        huf_bound = (hread + hwritten) / HBM_BYTES_PER_S * 1e3
        lz_bound = lz_floor_ms(args, len(corpus))
        huf_timing[level] = {"ms": huf_ms, "bound_ms": huf_bound,
                             "sync": sync}
        timing[level] = {"ms": lz_ms, "bound_ms": lz_bound}
        staged[level] = (streams, args)
        emit("huffman_decode", level=level, streams=len(streams),
             compressed_bytes=comp, decoded_bytes=len(corpus),
             huf_blobs=int(plan.table_log.numel()),
             huf_segments=int(plan.segs.shape[0]),
             huf_decoded_bytes=hwritten - 4 * plan.segs.shape[0],
             huf_blob_bytes=plan.data.numel(),
             longest_segment=int(plan.segs[:, 4].max()),
             table_logs=sorted(set(plan.table_log.tolist())),
             huf_launches=launches[0], lz_launches=launches[1],
             huf_kernel_ms=huf_ms, lz_kernel_ms=lz_ms,
             huf_hbm_floor_ms=huf_bound, lz_hbm_floor_ms=lz_bound,
             huf_sync=sync,
             e2e_ms=statistics.median(e2e_runs), e2e_runs_ms=e2e_runs,
             e2e_gbps=len(corpus) / statistics.median(e2e_runs) / 1e6,
             steps=steps, card=smi)

    # 5. kernel against plain, on the card: the first PLAIN_STREAMS streams
    # of each main level's batch; at the Huffman levels both kernels, on the
    # route's own inputs. The sweep and the frames below are held against
    # them too, each at its own shape, after its own run of the path.
    plain_ms = {}
    huf_plain_ms = {}
    max_err = huf_err = 0
    part = f"the first {PLAIN_STREAMS} of {len(chunks)} x 128 KB streams"
    for level in MAIN_LEVELS:
        args = stage_batch(split_streams(staged[level][0][:PLAIN_STREAMS]),
                           "cuda")
        rec = hold_against_plain(tld, args, f"level {level}, {part}")
        plain_ms[level] = rec["plain_ms"]
        max_err = max(max_err, rec["max_abs_err"])
    for level in HUF_LEVELS:
        huf, rec = both_against_plain(th, tld,
                                      staged[level][0][:PLAIN_STREAMS],
                                      f"level {level}, {part}")
        plain_ms[level] = rec["plain_ms"]
        huf_plain_ms[level] = huf["plain_ms"]
        max_err = max(max_err, rec["max_abs_err"])
        huf_err = max(huf_err, huf["max_abs_err"])

    # 6. level sweep, ~1 MB each
    sweep = corpus[:8 * BLOCK]
    sweep_launches = [0, 0]                     # huf_decode, lz_decode
    for level in SWEEP_LEVELS:
        streams = [runtime.compress(sweep[i:i + BLOCK], level)
                   for i in range(0, len(sweep), BLOCK)]
        reset_counts()
        outs = decompress_lanes(streams)
        torch.cuda.synchronize()
        launches = (counted("huf_decode.launches"),
                    counted("lz_decode.launches"))
        if (b"".join(outs) != sweep or launches[1] < 1
                or (level >= 30) != (launches[0] >= 1)):
            raise AssertionError(f"sweep level {level} failed "
                                 f"(huf, lz launches {launches})")
        sweep_launches = [a + b for a, b in zip(sweep_launches, launches)]
        huf, rec = both_against_plain(th, tld, streams,
                                      f"sweep level {level}")
        max_err = max(max_err, rec["max_abs_err"])
        huf_err = max(huf_err, huf["max_abs_err"] if huf else 0)
        emit("sweep", level=level, bytes=len(sweep), launches=launches[1],
             huf_launches=launches[0],
             route=("gpu: huf_decode then lz_decode" if level >= 30
                    else "gpu: lz_decode (no Huffman stage)"))

    # 7. frames
    a = gen(1_500_000, seed=1, proba=0.5)
    far = (a + gen(1_200_000, seed=2, proba=0.5) + a)[:4 << 20]
    frame_launches = [0, 0]                     # huf_decode, lz_decode
    for level, bsid, data in ((21, 4, far), (41, 4, far),
                              (10, 1, corpus[:2 << 20])):
        frame = compress_frame_fast(data, level, block_size_id=bsid)
        reset_counts()
        got = ltt.decompress_frame(frame)
        torch.cuda.synchronize()
        launches = (counted("huf_decode.launches"),
                    counted("lz_decode.launches"))
        if (got != data or launches[1] < 1
                or (level >= 30) != (launches[0] >= 1)):
            raise AssertionError(f"frame level {level} bsid {bsid} failed")
        frame_launches = [a + b for a, b in zip(frame_launches, launches)]
        # the kernels' inputs on this path: the frame's compressed blocks,
        # made as compress_frame_fast makes them (stored blocks are copied)
        size = LIZARDF_BLOCK_SIZES[bsid]
        parts = [data[i:i + size] for i in range(0, len(data), size)]
        streams = [s for s, part in
                   ((runtime.compress(part, level), part) for part in parts)
                   if len(s) < len(part)]
        batch = split_streams(streams)
        if bsid == 4 and batch.off24.numel() == 0:
            raise AssertionError(f"the 4 MB level-{level} block has no "
                                 "off24 matches")
        huf, rec = both_against_plain(th, tld, streams,
                                      f"frame level {level} bsid {bsid}")
        max_err = max(max_err, rec["max_abs_err"])
        huf_err = max(huf_err, huf["max_abs_err"] if huf else 0)
        emit("frame", level=level, block_size_id=bsid, bytes=len(data),
             frame_bytes=len(frame), launches=launches[1],
             huf_launches=launches[0], inner_blocks=rec["inner_blocks"],
             huf_segments=huf["segments"] if huf else 0,
             off24_bytes=int(batch.off24.numel()))

    # 8. corruption: each case must raise CorruptError
    raised = corruption_cases(staged, runtime, decompress_lanes, CorruptError)
    if ltt.decompress(staged[10][0][0]) != corpus[:BLOCK]:
        raise AssertionError("a valid decode failed after the corrupt ones")
    if ltt.decompress(staged[41][0][0]) != corpus[:BLOCK]:
        raise AssertionError("a valid Huffman decode failed after the "
                             "corrupt ones")
    torch.cuda.synchronize()
    emit("corruption", raised=raised)

    # 9. full-size encode on the card at 11, 21, 35 and 49
    enc = {level: encode_level(te, teh, tld, runtime, chunks, level, smi)
           for level in ENC_LEVELS}

    # 10. encoder kernels against plain at full width, each level
    enc_err = dict.fromkeys(ENC_WRAPPERS, 0)
    enc_plain_ms = {k: {} for k in enc_err}

    def note(level, rec, full=False):
        for k, (err, ms) in rec.items():
            enc_err[k] = max(enc_err[k], err)
            if full:
                enc_plain_ms[k][level] = ms

    for level in ENC_LEVELS:
        note(level, encode_against_plain(
            te, teh, chunks, level, f"level {level}, {len(chunks)} x 128 KB"),
            full=True)

    # 11. encode sweep: every level at ~1 MB on the card, decoded back;
    # one level per distinct tier against the plain versions
    sweep_chunks = [sweep[i:i + BLOCK] for i in range(0, len(sweep), BLOCK)]
    for level in range(10, 50):
        cfg = te.cfg_for_level(level)
        reset_counts()
        streams = te.encode_blocks_lanes(sweep_chunks, level)
        torch.cuda.synchronize()
        launches = check_enc_launches(te, cfg, level,
                                      f"encode sweep {level}")
        if (decompress_lanes(streams) != sweep_chunks
                or [runtime.decompress(s, BLOCK) for s in streams]
                != sweep_chunks):
            raise AssertionError(f"encode sweep level {level}: round trip")
        if level in ENC_TIER_LEVELS:
            note(level, encode_against_plain(te, teh, sweep_chunks, level,
                                             f"encode sweep level {level}"))
        emit("encode_sweep", level=level, bytes=len(sweep),
             compressed_bytes=sum(map(len, streams)), launches=launches,
             against_plain=level in ENC_TIER_LEVELS)

    # 12. edge blocks and a frame, compressed on the card
    import numpy as np
    rng = np.random.default_rng(7)
    edge = [gen(size, seed=size, proba=0.5)
            for size in (0, 1, 20, 21, 22, 4097)]
    edge += [b"\x07" * BLOCK, rng.integers(0, 256, BLOCK, np.uint8).tobytes(),
             rng.integers(0, 4, BLOCK, np.uint8).tobytes(), one_flag_block()]
    for level in (11, 21, 49):
        cfg = te.cfg_for_level(level)
        reset_counts()
        streams = te.encode_blocks_lanes(edge, level)
        torch.cuda.synchronize()
        launches = check_enc_launches(te, cfg, level,
                                      f"edge blocks {level}")
        if (decompress_lanes(streams) != edge
                or [runtime.decompress(s, max(len(d), 1))
                    for s, d in zip(streams, edge)] != edge):
            raise AssertionError(f"edge blocks level {level}: round trip")
        if streams[7][1] != 0x80:
            raise AssertionError("the random block was not stored")
        # against plain at 11 and 49 only: the plain parse of the 4-symbol
        # block takes ~60 s a level
        if level != 21:
            note(level, encode_against_plain(te, teh, edge, level,
                                             f"edge blocks level {level}"))
        gates = huf_gates(streams[7:]) if level == 49 else None
        if gates is not None and (gates[0] != "stored"
                                  or "coded" not in gates[1].values()
                                  or gates[2] != {"flags": "rle",
                                                  "literals": "raw"}):
            raise AssertionError(f"edge blocks level 49: Huff0 gates {gates}")
        emit("encode_edge", level=level, sizes=[len(d) for d in edge],
             compressed=[len(s) for s in streams], launches=launches,
             huf_gates=gates)
    # the blocks that bound parse_tokens (a run of one byte, random bytes,
    # matches ending at segment boundaries, lengths 21, 22, 149 and
    # 128 KB - 1, an off24 repeat) at the four full-size levels: encoded on
    # the card and decoded back, and the kernels against plain
    from tests.torch_cases import parse_edge_blocks
    pblocks = parse_edge_blocks(BLOCK)
    for level in ENC_LEVELS:
        cfg = te.cfg_for_level(level)
        reset_counts()
        streams = te.encode_blocks_lanes(pblocks, level)
        torch.cuda.synchronize()
        launches = check_enc_launches(te, cfg, level,
                                      f"parse edge blocks {level}")
        if decompress_lanes(streams) != pblocks:
            raise AssertionError(f"parse edge blocks level {level}: round "
                                 "trip")
        note(level, encode_against_plain(te, teh, pblocks, level,
                                         f"parse edge blocks level {level}"))
    # the blocks that bound match_find and chain_walk (a run, planted
    # buckets, lengths 20-22, 1000 and 128 KB - 77, far repeats at the far
    # table's edges, periods of 128 (also with a count every 8 bytes), 1100
    # and 136) at the four full-size
    # levels: round trip and kernels against plain, chain_walk also on
    # maps whose walks run into the zero pad
    from tests.torch_cases import chain_tail_maps, match_edge_blocks
    for level in ENC_LEVELS:
        cfg = te.cfg_for_level(level)
        mblocks = match_edge_blocks(cfg.n, cfg.far_dist)
        reset_counts()
        streams = te.encode_blocks_lanes(mblocks, level)
        torch.cuda.synchronize()
        check_enc_launches(te, cfg, level, f"match edge blocks {level}")
        if decompress_lanes(streams) != mblocks:
            raise AssertionError(f"match edge blocks level {level}: round "
                                 "trip")
        note(level, encode_against_plain(te, teh, mblocks, level,
                                         f"match edge blocks level {level}"))
        if cfg.chain:
            data, lens = te.pack_blocks(mblocks, cfg, "cuda")
            tail = chain_tail_maps(te.match_find(data, lens, cfg))
            won = te.chain_walk(data, lens, tail, cfg)
            err = int((won.long() - te.chain_walk_plain(
                data, lens, tail, cfg).long()).abs().max())
            enc_err["chain_walk"] = max(enc_err["chain_walk"], err)
            if err > ENC_TOLERANCE:
                raise AssertionError(f"chain_walk on tail maps differs "
                                     f"from plain by {err}")
            emit("chain_tail_maps", level=level, max_abs_err=err)
    # the plans that bound huf_pack's split, against plain
    from tests.torch_cases import huf_pack_against_plain
    hp = huf_pack_against_plain("cuda")
    enc_err["huf_pack"] = max(enc_err["huf_pack"], hp["max_abs_err"])
    emit("huf_pack_cases", **{k: hp[k] for k in (
        "cases", "segments", "statuses", "max_abs_err", "plain_ms",
        "calls")})
    for level in (21, 41):
        reset_counts()
        frame = compress_frame_lanes(far, level, block_size_id=4)
        torch.cuda.synchronize()
        launches = check_enc_launches(te, te.cfg_for_level(level),
                                      level, f"frame -{level}")
        reset_counts()
        if (ltt.decompress_frame(frame) != far
                or counted("lz_decode.launches") < 1):
            raise AssertionError(f"the -{level} frame compressed on the card "
                                 "did not decode")
        emit("encode_frame", level=level, block_size_id=4, bytes=len(far),
             frame_bytes=len(frame), launches=launches)

    # 13. slot-layout batch decode of the full-size batches
    pb = {level: pallas_batch(tld, tpd, split_streams, level,
                              staged[level][0], chunks, smi)
          for level in MAIN_LEVELS}

    # 14. one 8 MB stream: one chain of 64 inner blocks
    ps = {level: pallas_stream(tld, th, tpd, runtime, split_streams, level,
                               corpus[:STREAM_BYTES], smi)
          for level in STREAM_LEVELS}
    max_err = max(max_err, ps[21]["against_plain"]["max_abs_err"])

    # 15. batch Huff0 decode of the level-41 batch's blobs, tableLog 12, RLE
    lh = lane_huf(th, tlh, runtime, split_into, new_accumulator,
                  staged[HUF_LEVELS[-1]][0], smi)
    huf_err = max(huf_err, lh["max_abs_err"])
    # and the blobs that bound huf_decode's lane split, against plain
    ls = huf_lane_split(th)
    huf_err = max(huf_err, ls["max_abs_err"])

    # 16. real files at level 49, the whole batch and streams 112-128
    rf = realfiles(tld, th, runtime, decompress_lanes,
                   build_corpus_realfiles, smi)

    # 17. a linked frame of the whole corpus: one chain of 256 inner blocks
    lf = linked(tld, runtime, corpus, smi)

    # 18-23: the sharded paths over one card and the all-XLA paths
    from lizard_tpu_torch import entry
    from lizard_tpu_torch import frame as tframe
    from lizard_tpu_torch.ops import decode as xd
    from lizard_tpu_torch.ops import encode_tpu as xe
    from lizard_tpu_torch.parallel import multihost as pm
    from lizard_tpu_torch.parallel import pipeline as pp
    from lizard_tpu_torch.utils import profiling
    # 18. sharded lane decode, one card and SHARDS shards on it
    sl = {level: sharded_lanes(pp, tld, th, profiling, level,
                               staged[level][0], corpus, smi)
          for level in SHARDED_LEVELS}
    # 19. the all-XLA decoder through decode_streams_sharded
    xdec = {level: xla_decode(pp, xd, profiling, level, staged[level][0],
                              corpus, smi)
            for level in XLA_LEVELS}
    # 20. the all-XLA encoder beside the device encoder
    xenc = xla_encode(xe, te, tld, runtime, tframe, ltt, profiling, chunks,
                      corpus, smi)
    # 21. sharded encode over SHARDS shards on the card
    se = {level: sharded_encode(pp, te, teh, tld, profiling, chunks, level,
                                smi)
          for level in SHARDED_ENC_LEVELS}
    # 22. decode_streams_global over a one-rank NCCL group
    ng = nccl_global(pm, staged[XLA_LEVELS[-1]][0], chunks, smi)
    # 23. entry() and dryrun_multichip over SHARDS shards on the card
    ep = entry_phase(entry, te, teh, tld, th)
    enc_paths = {w: {"encode_blocks_sharded": sum(r["launches"][w]
                                                  for r in se.values()),
                     "dryrun_multichip": ep["launches"][w]}
                 for w in ENC_WRAPPERS}

    # 24. the oracle's streams at every level and its frames, on the card;
    # C2 on the card
    oc = oracle_phase(tld, th, runtime, smi)
    max_err = max(max_err, oc["max_abs_err"]["lz"])
    huf_err = max(huf_err, oc["max_abs_err"]["huf"])
    oracle_paths = {f"oracle_{k}": v for k, v in oc["launches"].items()}

    # 25. the incremental layer on the card: FrameDecoder, DecompressStream,
    # FrameEncoder(backend="gpu"), the CLI
    inc = incremental_phase(tld, th, te, teh, runtime, corpus, smi)
    max_err = max(max_err, inc["history_vs_plain"]["max_abs_err"])
    il = inc["launches"]
    inc_paths = {"frame_decoder": [sum(il[k][i] for k in (
                     "linked", "independent", "concatenated"))
                     for i in (0, 1)],
                 "decompress_stream": il["decompress_stream"],
                 "cli_linked": il["cli_linked"]}
    for w in ENC_WRAPPERS:
        enc_paths[w]["frame_encoder"] = il["frame_encoder"][w]

    # 26. kernels line: launches summed over every path's run, counted
    # (utils/profiling.py's counters) from 0 just before it and read just
    # after
    lz_paths = {"decompress_lanes": main_launches,
                "sweep": sweep_launches[1],
                "decompress_frame": frame_launches[1],
                "decode_batch_pallas": sum(r["launches"]
                                           for r in pb.values()),
                "decompress_pallas": sum(r["launches"] for r in ps.values()),
                "realfiles": rf["launches"]["lz_decode"] if rf else 0,
                "linked_frame": lf["launches"],
                "decode_streams_sharded_lanes": sum(
                    n["lz_decode"] for r in sl.values()
                    for n in r["launches"].values()),
                "dryrun_multichip": ep["launches"]["lz_decode"],
                **{k: v[1] for k, v in oracle_paths.items()},
                **{k: v[1] for k, v in inc_paths.items()}}
    lz_kernel_paths = {
        "decompress_lanes": main_kernel_launches,
        "decode_batch_pallas": sum(r["kernel_launches"] for r in pb.values()),
        "decompress_pallas": sum(r["kernel_launches"] for r in ps.values()),
        "realfiles": rf["launches"]["lz_decode_kernels"] if rf else 0,
        "linked_frame": lf["kernel_launches"]}
    huf_paths = {"decompress_lanes": huf_launches,
                 "sweep": sweep_launches[0],
                 "decompress_frame": frame_launches[0],
                 "huf_decompress_lanes": lh["launches"],
                 "realfiles": rf["launches"]["huf_decode"] if rf else 0,
                 "decode_streams_sharded_lanes": sum(
                     n["huf_decode"] for r in sl.values()
                     for n in r["launches"].values()),
                 "dryrun_multichip": ep["launches"]["huf_decode"],
                 **{k: v[0] for k, v in oracle_paths.items()},
                 **{k: v[0] for k, v in inc_paths.items()}}
    t10 = timing[MAIN_LEVELS[0]]
    h41 = huf_timing[HUF_LEVELS[-1]]
    print(json.dumps({"kernels": [{
        "name": "lz_decode",
        "route": "cuda",
        "source": "lizard_tpu_torch/csrc/lz_decode.cu",
        "replaces": "lizard_tpu/ops/lane_decode.py:328::_lane_kernel + "
                    "lizard_tpu/ops/pallas_decode.py:171::_lz4_block_kernel"
                    " + lizard_tpu/ops/pallas_decode.py:304::"
                    "_liz_block_kernel",
        "launches": sum(lz_paths.values()),
        "launches_by_path": lz_paths,
        # kernels launched by the wrapper, counted in the same runs
        "kernel_launches_by_path": lz_kernel_paths,
        "kernel_launches_per_call_by_path": {
            k: v / lz_paths[k] if lz_paths[k] else None
            for k, v in lz_kernel_paths.items()},
        "max_abs_err": max_err,
        "tolerance": PLAIN_TOLERANCE,
        "matches_plain": max_err <= PLAIN_TOLERANCE,
        "ms": t10["ms"],
        "plain_ms": plain_ms[MAIN_LEVELS[0]],
        "bound_ms": t10["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": f"level {MAIN_LEVELS[0]}, {len(chunks)} chains x 128 KB",
        "plain_shape": part,
        "ms_by_level": {str(lv): timing[lv]["ms"] for lv in timing},
        "plain_ms_by_level": {str(lv): plain_ms[lv] for lv in plain_ms},
        "bound_ms_by_level": {str(lv): timing[lv]["bound_ms"]
                              for lv in timing},
        "ms_by_path": {
            "decode_batch_pallas": {str(lv): r["kernel_ms"]
                                    for lv, r in pb.items()},
            "decompress_pallas": {str(lv): r["kernel_ms"]
                                  for lv, r in ps.items()},
            "decompress_frame_linked": {str(LINKED_LEVEL): lf["kernel_ms"]}},
        "deferred_share_by_path": {
            "decompress_lanes": {str(lv): deferred[lv] for lv in deferred},
            "decode_batch_pallas": {str(lv): r["deferred_share"]
                                    for lv, r in pb.items()},
            "decompress_pallas": {str(lv): r["deferred_share"]
                                  for lv, r in ps.items()},
            "decompress_frame_linked": {
                str(LINKED_LEVEL): lf["deferred_share"]}},
        "plain_ms_by_path": {"decompress_pallas": {
            "21": ps[21]["against_plain"]["plain_ms"]}},
        "bound_ms_by_path": {
            "decode_batch_pallas": {str(lv): r["hbm_floor_ms"]
                                    for lv, r in pb.items()},
            "decompress_pallas": {str(lv): r["hbm_floor_ms"]
                                  for lv, r in ps.items()},
            "decompress_frame_linked": {
                str(LINKED_LEVEL): lf["hbm_floor_ms"]}},
    }, {
        "name": "huf_decode",
        "route": "cuda",
        "source": "lizard_tpu_torch/csrc/huf_decode.cu",
        "replaces": "lizard_tpu/ops/huf128.py:83::_huf128_kernel + "
                    "lizard_tpu/ops/huf128.py:407::_translate_kernel + "
                    "lizard_tpu/ops/fuse.py:58::_compact_kernel + "
                    "lizard_tpu/ops/lane_huf.py:88::_huf_lane_kernel",
        "launches": sum(huf_paths.values()),
        "launches_by_path": huf_paths,
        "max_abs_err": huf_err,
        "tolerance": PLAIN_TOLERANCE,
        "matches_plain": huf_err <= PLAIN_TOLERANCE,
        "ms": h41["ms"],
        "plain_ms": huf_plain_ms[HUF_LEVELS[-1]],
        "bound_ms": h41["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "plain_shape": f"the Huff0 blobs of {part}",
        "shape": f"level {HUF_LEVELS[-1]}, the Huff0 blobs of "
                 f"{len(chunks)} x 128 KB streams",
        "ms_by_level": {str(lv): huf_timing[lv]["ms"] for lv in HUF_LEVELS},
        "plain_ms_by_level": {str(lv): huf_plain_ms[lv] for lv in HUF_LEVELS},
        "bound_ms_by_level": {str(lv): huf_timing[lv]["bound_ms"]
                              for lv in HUF_LEVELS},
        "ms_by_path": {"huf_decompress_lanes": lh["kernel_ms"]},
        "sync_by_level": {str(lv): huf_timing[lv]["sync"]
                          for lv in HUF_LEVELS},
        "lane_split_max_rounds": ls["max_rounds_by_case"],
        "plain_ms_by_path": {"huf_decompress_lanes": lh["plain_ms"]},
        "bound_ms_by_path": {"huf_decompress_lanes": lh["hbm_floor_ms"]},
    }] + [encoder_entry(*k, enc, enc_err, enc_plain_ms, len(chunks),
                        enc_paths[k[1]])
          for k in ENC_KERNELS]}), flush=True)

    # 27. last line
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def corruption_cases(staged, runtime, decompress_lanes, CorruptError) -> dict:
    """Truncations (caught by the host split), altered token streams and
    oversized blocks (caught by lz_decode's status), and altered Huff0 blobs
    in a level-41 stream: a segment cut by one byte with its jump table
    fixed (caught by huf_decode's status), a zeroed end mark and a jump
    table that overruns the blob (caught by the host plan)."""
    from lizard_tpu_torch.ref.huf import huf_read_stats
    lz4 = staged[10][0][0]
    liz = staged[21][0][0]
    huf = staged[41][0][0]

    def jump(blob):
        h = huf_read_stats(blob)[2]
        return h, int.from_bytes(blob[h:h + 2], "little")

    def cut_segment0(blob):
        h, l1 = jump(blob)
        b = bytearray(blob)
        b[h:h + 2] = (l1 - 1).to_bytes(2, "little")
        del b[h + 6]                        # the lowest byte of segment 0
        return bytes(b)

    def zero_end_mark(blob):
        h, l1 = jump(blob)
        return blob[:h + 6 + l1 - 1] + b"\0" + blob[h + 6 + l1:]

    def overrun(blob):
        h, _ = jump(blob)
        return blob[:h] + b"\xff\xff" + blob[h + 2:]

    cases = {
        "truncated_half": lz4[:len(lz4) // 2],
        "truncated_tail": lz4[:-1],
        "liz_truncated": liz[:len(liz) // 3],
        "flipped_level_byte": bytes([lz4[0] ^ 0xA5]) + lz4[1:],
        "lz4_first_token_0": _set_first_token(lz4, 0x00),
        "liz_first_token_0": _set_first_token(liz, 0x00),
        "liz_rep_without_offset": _set_first_token(liz, 0x88),
        "oversized_stored_block": bytes([10, 0x80]) + (200_000).to_bytes(3, "little")
        + bytes(200_000),
        "huf_segment_cut_one_byte": _edit_first_huf_blob(huf, cut_segment0),
        "huf_end_mark_zeroed": _edit_first_huf_blob(huf, zero_end_mark),
        "huf_jump_table_overrun": _edit_first_huf_blob(huf, overrun),
    }
    raised = {}
    for name, s in cases.items():
        try:
            decompress_lanes([s])
        except CorruptError as e:
            raised[name] = str(e)
            continue
        raise AssertionError(f"corruption case {name} did not raise")
    if "not exactly consumed" not in raised["huf_segment_cut_one_byte"]:
        raise AssertionError("the cut segment was not caught by huf_decode's "
                             "status")
    return raised


def _edit_first_huf_blob(stream: bytes, edit) -> bytes:
    """`stream` with the first Huff0 blob of its first inner block replaced
    by edit(blob), and the blob's size field fixed. Streams of a block: len,
    off16, off24, flags, literals; a raw one is a LE24 length and its
    bytes, a Huffman one a LE24 decoded size, a LE24 blob size and the
    blob. The header byte's bits 0-3 flag literals, flags, off16, off24."""
    header = stream[1]
    if header & 0x80:
        raise ValueError("first block is stored")
    p = 2
    for bit in (0, 4, 8, 2, 1):             # len, off16, off24, flags, lits
        if header & bit:
            size = int.from_bytes(stream[p + 3:p + 6], "little")
            blob = edit(stream[p + 6:p + 6 + size])
            return (stream[:p + 3] + len(blob).to_bytes(3, "little") + blob
                    + stream[p + 6 + size:])
        p += 3 + int.from_bytes(stream[p:p + 3], "little")
    raise ValueError("first block has no Huffman-coded stream")


def one_flag_block() -> bytes:
    """A 128 KB block of units of 20 random literal bytes and a 30-byte copy
    from 5000 or 5003 bytes back, in turn, after 5003 random bytes: every
    token has a long literal run, a long match and a new offset, so at
    levels x9 its flags stream (about 2,500 bytes) is one byte value and
    Huff0 codes it as RLE; its literals are random, so not compressible.
    At level 49 the random block (stored whole), the 4-symbol block (a
    stream coded) and this one take every Huff0 gate."""
    import numpy as np
    rng = np.random.default_rng(3)
    buf = bytearray(rng.integers(0, 256, 5003, np.uint8).tobytes())
    i = 0
    while len(buf) < BLOCK:
        buf += rng.integers(0, 256, 20, np.uint8).tobytes()
        p, dist = len(buf), 5000 + 3 * (i & 1)
        buf += bytes(buf[p - dist + j] for j in range(30))
        i += 1
    return bytes(buf[:BLOCK])


def huf_gates(streams) -> list:
    """Per one-block stream: "stored", or the outcome of its flags and
    literals streams: "coded" (a Huff0 blob), "rle" (a 1-byte blob) or
    "raw" (sent as it is). A stream under the 1024-byte gate counts as
    raw. Streams of a block: len, off16, off24, flags, literals; a raw one
    is a LE24 length and its bytes, a Huffman one a LE24 decoded size, a
    LE24 blob size and the blob. The header byte's bits 0-4 flag literals,
    flags, off16, off24, len."""
    out = []
    for s in streams:
        header = s[1]
        if header & 0x80:
            out.append("stored")
            continue
        p, kinds = 2, {}
        for bit, name in ((16, "len"), (4, "off16"), (8, "off24"),
                          (2, "flags"), (1, "literals")):
            size = int.from_bytes(s[p:p + 3], "little")
            if header & bit:
                blob = int.from_bytes(s[p + 3:p + 6], "little")
                kinds[name] = "rle" if blob == 1 else "coded"
                p += 6 + blob
            else:
                kinds[name] = "raw"
                p += 3 + size
        out.append({k: kinds[k] for k in ("flags", "literals")})
    return out


def _set_first_token(stream: bytes, token: int) -> bytes:
    """`stream` (one raw-coded inner block) with its first flags byte set to
    `token`. Streams of a block: len, off16, off24, flags, literals, each a
    LE24 length and its bytes."""
    s = bytearray(stream)
    if s[1] & 0x80 or s[1] & 0x02:
        raise ValueError("first block is stored or its flags are Huffman-coded")
    p = 2
    for _ in range(3):                           # skip len, off16, off24
        p += 3 + int.from_bytes(s[p:p + 3], "little")
    if int.from_bytes(s[p:p + 3], "little") == 0:
        raise ValueError("first block has no tokens")
    s[p + 3] = token
    return bytes(s)


if __name__ == "__main__":
    sys.exit(main())
