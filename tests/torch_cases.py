"""Inputs that bound the port's redesigned kernels, and the check of
huf_decode and huf_pack against their plain versions on them: Huff0 blobs
that test the lane split of csrc/huf_decode.cu, blocks that bound the parse
of csrc/enc_parse.cu, blocks (and tail maps) that bound the match finder of
csrc/enc_match.cu and the chain walk of csrc/enc_chain.cu, and packing
plans that bound the split of csrc/huf_encode.cu; the inputs that the
oracle (ref/block_encode.py) encodes for the card at every level. The card
tests
(tests/test_torch_cuda.py), the CPU tests that prove the inputs valid
(tests/test_torch_huf.py, tests/test_torch_enc_parse.py,
tests/test_torch_enc_maps.py, tests/test_torch_enc_huf.py) and
chip_smoke.py share them, and the port's test modules its `one_thread`
fixture. Imports no JAX.
"""

import time

import numpy as np
import pytest
import torch

from lizard_tpu_torch.ops import enc_huf as teh
from lizard_tpu_torch.ops import huf128 as th
from lizard_tpu_torch.ref import huf_encode as hr
from lizard_tpu_torch.ref.huf import huf_read_stats
from lizard_tpu_torch.utils.datagen import gen, text_like


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread in each module that imports this fixture: the
    plain versions run thousands of small tensor operations, and with
    intra-op threads, test workers running side by side starve each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------ huf_decode: inputs of the lane split


def huf_blob(header: bytes, data: bytes) -> bytes:
    """A Huff0 blob of `data` under the weights `header`: the codes read off
    the decode table (th.decode_table), four backward bitstreams, each with
    its end mark, and the jump table; no size gate (a blob of 8-bit codes is
    no shorter than its data)."""
    weights, tl, _ = huf_read_stats(header + bytes(16))
    table = th.decode_table(weights, tl)
    code = {}
    for v, e in enumerate(table[:1 << tl].tolist()):
        code.setdefault(e & 0xFF, (v >> (tl - (e >> 8)), e >> 8))
    seg = (len(data) + 3) // 4
    parts = []
    for k in range(4):
        acc = nbits = 0
        for sym in reversed(data[k * seg:(k + 1) * seg]):
            c, n = code[sym]
            acc |= c << nbits
            nbits += n
        acc |= 1 << nbits                           # end mark
        parts.append(acc.to_bytes(nbits // 8 + 1, "little"))
    jump = b"".join(len(p).to_bytes(2, "little") for p in parts[:3])
    return header + jump + b"".join(parts)


def tablelog12_blob(data: bytes) -> bytes:
    """A Huff0 blob of tableLog 12 (the encoder here stops at 11): a raw
    nibble header with weights 11, 10, ..., 1, 1 for symbols 0..11 (the
    implied weight of symbol 12 is 12)."""
    weights = list(range(11, 0, -1)) + [1]
    header = bytes([127 + len(weights)]) + bytes(
        (weights[i] << 4) | (weights[i + 1] if i + 1 < len(weights) else 0)
        for i in range(0, len(weights), 2))
    return huf_blob(header, data)


def equal8_header() -> bytes:
    """The weights header of 256 symbols of weight 1 (fixed 8-bit codes,
    tableLog 8): 255 equal weights FSE-coded under a table in which weight
    1 takes 63 of 64 states, the last weight implied."""
    norm = [1, 63]
    ncount = hr.fse_write_ncount(norm, 1, 6)
    body = hr.fse_compress_using_ctable(bytes([1] * 255),
                                        hr.FseCTable(norm, 1, 6))
    return bytes([len(ncount) + len(body)]) + ncount + body


def fixed7_header() -> bytes:
    """Raw-nibble weights of 128 symbols of weight 1: fixed 7-bit codes."""
    return bytes([127 + 127]) + bytes([0x11] * 63 + [0x10])


def counts_header(counts, max_bits: int) -> bytes:
    """The reference encoder's weights header for symbol counts."""
    max_sym = len(counts) - 1
    nb, _, log = hr.huf_build_ctable([int(c) for c in counts], max_sym,
                                     max_bits)
    return hr.huf_write_ctable(nb, max_sym, log)


def segment_plan(blobs):
    """(data, segs, tables, table_log) of blobs [(blob, orig)], one after
    the other in output tensor 0, without prepare_huf128's size gates: the
    rows the kernel takes for any blob."""
    parts, rows, tables, logs, at = [], [], [], [], 0
    cursor = 0
    for blob, orig in blobs:
        weights, tl, h = huf_read_stats(blob)
        body = blob[h:]
        lens = [int.from_bytes(body[k:k + 2], "little") for k in (0, 2, 4)]
        lens.append(len(body) - 6 - sum(lens))
        seg = (orig + 3) // 4
        off = cursor
        for k, n_out in enumerate([seg, seg, seg, orig - 3 * seg]):
            rows.append((off, lens[k], 0, at + k * seg, n_out, len(tables)))
            off += lens[k]
        parts.append(body[6:])
        cursor += len(body) - 6
        tables.append(th.decode_table(weights, tl))
        logs.append(tl)
        at += orig
    data = np.frombuffer(b"".join(parts), np.uint8).copy()
    return (torch.from_numpy(data), torch.tensor(rows, dtype=torch.int64),
            torch.from_numpy(np.stack(tables)),
            torch.tensor(logs, dtype=torch.int32))


def lane_split_cases():
    """(name, blob, data): blobs that the lane split of huf_decode must get
    right: codes that never self-synchronise (all 8 bits, all 7 bits), one
    1-bit code among 11-bit ones, segments of 1, 31, 32 and 33 symbols
    (and 32, 32, 32, 29), a segment of 25,000 symbols, and tableLog 12."""
    rng = np.random.default_rng(11)
    out = []
    d8 = rng.integers(0, 256, 40_000, np.uint8).tobytes()
    out.append(("equal_8bit", huf_blob(equal8_header(), d8), d8))
    d7 = rng.integers(0, 128, 40_001, np.uint8).tobytes()
    out.append(("equal_7bit", huf_blob(fixed7_header(), d7), d7))
    counts = [60_000, 1, 1] + [2 ** k for k in range(1, 11)]
    skew = rng.permutation(np.repeat(np.arange(13, dtype=np.uint8), counts))
    head = counts_header(counts, 11)
    assert huf_read_stats(head + bytes(16))[1] == 11
    out.append(("one_bit_and_11_bit", huf_blob(head, skew.tobytes()),
                skew.tobytes()))
    text = text_like(100_000, seed=12)
    head = counts_header(np.bincount(np.frombuffer(text, np.uint8),
                                     minlength=256), 11)
    for n in (4, 124, 128, 132, 125):
        out.append((f"n_out_{n}", huf_blob(head, text[:n]), text[:n]))
    out.append(("segments_of_25000", huf_blob(head, text), text))
    data12 = bytes((12 - torch.multinomial(
        torch.tensor([2.0 ** -k for k in range(13)]), 30_000, True,
        generator=torch.Generator().manual_seed(7))).tolist())
    out.append(("tablelog_12", tablelog12_blob(data12), data12))
    return out


def corrupt_lane_split_cases(cases):
    """Corrupt versions of the cases: a segment cut by one byte (its jump
    entry fixed), an end mark of 0 (the kernel's own check: the plan would
    refuse it), and a byte changed in the middle of a segment."""
    name, blob, data = cases[-2]                    # segments_of_25000
    head = huf_read_stats(blob)[2]
    cut = bytearray(blob)
    l1 = int.from_bytes(cut[head:head + 2], "little")
    cut[head:head + 2] = (l1 - 1).to_bytes(2, "little")
    del cut[head + 6]
    zero = bytearray(blob)
    zero[head + 6 + l1 - 1] = 0                     # segment 0's last byte
    flip = bytearray(blob)
    flip[head + 6 + l1 + 5000] ^= 0x20              # inside segment 1
    return [(bytes(b), len(data)) for b in (cut, zero, flip)]


def lane_split_against_plain(device) -> dict:
    """huf_decode against huf_decode_plain, both on `device`, on every
    lane-split case and their corruptions, plus a row out of bounds:
    statuses equal (OK for every case, the cut segment not consumed, the
    zero end mark refused, the last row out of bounds), bytes equal
    wherever the status is OK, and the OK cases equal to their data.
    Raises AssertionError on a difference; returns the cases, the plan's
    tensors on `device`, the statuses, the bytes' largest difference and
    the plain version's host-clock ms."""
    cases = lane_split_cases()
    blobs = [(b, len(d)) for _, b, d in cases]
    blobs += corrupt_lane_split_cases(cases)
    data, segs, tables, table_log = segment_plan(blobs)
    segs[-1, 4] += 10 ** 9                          # past its tensor
    total = sum(n for _, n in blobs)
    args = [t.to(device) for t in (data, segs, tables, table_log)]
    runs = []
    for fn in (th.huf_decode, th.huf_decode_plain):
        out = torch.zeros(total, dtype=torch.uint8, device=device)
        e = torch.empty(0, dtype=torch.uint8, device=device)
        sync = (torch.cuda.synchronize if args[0].is_cuda
                else lambda: None)
        sync()
        t = time.perf_counter()
        status = fn(*args, out, e, e, e)
        sync()
        runs.append((status.cpu(), out.cpu(),
                     (time.perf_counter() - t) * 1e3))
    (ks, ko, _), (ps, po, plain_ms) = runs
    n_ok = 4 * len(cases)
    if (not torch.equal(ks, ps) or (ks[:n_ok] != th.OK).any()
            or ks[n_ok] != th.ERR_NOT_CONSUMED
            or ks[n_ok + 4] != th.ERR_END_MARK or ks[-1] != th.ERR_BOUNDS):
        raise AssertionError(f"lane split: statuses {ks.tolist()}, plain "
                             f"{ps.tolist()}")
    err = 0
    for row, st in zip(segs.tolist(), ks.tolist()):
        if st == th.OK:
            a, b = row[3], row[3] + row[4]
            err = max(err, int((ko[a:b].int() - po[a:b].int()).abs().max()))
    if err:
        raise AssertionError(f"lane split: bytes differ by up to {err}")
    if bytes(ko[:sum(len(d) for _, _, d in cases)].numpy()) != b"".join(
            d for _, _, d in cases):
        raise AssertionError("lane split: a case differs from its data")
    return {"cases": cases, "blobs": len(blobs), "args": args,
            "n_ok_rows": n_ok, "statuses": ks.tolist(), "max_abs_err": err,
            "plain_ms": plain_ms}


# ------------------------------------------- parse_tokens: edge blocks


def boundary_block(n: int, seed: int) -> bytes:
    """n random bytes in which a copy (distance 8-207, 40-189 bytes long)
    ends every 384 bytes exactly at a 128-byte segment boundary or within 3
    bytes of one, so matches end at, before and after the segment ends that
    bound the parse's pick."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, n, np.uint8)
    for i, k in enumerate(range(2 * 128, n - 128, 3 * 128)):
        end = k + i % 7 - 3
        d = 8 + (i * 13) % 200
        for y in range(end - 40 - (i * 29) % 150, end):
            x[y] = x[y - d]
    return x.tobytes()


def parse_edge_blocks(n: int) -> list[bytes]:
    """Blocks of n bytes or fewer that bound the parse's work: a run of one
    byte (a candidate at every position, one match to lim), random bytes
    (almost no candidates), matches ending at segment boundaries, lengths
    21, 22, 149 and n - 1, and a repeat 80,000 bytes back (off24 at the
    LIZv1 levels; at n = 128 KB)."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 256, 40_000, np.uint8).tobytes()
    far = (a + rng.integers(0, 256, 40_000, np.uint8).tobytes() + a)[:n]
    return [b"\x07" * n, rng.integers(0, 256, n, np.uint8).tobytes(),
            boundary_block(n, 1), gen(21, 21, proba=0.5),
            gen(22, 22, proba=0.5), gen(149, 149, proba=0.5),
            gen(n - 1, 3, proba=0.6), far]


# ------------------------------- match_find and chain_walk: edge blocks


def match_edge_blocks(n: int, far_dist: int = None) -> list[bytes]:
    """Blocks of n bytes or fewer that bound the match finder and the chain
    walk (far_dist: the far table's delay, default n // 2):

    - a run of one byte: a segment's 128 lanes share one bucket, only lane
      127 is kept;
    - random bytes with one 5-byte word planted once in segment 0, twice in
      segment 1 (two kept lanes in one bucket: the old entry stays, so
      segment 2 finds segment 0's), then once in each of several
      consecutive segments (a bucket inserted segment after segment);
    - lengths 20, 21, 22, 1000 and n - 77 (emit_ok and the ungated delta
      map around len, lengths not a multiple of 128);
    - random bytes with 24-byte repeats at distances far_dist, far_dist + 1,
      + 127, + 128, + 1000 and 2 * far_dist - 2 (those that fit), each
      landing on lanes 112-135 of its segment (chk13's lanes 116-127 mix
      words from the segment's start);
    - a period of 128 random bytes (every segment inserts every bucket:
      every node ties at pref bytes, so a walk ends at its candidate); the
      same with a count of the period in every 8th byte (the words between
      the counts repeat and match 7 bytes: chains of the full 64 steps,
      every node tying below pref); a period of 1100 (chains stopped by
      maxoff 65535); and a period of 136 with one byte changed in every
      third period (nodes of different prefix lengths, and ties between
      them)."""
    fd = far_dist or n // 2
    rng = np.random.default_rng(n + 5)
    out = [b"\x07" * n]
    x = rng.integers(0, 256, n, np.uint8)
    word = np.frombuffer(b"WXYZ\x55", np.uint8)
    spots = [10, 133, 178, 276] + [s * 128 + 64 + s
                                   for s in range(3, min(12, n // 128 - 1))]
    for at in spots:
        x[at:at + 5] = word
    out.append(x.tobytes())
    out += [gen(k, k, proba=0.6) for k in (20, 21, 22, 1000, n - 77)]
    y = rng.integers(0, 256, n, np.uint8)
    dists = [d for d in (fd, fd + 1, fd + 127, fd + 128, fd + 1000,
                         2 * fd - 2) if d + 24 < n - 384]
    for k, d in enumerate(dists):
        at = n - 384 * (k + 1) + 112
        if at - d >= 0:
            y[at:at + 24] = y[at - d:at - d + 24]
    out.append(y.tobytes())
    base = rng.integers(0, 256, 1100, np.uint8)
    out.append(np.resize(base[:128], n).tobytes())
    counted = np.resize(base[:128], n).copy()
    counted[::8] = (np.arange(n // 8) // 16).astype(np.uint8)
    out.append(counted.tobytes())
    out.append(np.resize(base, n).tobytes())
    z = np.resize(base[:136], n).copy()
    z[9::408] ^= 0x20
    out.append(z.tobytes())
    return out


def chain_tail_maps(maps: torch.Tensor) -> torch.Tensor:
    """A copy of (B, nmaps, n) maps whose last 24 positions of every block
    have a map-0 candidate (distance 1-24) and a delta of 8: walks whose
    prefixes run into the zero pad past the row, which maps from
    match_find never give (its candidates stop 20 bytes before len)."""
    m = maps.clone()
    n = m.shape[2]
    tail = torch.arange(24, 0, -1, dtype=torch.int32)
    m[:, 0, n - 24:] = tail.to(torch.uint16)
    m[:, -1, n - 24:] = 8
    return m


# ------------------------------------------ huf_pack: plans of its split


def code_row(nb, val) -> np.ndarray:
    """A huf_pack table row, int32 (256,): nbits << 16 | code for symbols
    0 .. len(nb) - 1, 0 (no code) for the rest."""
    row = np.zeros(teh.TABLE_ENTRIES, np.int64)
    row[:len(nb)] = (np.asarray(nb, np.int64) << 16) | np.asarray(val,
                                                                  np.int64)
    return row.astype(np.int32)


def skewed_bytes(n: int, seed: int) -> bytes:
    """n bytes of 40 symbols, symbol 0 half of them, the others with
    probabilities falling by 0.75 a symbol: their Huffman codes are 1 bit
    and 3 to 11 bits long."""
    p = 0.75 ** np.arange(39)
    p = np.concatenate([[1.0], p / p.sum()]) / 2
    return np.random.default_rng(seed).choice(
        40, n, p=p).astype(np.uint8).tobytes()


def huffman_row(data: bytes) -> np.ndarray:
    """The reference encoder's code table of data (codes of at most 11
    bits; symbols that do not occur have no code)."""
    count, max_sym, _ = hr.fse_count(data, 255)
    nb, val, _ = hr.huf_build_ctable(count, max_sym, hr.HUF_TABLELOG_DEFAULT)
    return code_row(nb, val)


def pack_plan(streams):
    """(data, segs, tables, n_words) of streams [(four segments, table
    row)]: the segments' bytes one after another, four rows a stream naming
    its table, the words reserved one after another, as
    enc_huf.plan_huf_streams lays out a batch."""
    parts, rows, tables, cursor, words = [], [], [], 0, 0
    for segments, row in streams:
        assert len(segments) == teh.SEGMENTS
        for seg in segments:
            rows.append([cursor, len(seg), len(tables), words])
            cursor += len(seg)
            words += teh.segment_words(len(seg))
            parts.append(seg)
        tables.append(row)
    data = np.frombuffer(b"".join(parts), np.uint8).copy()
    return (torch.from_numpy(data), torch.tensor(rows, dtype=torch.int64),
            torch.from_numpy(np.stack(tables)), words)


def _fits(nbits: int, n: int) -> int:
    """OK if n codes of nbits and the end mark fit the reserved words."""
    return (teh.OK if nbits * n + 1 <= 32 * teh.segment_words(n)
            else teh.ERR_OVERFLOW)


HUF_PACK_CASES = ("lengths", "one_bit", "eleven_bit_32k", "every_shift",
                  "end_on_word", "lengths_differ_by_3", "overflow_16_20",
                  "no_code_last_step", "bounds", "beyond_buffer")


def huf_pack_cases():
    """(name, (data, segs, tables, n_words), expected status per segment):
    plans that bound huf_pack's split of a segment into warps' pieces,
    steps of PACK_STEP symbols, runs of 16 a lane and rounds:

    - segments of 0, 1, 31, 32, 33, a warp's step and one symbol either
      side, 4095-4097 (a step a warp), a round and one either side, three
      rounds and 5, and the longest segment of one round (codes of 1 and
      3-11 bits);
    - all 1-bit codes;
    - all 11-bit codes at 32 KB a segment: the reservation's last word
      holds the end mark;
    - a 32-bit code starting at every shift 0-31 (crossing a word at
      every shift but 0), then 11-bit codes, which start at every shift;
    - 8-bit codes whose bits end on a word boundary (also at a step's
      end), so the end mark opens a new word;
    - a stream of 20,001 bytes cut as the plan cuts it: segments of 5001,
      5001, 5001 and 4998;
    - 16-bit and 20-bit codes, which overflow but for short segments;
    - a symbol without a code in the last step only, also in a segment
      whose bits overflow;
    - rows out of bounds (source past the data, words past n_words) next
      to good rows;
    - segments longer than the kernel's word buffer (32,769-40,000
      symbols of 11-bit codes), packed in rounds that flush words."""
    T, R = teh.PACK_STEP, teh.PACK_ROUND
    OK = teh.OK
    rng = np.random.default_rng(13)
    skew = skewed_bytes(260_000, 14)
    srow = huffman_row(skew)
    assert set((srow >> 16).tolist()) == {0, 1} | set(range(3, 12))

    def cut(lengths, at=0):
        out = []
        for n in lengths:
            out.append(skew[at:at + n])
            at += n
        return out

    def rand(n, top=256):
        return rng.integers(0, top, n, np.uint8).tobytes()

    cases = []
    lengths = [0, 1, 31, 32, 33, T - 1, T, T + 1, 4095, 4096, 4097,
               R - 1, R, R + 1, 3 * R + 5, teh.PACK_WHOLE]
    segs = cut(lengths)
    cases.append(("lengths", pack_plan(
        [(segs[k:k + 4], srow) for k in range(0, 16, 4)]), [OK] * 16))
    one = code_row([1, 1], [0, 1])
    cases.append(("one_bit", pack_plan(
        [([rand(n, 2) for n in (T + 5, 32768, 100, 3)], one)]), [OK] * 4))
    r11 = code_row([11] * 256, rng.integers(0, 2048, 256))
    cases.append(("eleven_bit_32k", pack_plan(
        [([rand(32768) for _ in range(4)], r11)]), [OK] * 4))
    shift = code_row([32, 1, 11], [0xBEEF, 1, 0x5A5])
    emitted = [[0, 1] * 32 + [2] * 64 + [1] * (64 + k) for k in range(4)]
    cases.append(("every_shift", pack_plan(
        [([bytes(e[::-1]) for e in emitted], shift)]), [OK] * 4))
    r8 = code_row([8] * 256, np.arange(256))
    cases.append(("end_on_word", pack_plan(
        [([rand(n) for n in (4, 4096, T, 3 * 4096)], r8)]), [OK] * 4))
    n = 4 * 5000 + 1
    seg = (n + 3) // 4
    cases.append(("lengths_differ_by_3", pack_plan(
        [(cut([seg, seg, seg, n - 3 * seg], 100_000), srow)]), [OK] * 4))
    lens = (1000, T + 3, 5, 20_000)
    over = []
    for nb in (16, 20):
        row = code_row([nb] * 256, rng.integers(0, 1 << 16, 256))
        over.append(([rand(k) for k in lens], row))
    cases.append(("overflow_16_20", pack_plan(over),
                  [_fits(nb, k) for nb in (16, 20) for k in lens]))
    absent = int(np.flatnonzero(srow == 0)[0])
    late = bytearray(skew[150_000:150_000 + 2 * T + 500])
    late[3] = absent                    # emission index len - 4: last step
    row16 = code_row([16] * 255, rng.integers(0, 1 << 16, 255))
    late16 = bytearray(rand(3 * T, 255))
    late16[0] = 255                     # the last symbol; bits overflow
    cases.append(("no_code_last_step", pack_plan(
        [([bytes(late)] + cut([3000, 3001, 3002], 170_000), srow),
         ([rand(5, 255), bytes(late16), rand(3, 255), b""], row16)]),
        [teh.ERR_NO_CODE, OK, OK, OK, OK, teh.ERR_NO_CODE, OK, OK]))
    data, segs, tables, n_words = pack_plan(
        [(cut([2000, 2001, 1999, 7], 200_000 + 9000 * k), srow)
         for k in range(3)])
    segs[5, 0] = data.numel()           # its bytes past the data
    segs[11, 3] = n_words - 1           # its words past n_words
    expect = [OK] * 12
    expect[5] = expect[11] = teh.ERR_BOUNDS
    cases.append(("bounds", (data, segs, tables, n_words), expect))
    cases.append(("beyond_buffer", pack_plan(
        [([rand(n) for n in (40_000, 36_000, 32_769, 5)], r11)]), [OK] * 4))
    assert tuple(c[0] for c in cases) == HUF_PACK_CASES
    return cases


def huf_pack_against_plain(device) -> dict:
    """huf_pack against huf_pack_plain, both on `device`, on every case of
    huf_pack_cases: words, bits and status exactly, and the statuses those
    the case expects. Raises AssertionError on a difference; returns the
    case names, segments, statuses, the largest difference (0), the plain
    version's host-clock ms summed over the cases and the kernel calls
    made."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    names, statuses, plain_ms, segments, calls = [], [], 0.0, 0, 0
    for name, (data, segs, tables, n_words), expect in huf_pack_cases():
        args = (data.to(device), segs.to(device), tables.to(device), n_words)
        k = [t.cpu() for t in teh.huf_pack(*args)]
        calls += 1
        sync()
        t = time.perf_counter()
        p = teh.huf_pack_plain(*args)
        sync()
        plain_ms += (time.perf_counter() - t) * 1e3
        for what, a, b in zip(("words", "bits", "status"), k, p):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"huf_pack case {name}: {what} differ "
                                     "from the plain version")
        if k[2].tolist() != expect:
            raise AssertionError(f"huf_pack case {name}: statuses "
                                 f"{k[2].tolist()}, expected {expect}")
        names.append(name)
        statuses.append(k[2].tolist())
        segments += segs.shape[0]
    return {"cases": names, "segments": segments, "statuses": statuses,
            "max_abs_err": 0, "plain_ms": plain_ms, "calls": calls}


# ------------------------------- decode_streams_global in a gloo group


def global_decode_datas() -> list[bytes]:
    """The buffers of the two-process decode_streams_global check: 11
    streams of 6-14 KB (one inner block each) and one of 140 KB (two)."""
    return ([gen(6_000 + 800 * i, seed=i, proba=0.6) for i in range(11)]
            + [gen(140_000, seed=11, proba=0.6)])


def global_decode_worker(rank: int, world: int, store: str, out: str,
                         local: int) -> None:
    """One rank of a gloo group of `world` processes (parallel.multihost.
    init_process over the file store `store`): decode_streams_global of
    global_decode_datas() at level 12 over `local` CPU shards a rank.
    Writes JSON to `out`: the offsets, the streams this rank decoded and
    whether each equals its input. The process target of
    tests/test_torch_parallel.py's gloo test, here because a spawned child
    imports the target's module, and this one imports no JAX."""
    import json

    from lizard_tpu_torch import runtime
    from lizard_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    if not multihost.init_process(f"file://{store}", world, rank):
        raise RuntimeError("init_process did not join a group")
    try:
        datas = global_decode_datas()
        results, offs = multihost.decode_streams_global(
            [runtime.compress(d, 12) for d in datas], 131072,
            ["cpu"] * local)
        own = [i for i, r in enumerate(results) if r is not None]
        with open(out, "w") as f:
            json.dump({"offs": offs.tolist(), "own": own,
                       "equal": [results[i] == datas[i] for i in own]}, f)
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------- the oracle's inputs at every level


def alphabet16(n: int, seed: int, q: float = 0.85) -> bytes:
    """n bytes of a 16-symbol alphabet, symbol i drawn with weight q**i:
    literal-heavy, so the oracle's literal stream of a few KB passes the
    1024-byte Huff0 gate at every level 30-49."""
    rng = np.random.default_rng(seed)
    p = q ** np.arange(16)
    sym = np.frombuffer(b"etaoinshrdlucmfw", np.uint8)
    return sym[rng.choice(16, n, p=p / p.sum())].tobytes()


def is_optimal(level: int) -> bool:
    """Whether the level's parser is one of the optimal parsers
    (OPTIMAL_PRICE, OPTIMAL_PRICE_BT: levels 18, 19, 26-29, 39, 46-49), the
    oracle's slowest."""
    from lizard_tpu_torch.format.levels import LEVELS, Parser
    return LEVELS[level].parser in (Parser.OPTIMAL_PRICE,
                                    Parser.OPTIMAL_PRICE_BT)
