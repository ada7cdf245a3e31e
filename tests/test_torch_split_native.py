"""The decoder's native host split and Huff0 plan (ops/host_plan.py over
csrc/split_plan.cpp) against its plain version, ops/fuse.py::
plan_split_plain over ops/split.py and ops/huf128.py::prepare_huf128: the
same BlockBatch and HufPlan, field for field, on streams of every level
kind and on frame blocks, and the same error class and message on corrupt
input; and its counters. CPU only, no JAX."""

import re

import numpy as np
import pytest
import torch

from lizard_tpu_torch import runtime
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import (
    FLAG_FLAGS, FLAG_LEN, FLAG_LITERALS, FLAG_UNCOMPRESSED, LIZARD_BLOCK_SIZE)
from lizard_tpu_torch.frame import decode_blocks, decompress_frame, linked_frame
from lizard_tpu_torch.ops import split as tsplit
from lizard_tpu_torch.ops.fuse import (
    build_fused_plan, decompress_lanes_fused, plan_split_plain)
from lizard_tpu_torch.ops.host_plan import split_plan
from lizard_tpu_torch.ops.lane_decode import decompress_lanes
from lizard_tpu_torch.ref.huf import huf_read_stats
from lizard_tpu_torch.utils import profiling
from lizard_tpu_torch.utils.datagen import gen, text_like
from tests.torch_cases import one_thread  # noqa: F401

FIELDS = tsplit.STREAMS + tsplit.TABLE_FIELDS + ("stream_id",)
PLAN = ("data", "segs", "tables", "table_log")


def _datas(seed, n=3):
    """n pieces of 128 KiB: LZ repeats and word text in turn."""
    kinds = [lambda s: gen(131072, seed=s, proba=0.6),
             lambda s: text_like(131072, seed=s),
             lambda s: gen(131072, seed=s, proba=0.3)]
    return [kinds[i % 3](seed + i) for i in range(n)]


def _plain(streams):
    return plan_split_plain(
        lambda acc, hd: tsplit.split_into(streams, acc, hd))


def _plain_blocks(items, sids):
    ends = []

    def split(acc, hd):
        family, e = tsplit.split_blocks(items, sids, acc, hd)
        ends.extend(e)
        return family
    batch, plan = plan_split_plain(split)
    return batch, plan, ends


def _assert_same(got, want):
    """Two (BlockBatch, HufPlan) pairs are equal field for field; the
    native plan writes the plain plan's fills into the batch itself."""
    (gb, gp), (wb, wp) = got, want
    assert gb.codewords == wb.codewords and gb.n_blocks == wb.n_blocks
    for name in FIELDS:
        a, b = getattr(gb, name), getattr(wb, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    if wb.block_family is None:
        assert gb.block_family is None
    else:
        assert torch.equal(gb.block_family, wb.block_family)
    for name in PLAN:
        a, b = getattr(gp, name), getattr(wp, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert list(gp.names) == list(wp.names)
    assert gp.fills == []


def _outcome(fn):
    """("ok", result) or the class and message of what fn raised."""
    try:
        return "ok", fn()
    except Exception as e:                # noqa: BLE001 (compared below)
        return type(e), str(e)


def _same_outcome(streams):
    got = _outcome(lambda: build_fused_plan(streams))
    want = _outcome(lambda: _plain(streams))
    if want[0] == "ok":
        assert got[0] == "ok", got
        _assert_same(got[1], want[1])
    else:
        assert got == want
    return want


@pytest.mark.parametrize("level", [10, 21, 41, 46, 49])
def test_streams_equal_plain(level):
    datas = _datas(level)
    streams = [runtime.compress(d, level) for d in datas]
    native = build_fused_plan(streams)
    _assert_same(native, _plain(streams))
    assert (native[1].segs.shape[0] > 0) == (level >= 30)
    assert decompress_lanes(streams, device="cpu") == datas


@pytest.mark.parametrize("level", [21, 41])
def test_multi_block_stream_equals_plain(level):
    data = b"".join(_datas(level, 4))[:400_000]
    streams = [runtime.compress(data, level), runtime.compress(b"", level),
               runtime.compress(b"z", level)]
    native = build_fused_plan(streams)
    assert native[0].n_blocks >= 4
    _assert_same(native, _plain(streams))
    assert decompress_lanes_fused(streams, device="cpu") == [data, b"", b"z"]


def _frame_items(level):
    """Frame blocks of both kinds and of both codeword families: stored
    blocks (one over LIZARD_BLOCK_SIZE, one empty) among compressed ones."""
    a, b, c = _datas(level)
    stored = np.random.default_rng(level).integers(
        0, 256, LIZARD_BLOCK_SIZE + 5000, dtype=np.uint8).tobytes()
    items = [(False, runtime.compress(a, level)), (True, stored),
             (False, runtime.compress(b, 10)), (True, b""),
             (False, runtime.compress(c, level))]
    return items, [a, stored, b, b"", c]


@pytest.mark.parametrize("level", [10, 41])
@pytest.mark.parametrize("linked", [False, True])
def test_frame_blocks_equal_plain(level, linked):
    items, _ = _frame_items(level)
    sids = [0 if linked else i for i in range(len(items))]
    batch, plan, ends = split_plan([p for _, p in items], sids,
                                   [s for s, _ in items], check_family=False)
    wb, wp, wends = _plain_blocks(items, sids)
    _assert_same((batch, plan), (wb, wp))
    assert ends == wends
    assert (batch.block_family is None) == (level == 10)


@pytest.mark.parametrize("level", [10, 41])
def test_frame_blocks_decode(level):
    items, want = _frame_items(level)
    assert decode_blocks(items, False, "cpu") == want


@pytest.mark.parametrize("level", [21, 41])
def test_linked_chain_with_history_equals_plain(level):
    """A linked chain headed by the bytes decoded before it (the streaming
    decoder's case): the history's blocks and the chain's compare equal,
    and the chain decodes to its bytes."""
    data = b"".join(_datas(level, 3))
    stream = runtime.compress(data, level)
    spans = tsplit.inner_block_spans(stream)
    history = data[:2 * LIZARD_BLOCK_SIZE]
    block = stream[:1] + stream[spans[2][0]:]
    items = [(True, history), (False, block)]
    batch, plan, ends = split_plan([history, block], [0, 0], [True, False],
                                   check_family=False)
    wb, wp, wends = _plain_blocks(items, [0, 0])
    _assert_same((batch, plan), (wb, wp))
    assert ends == wends == [2, len(spans)]
    got = decode_blocks([(False, block)], True, "cpu", history=history)
    assert got == [data[2 * LIZARD_BLOCK_SIZE:]]


# ---------------------------------------------------------------- blobs --

Z3 = bytes(3)


def _literal_blob_stream(blob: bytes, orig: int, level: int = 41) -> bytes:
    """A one-block stream whose only stream is a Huff0-coded literals
    stream: `blob`, decoding to `orig` bytes."""
    return (bytes([level, FLAG_LITERALS]) + Z3 * 4 + orig.to_bytes(3, "little")
            + len(blob).to_bytes(3, "little") + blob)


def _real_blob():
    """A Huff0 blob of word text, its decoded size and its header size."""
    raw = text_like(6000, seed=3)
    blob = runtime.huf_compress(raw)
    return blob, len(raw), huf_read_stats(blob)[2]


def test_stored_and_rle_blobs_fill_their_holes():
    blob, orig, _ = _real_blob()
    raw = runtime.huf_decompress(blob, orig)
    streams = [_literal_blob_stream(raw, orig),              # stored
               _literal_blob_stream(b"q", 77),               # RLE
               _literal_blob_stream(blob, orig)]             # the kernel's
    batch, plan = build_fused_plan(streams)
    _assert_same((batch, plan), _plain(streams))
    assert plan.segs.shape[0] == 4 and list(plan.names) == [
        "stream 2, block 2 (literals)"]
    assert bytes(batch.literals[:orig].numpy()) == raw
    assert bytes(batch.literals[orig:orig + 77].numpy()) == b"q" * 77
    assert decompress_lanes_fused(streams, device="cpu") == [
        raw, b"q" * 77, raw]


def _with_jump(blob, hsize, lens):
    body = bytearray(blob[hsize:])
    for k, n in enumerate(lens):
        body[2 * k:2 * k + 2] = n.to_bytes(2, "little")
    return blob[:hsize] + bytes(body)


def _blob_case(kind):
    """A corrupt stream of one kind (a one-blob stream where the fault is
    in a Huff0 blob)."""
    blob, orig, h = _real_blob()
    lens = [int.from_bytes(blob[h + k:h + k + 2], "little") for k in (0, 2, 4)]
    fse = bytes.fromhex
    one = _literal_blob_stream
    return {
        "dsize 0": one(b"ab", 0),
        "csize > dsize": one(b"abc", 2),
        "body under 10 bytes": one(blob[:h + 9], orig),
        "jump table overflow": one(_with_jump(blob, h, [60000] * 3), orig),
        "missing end mark": one(blob[:h + 6 + lens[0] - 1] + b"\0"
                                + blob[h + 6 + lens[0]:], orig),
        "empty bitstream": one(_with_jump(blob, h, [0] + lens[1:]), orig),
        "ncount corrupt": one(fse("0436816d01") + blob[h:], orig),
        "ncount overran": one(fse("04c2811001") + blob[h:], orig),
        "ncount too small": one(fse("03808100") + blob[h:], orig),
        # zero runs take the counts to 255 with one to come: the 256th
        # ends the header, whose symbols 254 and 255 are weights too large
        "ncount of 256 counts": one(fse(
            "1910feffffffffffffffffffffffffffffffffffffffffeb0701")
            + blob[h:], orig),
        "fse tableLog": one(fse("045d816f01") + blob[h:], orig),
        "fse weights tableLog": one(fse("0482276d01") + blob[h:], orig),
        "fse empty bitstream": one(fse("0480816d01") + blob[h:], orig),
        "fse missing end mark": one(fse("0580816d0100") + blob[h:], orig),
        "fse output too large": one(
            fse("11f081d701edfb4988b8c9ee36dff622b6a4") + blob[h:], orig),
        # 255 weights out when the stream has one symbol left to give
        "fse output of 256": one(bytes([26]) + fse(
            "c0530a76290a2b9a3a1d4d09c2c48d1491f787a66299db2bea2b")
            + blob[h:], orig),
        # a zero run takes the one count of the NCount to symbol 385
        "weights symbol past 255": one(fse(
            "2410fe" + "ff" * 31 + "f90101")
            + blob[h:], orig),
        "fse huf tableLog > 12": one(fse("0a808190f5edfb4988b8c9") + blob[h:],
                                     orig),
        "raw huf tableLog > 12": one(bytes([127 + 8]) + b"\xbb" * 4
                                    + blob[h:], orig),
        "weight too large": one(bytes([127 + 2]) + b"\xc1" + blob[h:], orig),
        "all-zero weights": one(fse("048081e901") + blob[h:], orig),
        "implied weight": one(bytes([127 + 3]) + b"\x22\x10" + blob[h:], orig),
        "weight distribution": one(fse("0480f96d01") + blob[h:], orig),
        "weights truncated": one(bytes([127 + 40]) + b"\x11" * 3, 500),
        "empty weights header": one(b"", 9),
    }[kind]


BLOB_CASES = {
    "dsize 0": "stream 0, block 0 \\(literals\\): dst size 0",
    "csize > dsize": "csize > dsize",
    "body under 10 bytes": "huf body too small",
    "jump table overflow": "jump table overflow",
    "missing end mark": "segment 0: missing end mark",
    "empty bitstream": "segment 0: empty bitstream",
    "ncount corrupt": "^ncount corrupt$",
    "ncount overran": "^ncount overran$",
    "ncount too small": "^ncount too small$",
    "ncount of 256 counts": "^weight too large$",
    "fse tableLog": "^tableLog too large$",
    "fse weights tableLog": "^weights tableLog too large$",
    "fse empty bitstream": "^empty bitstream$",
    "fse missing end mark": "^missing end mark$",
    "fse output too large": "^fse output too large$",
    "fse output of 256": "^fse output too large$",
    "weights symbol past 255": "^byte must be in range\\(0, 256\\)$",
    "fse huf tableLog > 12": "^huf tableLog too large$",
    "raw huf tableLog > 12": "^huf tableLog too large$",
    "weight too large": "^weight too large$",
    "all-zero weights": "^all-zero weights$",
    "implied weight": "^implied weight not a power of 2$",
    "weight distribution": "^invalid weight distribution$",
    "weights truncated": "^weights truncated$",
    "empty weights header": "^empty weights header$",
}


@pytest.mark.parametrize("kind", sorted(BLOB_CASES))
def test_blob_errors_match_plain(kind):
    cls, msg = _same_outcome([_literal_blob_stream(b"q", 5),
                              _blob_case(kind)])
    # the plain version's bytearray refuses a symbol past 255 for it
    assert (cls is ValueError if kind == "weights symbol past 255"
            else issubclass(cls, CorruptError))
    assert re.search(BLOB_CASES[kind].replace(
        "stream 0", "stream 1").replace("block 0", "block 1"), msg), msg


def _split_case(kind):
    s = runtime.compress(_datas(41, 1)[0], 41)
    e = runtime.compress(text_like(3000, seed=1), 41)
    return {
        "empty stream": [s, b""],
        "bad level": [bytes([9])],
        "FLAG_LEN": [bytes([41, FLAG_LEN | FLAG_FLAGS])],
        "bad header byte": [bytes([41, 64])],
        "stream header truncated": [s[:3]],
        "stream truncated": [bytes([41, 0]) + b"\x05\x00\x00ab"],
        "huf stream header truncated": [bytes([41, FLAG_LITERALS])
                                        + Z3 * 4 + b"\x01\x00"],
        "huf stream truncated": [_literal_blob_stream(b"abc", 9)[:-1]],
        "uncompressed header truncated": [bytes([41, FLAG_UNCOMPRESSED, 1])],
        "uncompressed truncated": [bytes([41, FLAG_UNCOMPRESSED, 5, 0, 0, 1])],
        "mixed families": [e, runtime.compress(b"abc" * 300, 10), b""],
        "split before plan": [_blob_case("dsize 0"), bytes([9])],
    }[kind]


SPLIT_CASES = {
    "empty stream": "^empty stream$",
    "bad level": "^bad level 9$",
    "FLAG_LEN": "^FLAG_LEN set$",
    "bad header byte": "^bad header byte 64$",
    "stream header truncated": "^stream header truncated$",
    "stream truncated": "^stream truncated$",
    "huf stream header truncated": "^huf stream header truncated$",
    "huf stream truncated": "^huf stream truncated$",
    "uncompressed header truncated": "^uncompressed block header truncated$",
    "uncompressed truncated": "^uncompressed block truncated$",
    "mixed families": "^mixed codeword families in one batch$",
    "split before plan": "^bad level 9$",
}


@pytest.mark.parametrize("kind", sorted(SPLIT_CASES))
def test_split_errors_match_plain(kind):
    cls, msg = _same_outcome(_split_case(kind))
    assert cls is CorruptError
    assert re.search(SPLIT_CASES[kind], msg), msg


def test_byte_flips_match_plain():
    """Seeded byte flips of two -41 streams, half of them in the first
    bytes of a stream where the block and blob headers lie: each gives the
    plain version's batch and plan, or its error class and message."""
    base = [runtime.compress(text_like(40_000, seed=7), 41),
            runtime.compress(gen(40_000, seed=8, proba=0.6), 41)]
    rng = np.random.default_rng(41)
    seen = set()
    for _ in range(200):
        streams = [bytearray(s) for s in base]
        for _ in range(int(rng.integers(1, 4))):
            s = streams[int(rng.integers(0, 2))]
            at = (int(rng.integers(0, 64)) if rng.random() < 0.5
                  else int(rng.integers(0, len(s))))
            s[at] = int(rng.integers(0, 256))
        seen.add(_same_outcome([bytes(s) for s in streams])[0])
    assert "ok" in seen and len(seen) > 1


def test_weights_headers_match_plain():
    """Seeded weights headers before a real blob's body: the headers of
    blobs of several alphabets, with bytes replaced, and random ones (FSE
    NCount of any tableLog, zero runs, raw nibbles): each gives the plain
    version's plan or its error class and message."""
    rng = np.random.default_rng(12)
    blob, orig, h = _real_blob()
    heads = []
    for span in (4, 20, 60, 130, 250):
        raw = gen(20_000, seed=span, proba=0.5, lit_span=span)
        b = runtime.huf_compress(raw)
        heads.append(b[:huf_read_stats(b)[2]])
    seen = set()
    for i in range(400):
        if i % 2:
            head = bytearray(heads[int(rng.integers(0, len(heads)))])
            for _ in range(int(rng.integers(1, 3))):
                head[int(rng.integers(1, len(head)))] = int(
                    rng.integers(0, 256))
        else:
            n = int(rng.integers(4, 40))
            head = bytearray(rng.integers(0, 256, n + 1, dtype=np.uint8))
            head[0] = n if i % 4 else 128 + n
        stream = _literal_blob_stream(bytes(head) + blob[h:], orig)
        seen.add(_same_outcome([stream])[1] if i % 2 == 0 else "")
    assert len(seen) > 5


def test_counters_count_native_blocks_and_blobs():
    profiling.reset()
    assert profiling.counters()["split.native_blocks"] == 0
    assert profiling.counters()["plan.native_blobs"] == 0
    datas = _datas(46)
    streams = [runtime.compress(d, 46) for d in datas]
    holes = []

    def split(acc, hd):
        return tsplit.split_into(
            streams, acc, lambda b, n, k: holes.append(k) or hd(b, n, k))
    batch, _ = plan_split_plain(split)
    assert decompress_lanes(streams, device="cpu") == datas
    got = profiling.counters()
    assert got["split.native_blocks"] == batch.n_blocks == 3
    assert got["plan.native_blobs"] == len(holes) > 0
    data = b"".join(datas)
    stream = runtime.compress(data, 46)
    holes.clear()
    tsplit.split_into([stream], tsplit.new_accumulator(),
                      lambda b, n, k: holes.append(k) or np.zeros(n, np.uint8))
    profiling.reset()
    assert decompress_frame(linked_frame(stream, data, 4), device="cpu") == data
    got = profiling.counters()
    assert got["split.native_blocks"] == len(tsplit.inner_block_spans(stream))
    assert got["plan.native_blobs"] == len(holes) > 0
    profiling.reset()
    assert profiling.counters()["split.native_blocks"] == 0
