"""The port's Huff0 decode (lizard_tpu_torch.ref.huf, .ops.huf128) against
the JAX package: its bit-exact oracle lizard_tpu.ref.huf (what
tests/test_huf128.py holds the TPU kernel against), the native
ltpu_huf_decompress, and the host plan of lizard_tpu.ops.huf128. The port
runs its plain PyTorch route here (device="cpu"); tests/test_torch_cuda.py
and chip_smoke.py hold the CUDA kernel against the same route on the card.
"""

import ast
import functools
import os

import numpy as np
import pytest
import torch

from lizard_tpu import runtime as jrt
from lizard_tpu.ops.huf128 import prepare_huf128 as jax_prepare_huf128
from lizard_tpu.ref import huf as jhuf
from lizard_tpu.ref import huf_encode as jenc
from lizard_tpu.utils.datagen import gen, text_like
from lizard_tpu_torch.errors import HufError
from lizard_tpu_torch.ops import huf128 as th
from lizard_tpu_torch.ops.split import split_stream, new_accumulator
from lizard_tpu_torch.ref import huf as thuf
from lizard_tpu_torch.utils import profiling
from lizard_tpu_torch.utils.datagen import build_corpus
from tests.torch_cases import (corrupt_lane_split_cases, lane_split_cases,
                               segment_plan)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RNG = np.random.default_rng(2)

# (name, data): the weights header kind and tableLog each one gives
HEADERS = {
    "raw_nibbles_tl4": bytes(range(13)) * 150,
    "raw_nibbles_tl2": _RNG.integers(0, 4, 20_000, dtype=np.uint8).tobytes(),
    "fse_tl9": gen(1500, 3, proba=0.8),
    "fse_tl10": gen(20_000, 3, proba=0.5),
    "fse_tl11": np.minimum(_RNG.geometric(0.05, 30_000), 255)
    .astype(np.uint8).tobytes(),
}
HEADER_KIND = {"raw_nibbles_tl4": (True, 4), "raw_nibbles_tl2": (True, 2),
               "fse_tl9": (False, 9), "fse_tl10": (False, 10),
               "fse_tl11": (False, 11)}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_read_stats_and_table_equal_reference(name):
    blob = jenc.huf_compress(HEADERS[name])
    raw, tl = HEADER_KIND[name]
    assert (blob[0] >= 128) == raw
    weights, table_log, hsize = thuf.huf_read_stats(blob)
    assert (weights, table_log, hsize) == jhuf.huf_read_stats(blob)
    assert table_log == tl
    sym, bits = jhuf.huf_build_dtable(weights, table_log)
    assert thuf.huf_build_dtable(weights, table_log) == (sym, bits)
    table = th.decode_table(weights, table_log)
    want = np.frombuffer(sym, np.uint8).astype(np.uint16) \
        | (np.frombuffer(bits, np.uint8).astype(np.uint16) << 8)
    np.testing.assert_array_equal(table[:1 << table_log], want)
    assert not table[1 << table_log:].any()


def _blob_batch(datas):
    blobs = []
    for d in datas:
        c = jenc.huf_compress(d)
        assert c is not None and len(c) > 1, "data must be compressible"
        blobs.append((c, len(d)))
    return blobs


# the specs of tests/test_huf128.py, and RLE and stored blobs
SPECS = {
    "single": [text_like(3000, 1)],
    "mixed": [text_like(2000, 2), gen(1500, 3, proba=0.8), text_like(4096, 4),
              bytes(range(13)) * 150, text_like(9200, 6)]
    + [text_like(300 + 7 * i, 100 + i) for i in range(28)],
    "sizes_odd": [text_like(n, n) for n in (515, 1000, 2049, 700)],
    "multi_row": [text_like(9000, 7), text_like(12000, 8)],
    "skewed": [b"a" * 4000 + b"b" * 300 + b"c" * 40 + bytes(range(64))],
}


@pytest.mark.parametrize("name", sorted(SPECS) + ["rle_and_stored"])
def test_huf_decompress_128_equals_oracle(name):
    if name == "rle_and_stored":
        stored = gen(3000, 9, proba=0.0)
        datas = [text_like(2000, 5), b"z" * 100, stored]
        blobs = _blob_batch(datas[:1]) + [(b"z", 100), (stored, len(stored))]
    else:
        datas = SPECS[name]
        blobs = _blob_batch(datas)
    got = th.huf_decompress_128(blobs, device="cpu")
    assert got == datas
    assert got == [jhuf.huf_decompress(b, n) for b, n in blobs]
    assert got == [jrt.huf_decompress(b, n) for b, n in blobs]


@pytest.mark.parametrize("name", ["mixed", "sizes_odd", "skewed"])
def test_segment_sizes_equal_jax_plan(name):
    blobs = _blob_batch(SPECS[name]) + [(b"q", 77)]
    jax_tasks = jax_prepare_huf128(blobs, groups=1).tasks
    plan = th.prepare_huf128(blobs)
    n_out = plan.segs[:, 4].reshape(-1, 4).tolist()
    assert len(n_out) == len(blobs) - 1
    for i, task in enumerate(jax_tasks[:-1]):
        assert [n for _, _, n in sorted(task)] == n_out[i]
    assert jax_tasks[-1] == ("host", b"q" * 77)
    assert plan.fills == [(0, sum(n for _, n in blobs[:-1]), b"q" * 77)]


@pytest.fixture(scope="module")
def corpus_blocks():
    """Two 128 KB blocks of the decode benchmark's corpus (a gen part and a
    text part)."""
    c = build_corpus(8 << 20)
    return [c[:131072], c[4 << 20:(4 << 20) + 131072]]


def _huffman_blobs(streams):
    """Every Huff0 blob of the streams, as (blob, orig, kind)."""
    blobs = []
    acc = new_accumulator()
    for i, s in enumerate(streams):
        split_stream(s, acc, i, lambda b, n, k: blobs.append((b, n, k))
                     or np.zeros(n, np.uint8))
    return blobs


@pytest.mark.parametrize("level", [31, 35, 41, 45, 49])
def test_real_blobs(level, corpus_blocks):
    streams = [jrt.compress(d, level) for d in corpus_blocks]
    blobs = _huffman_blobs(streams)
    assert len(blobs) >= 3 and {k for _, _, k in blobs} == {"flags",
                                                             "literals"}
    assert max(n for _, n, _ in blobs) > 40_000
    got = th.huf_decompress_128([(b, n) for b, n, _ in blobs], device="cpu")
    assert got == [jrt.huf_decompress(b, n) for b, n, _ in blobs]


def _fib_blob():
    """A tableLog-12 blob made with the reference encoder's own pieces (its
    entry point stops at tableLog 11): Fibonacci counts give a deep tree,
    and the most frequent symbol is last, so its 1-bit code is the implied
    weight."""
    fib = [1, 1]
    while len(fib) < 16:
        fib.append(fib[-1] + fib[-2])
    data = bytes(np.random.default_rng(4).permutation(np.repeat(
        np.arange(16, dtype=np.uint8), fib)))
    count, max_sym, _ = jenc._fse_count(data, 255)
    nb, val, log = jenc.huf_build_ctable(count, max_sym, 12)
    assert log == 12
    seg = (len(data) + 3) // 4
    parts = [jenc._huf_encode_1x(data[i * seg:(i + 1) * seg], val, nb)
             for i in range(4)]
    blob = (jenc.huf_write_ctable(nb, max_sym, log)
            + b"".join(len(p).to_bytes(2, "little") for p in parts[:3])
            + b"".join(parts))
    return blob, data


def test_tablelog_12_blob():
    blob, data = _fib_blob()
    assert thuf.huf_read_stats(blob)[1] == 12
    assert th.prepare_huf128([(blob, len(data))]).table_log.tolist() == [12]
    got = th.huf_decompress_128([(blob, len(data))], device="cpu")
    assert got == [data] == [jhuf.huf_decompress(blob, len(data))]
    assert jrt.huf_decompress(blob, len(data)) == data


def _jump(blob):
    """(offset of the jump table, [l1, l2, l3])."""
    h = jhuf.huf_read_stats(blob)[2]
    return h, [int.from_bytes(blob[h + k:h + k + 2], "little")
               for k in (0, 2, 4)]


def _cut_segment0(blob):
    h, (l1, _, _) = _jump(blob)
    b = bytearray(blob)
    b[h:h + 2] = (l1 - 1).to_bytes(2, "little")
    del b[h + 6]
    return bytes(b)


def _set(blob, at, value):
    b = bytearray(blob)
    b[at] = value(b[at])
    return bytes(b)


def _segment_end(blob, k):
    h, lens = _jump(blob)
    return h + 6 + sum(lens[:k + 1]) - 1


_SMALL = jenc.huf_compress(text_like(3000, 1))       # FSE header
_RAW = jenc.huf_compress(bytes(range(13)) * 150)     # raw nibble header
# (blob, orig) corruptions of small blobs; ref/huf.py decodes them
CORRUPTIONS = {
    "segment_cut_one_byte": (_cut_segment0(_SMALL), 3000),
    "end_mark_zeroed": (_set(_SMALL, _segment_end(_SMALL, 1),
                             lambda v: 0), 3000),
    "jump_table_overruns": (_set(_SMALL, _jump(_SMALL)[0] + 1,
                                 lambda v: 0xFF), 3000),
    "jump_entry_zero": (_set(_set(_SMALL, _jump(_SMALL)[0], lambda v: 0),
                             _jump(_SMALL)[0] + 1, lambda v: 0), 3000),
    "bit_flip_mid_segment": (_set(_SMALL, _jump(_SMALL)[0] + 6 + 200,
                                  lambda v: v ^ 0x10), 3000),
    "end_mark_moved": (_set(_SMALL, _segment_end(_SMALL, 3),
                            lambda v: v ^ 0x80 if v & 0x7F else v | 1), 3000),
    "blob_truncated": (_SMALL[:-1], 3000),
    "orig_plus_one": (_SMALL, 3001),
    "orig_minus_four": (_SMALL, 2996),
    "fse_header_size": (_set(_SMALL, 0, lambda v: v + 3), 3000),
    "raw_weight_changed": (_set(_RAW, 1, lambda v: v ^ 0x30), 1950),
    "csize_gt_dsize": (_SMALL, len(_SMALL) - 1),
    "dst_size_zero": (_SMALL, 0),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_corruption(name):
    blob, orig = CORRUPTIONS[name]
    try:
        want = jhuf.huf_decompress(blob, orig)
    except jhuf.HufError:
        want = None                         # the oracle rejects the blob
    try:
        got = th.huf_decompress_128([(blob, orig)], device="cpu")[0]
    except HufError:
        got = None
    assert got == want


def test_corruptions_reach_the_decode():
    """At least the cut segment is caught by the decode's status (the plan
    passes it), and the status names the blob and segment."""
    blob, orig = CORRUPTIONS["segment_cut_one_byte"]
    plan = th.prepare_huf128([(blob, orig)])
    out = torch.zeros(orig, dtype=torch.uint8)
    e = torch.empty(0, dtype=torch.uint8)
    status = th.huf_decode(**plan.stage("cpu"), flags=out, literals=e,
                           off16=e, off24=e)
    assert status.tolist() == [th.ERR_NOT_CONSUMED, 0, 0, 0]
    with pytest.raises(HufError, match="blob 0, segment 0: huf stream not"):
        th.raise_on_status(status, plan)


def test_all_rle_batch_launches_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(th, "huf_decode_plain", refuse)
    before = profiling.counters()["huf_decode.launches"]
    stored = gen(500, 1, proba=0.0)
    got = th.huf_decompress_128([(b"z", 100), (stored, 500), (b"\0", 7)],
                                device="cpu")
    assert got == [b"z" * 100, stored, b"\0" * 7]
    assert profiling.counters()["huf_decode.launches"] == before


def test_plan_and_row_checks():
    """The wrapper checks types on the host; a row outside its tensors is
    not decoded and gets ERR_BOUNDS (as in the kernel), the others decode."""
    blobs = _blob_batch([text_like(3000, 1), gen(1500, 3, proba=0.8)])
    plan = th.prepare_huf128(blobs)
    assert plan.segs.shape == (8, 6) and plan.tables.shape == (2, 4096)
    assert plan.names == ["blob 0", "blob 1"]
    out = torch.zeros(4500, dtype=torch.uint8)
    e = torch.empty(0, dtype=torch.uint8)
    args = dict(**plan.stage("cpu"), flags=out, literals=e, off16=e, off24=e)
    assert th.huf_decode(**args).tolist() == [0] * 8
    with pytest.raises(ValueError, match="int64"):
        th.huf_decode(**{**args, "segs": plan.segs.int()})
    with pytest.raises(ValueError, match="4 rows"):
        th.huf_decode(**{**args, "segs": plan.segs[:7]})
    short = torch.zeros(4499, dtype=torch.uint8)
    assert th.huf_decode(**{**args, "flags": short}).tolist() == \
        [0] * 7 + [th.ERR_BOUNDS]
    assert bytes(short[:3000].numpy()) == text_like(3000, 1)
    moved = plan.segs.clone()
    moved[5, 5] = 0                         # blob 1's segment 1 -> table 0
    moved[2, 1] = 10 ** 6                   # blob 0's segment 2 past data
    assert th.huf_decode(**{**args, "segs": moved}).tolist() == \
        [0, 0, th.ERR_BOUNDS, 0, 0, th.ERR_BOUNDS, 0, 0]
    with pytest.raises(HufError, match="blob 0, segment 2: segment table"):
        th.raise_on_status(th.huf_decode(**{**args, "segs": moved}), plan)


@functools.cache
def _lane_split_cases():
    return lane_split_cases()


@pytest.fixture
def one_thread():
    """The plain decode runs one small tensor step a symbol; test workers
    running side by side starve each other with intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LANE_SPLIT = ["equal_8bit", "equal_7bit", "one_bit_and_11_bit", "n_out_4",
              "n_out_124", "n_out_128", "n_out_132", "n_out_125",
              "segments_of_25000", "tablelog_12"]


@pytest.mark.parametrize("name", LANE_SPLIT)
def test_lane_split_cases_equal_reference(name, one_thread):
    """The hand-built blobs of the card's lane-split test (codes of one
    length that never self-synchronise, a 1-bit code among 11-bit ones,
    segments of 1-33 symbols, 25,000 symbols, tableLog 12) are valid
    streams: each segment through huf_decode_plain equals the JAX oracle's
    stream decode (ref/huf.py::_huf_decode_stream), and the blob, where
    it is shorter than its data, equals ref/huf.py::huf_decompress."""
    cases = {n: (blob, data) for n, blob, data in _lane_split_cases()}
    assert sorted(cases) == sorted(LANE_SPLIT)
    blob, data = cases[name]
    plan = segment_plan([(blob, len(data))])
    out = torch.zeros(len(data), dtype=torch.uint8)
    e = torch.empty(0, dtype=torch.uint8)
    status = th.huf_decode_plain(*plan, out, e, e, e)
    assert status.tolist() == [th.OK] * 4
    assert bytes(out.numpy()) == data
    weights, tl, h = jhuf.huf_read_stats(blob)
    assert tl == plan[3].item()
    sym, bits = jhuf.huf_build_dtable(weights, tl)
    body = blob[h + 6:]
    for src_off, ln, _, dst_off, n_out, _ in plan[1].tolist():
        br = jhuf.BitReader(body[src_off:src_off + ln])
        assert jhuf._huf_decode_stream(br, n_out, sym, bits, tl) == \
            data[dst_off:dst_off + n_out]
    if len(blob) < len(data):
        assert jhuf.huf_decompress(blob, len(data)) == data
        assert th.huf_decompress_128([(blob, len(data))], device="cpu") == \
            [data]


def test_lane_split_corruptions_equal_reference(one_thread):
    """The corrupt lane-split cases: the oracle rejects the cut segment and
    the zero end mark, and the plain version gives those segments the
    statuses that the card test expects of the kernel."""
    bad = corrupt_lane_split_cases(_lane_split_cases())
    for blob, n in bad[:2]:
        with pytest.raises(jhuf.HufError):
            jhuf.huf_decompress(blob, n)
    plan = segment_plan(bad)
    out = torch.zeros(sum(n for _, n in bad), dtype=torch.uint8)
    e = torch.empty(0, dtype=torch.uint8)
    status = th.huf_decode_plain(*plan, out, e, e, e).tolist()
    assert status[:8] == [th.ERR_NOT_CONSUMED, 0, 0, 0,
                          th.ERR_END_MARK, 0, 0, 0]


NEW_MODULES = ["device.py", "ref/__init__.py", "ref/huf.py",
               "ops/huf128.py", "ops/fuse.py", "ops/lane_huf.py",
               "ops/pallas_decode.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_new_modules_import_no_jax(rel):
    path = os.path.join(ROOT, "lizard_tpu_torch", rel)
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for mod in names:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "lizard_tpu",
                                             "bench"), (rel, mod)
