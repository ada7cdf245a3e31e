"""The Huff0 encoder of the port (ref/huf_encode.py and ops/enc_huf.py, the
plain version of kernel B8) against the JAX package on the CPU: the header
side equal to lizard_tpu/ref/huf_encode.py, the packed bitstreams equal to
its _huf_encode_1x and to the Pallas kernel in interpret mode, the blobs
equal to its huf_compress and to the native ltpu_huf_compress, and the
encoder's two entropy routes equal to each other and to the JAX pipeline.
Tolerance 0 throughout."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import lizard_tpu.ref.huf_encode as JR
import lizard_tpu_torch.ref.huf_encode as PR
from lizard_tpu.ops.enc_huf import emission_order as j_emission_order
from lizard_tpu.ops.enc_huf import huf_encode_streams_tpu
from lizard_tpu.ops.enc_lanes import EncCfg as JEncCfg
from lizard_tpu.ops.enc_lanes import encode_blocks_lanes as j_encode_blocks
from lizard_tpu.ref.block_decode import decompress as ref_decompress
from lizard_tpu.ref.huf import huf_decompress as j_huf_decompress
from lizard_tpu.utils.datagen import gen, text_like
import lizard_tpu_torch.ops.enc_huf as E
import lizard_tpu_torch.ops.enc_lanes as P
from lizard_tpu_torch import runtime
from lizard_tpu_torch.frame import compress_frame_lanes, decompress_frame_lanes
from lizard_tpu_torch.utils import profiling
from tests.test_torch_enc_maps import port_cfg
from tests.torch_cases import HUF_PACK_CASES, huf_pack_cases
from tests.torch_cases import one_thread  # noqa: F401


def _fib_stream(n_sym=20, seed=0):
    """Symbols 0..n_sym-1 with Fibonacci counts, shuffled: the natural
    Huffman tree is n_sym - 1 deep, so HUF_setMaxHeight cuts it to 11."""
    fib = [1, 1]
    while len(fib) < n_sym:
        fib.append(fib[-1] + fib[-2])
    syms = np.repeat(np.arange(n_sym, dtype=np.uint8), fib)
    return np.random.default_rng(seed).permutation(syms).tobytes()


_RNG = np.random.default_rng(9)
STREAMS = {
    "text": text_like(60_000, 11),
    "generated": gen(30_000, 12, proba=0.7),
    "incompressible": _RNG.integers(0, 256, 4000, np.uint8).tobytes(),
    "rle": b"\x42" * 500,
    "1025": text_like(1025, 3),
    "128k": gen(131_072, 5, proba=0.6),
    "few_symbols": _RNG.integers(0, 9, 5000, np.uint8).tobytes(),
    "skewed": _fib_stream(),
}


def _tables(src):
    """(sym_val, sym_nb_bits, huff_log, count, max_sym) of the port."""
    count, max_sym, _ = PR.fse_count(src, 255)
    hl = PR.fse_optimal_table_log(PR.HUF_TABLELOG_DEFAULT, len(src), max_sym,
                                  minus=1)
    nb, val, hl = PR.huf_build_ctable(count, max_sym, hl)
    return val, nb, hl, count, max_sym


# ------------------------------------------------------------ header side

@pytest.mark.parametrize("src,max_sym", [
    (STREAMS["text"], 255), (STREAMS["few_symbols"], 255), (b"", 255),
    (bytes([0, 3, 12, 12, 1, 5]), 12), (bytes(7), 12)], ids=str)
def test_count_equals_reference(src, max_sym):
    assert PR.fse_count(src, max_sym) == JR._fse_count(src, max_sym)


def test_count_rejects_symbols_above_max():
    with pytest.raises(ValueError):
        PR.fse_count(bytes([13]), 12)


@pytest.mark.parametrize("name", ["text", "generated", "few_symbols",
                                  "skewed", "128k"])
def test_build_ctable_equals_reference(name):
    src = STREAMS[name]
    val, nb, hl, count, max_sym = _tables(src)
    jcount, jmax, _ = JR._fse_count(src, 255)
    jhl = JR.fse_optimal_table_log(JR.HUF_TABLELOG_DEFAULT, len(src), jmax,
                                   minus=1)
    assert (nb, val, hl) == JR.huf_build_ctable(jcount, jmax, jhl)
    if name == "skewed":                  # 20 symbols: cut from depth 19
        assert max(nb) == 11 and len(count) == 20


@pytest.mark.parametrize("name", ["text", "generated", "few_symbols",
                                  "skewed", "1025"])
def test_write_ctable_equals_reference(name):
    val, nb, hl, _, max_sym = _tables(STREAMS[name])
    header = PR.huf_write_ctable(nb, max_sym, hl)
    assert header == JR.huf_write_ctable(nb, max_sym, hl)
    # FSE-compressed weights (first byte < 128) or raw nibbles
    assert (header[0] >= 128) == (name in ("few_symbols", "skewed"))


# ---------------------------------------------------------------- packing

def _table_row(val, nb):
    row = np.zeros(E.TABLE_ENTRIES, np.int32)
    row[:len(val)] = (np.asarray(nb, np.int32) << 16) | np.asarray(val)
    return row


def _pack_chunks(chunks, tables):
    """huf_pack_plain on one stream per chunk, its segment 0 the chunk and
    segments 1-3 empty; returns each chunk's bitstream (end mark
    included)."""
    rows, cursor, words = [], 0, 0
    for t, c in enumerate(chunks):
        for length in (len(c), 0, 0, 0):
            rows.append((cursor, length, t, words))
            words += E.segment_words(length)
        cursor += len(c)
    data = torch.from_numpy(np.frombuffer(b"".join(chunks), np.uint8).copy())
    tabs = torch.from_numpy(np.stack([_table_row(v, nb) for v, nb in tables]))
    w, bits, status = E.huf_pack_plain(data, torch.tensor(rows), tabs, words)
    assert (status == E.OK).all()
    raw = w.numpy().astype("<i4").tobytes()
    out = []
    for t in range(len(chunks)):
        w0, b = 4 * rows[4 * t][3], int(bits[4 * t])
        assert raw[w0 + (b + 8) // 8:4 * rows[4 * t + 1][3]].strip(b"\0") == b""
        out.append(raw[w0:w0 + (b + 8) // 8])
    return out


def _mixed_chunks():
    """The 8 streams of tests/test_enc_huf.py::test_stream_bit_exact."""
    rng = np.random.default_rng(5)
    return [text_like(5000, 1), gen(8000, 2, proba=0.8),
            bytes(rng.integers(0, 12, 3000, np.uint8)),
            text_like(317, 3), gen(129, 4, proba=0.5),
            bytes([7]) * 100 + bytes(rng.integers(0, 255, 50, np.uint8)),
            text_like(20000, 6), b"ab"]


def test_pack_plain_equals_encode_1x():
    chunks = _mixed_chunks()
    tables = [_tables(c)[:2] for c in chunks]
    for c, (val, nb), got in zip(chunks, tables, _pack_chunks(chunks, tables)):
        assert got == JR._huf_encode_1x(c, val, nb)


@pytest.mark.parametrize("n", [4000, 4001, 4002, 4003])
def test_pack_plain_length_mod_4(n):
    c = gen(n, n, proba=0.4)
    val, nb = _tables(c)[:2]
    assert _pack_chunks([c], [(val, nb)])[0] == JR._huf_encode_1x(c, val, nb)


def test_pack_plain_32k_segment_of_11_bit_codes():
    c = (_fib_stream(20, 1) * 2)[:32768]
    val, nb = _tables(c)[:2]
    assert max(nb[b] for b in set(c)) == 11
    assert _pack_chunks([c], [(val, nb)])[0] == JR._huf_encode_1x(c, val, nb)


def test_pack_plain_equals_pallas_kernel():
    """Eight streams at once, against the Pallas kernel in interpret mode."""
    chunks = [c[:1500] for c in _mixed_chunks()]
    tables = [_tables(c)[:2] for c in chunks]
    assert _pack_chunks(chunks, tables) == huf_encode_streams_tpu(
        chunks, tables, interpret=True)


def test_emission_order_equals_reference():
    for n in range(12):
        assert np.array_equal(E.emission_order(n), j_emission_order(n))


def _status_case():
    """Two streams of 'abc' * 40, each as 4 segments of 30 symbols, table
    rows 0 and 1; returns (data, rows, tables, n_words)."""
    data = torch.from_numpy(np.frombuffer(b"abc" * 80, np.uint8).copy())
    rows, words = [], 0
    for k in range(8):
        rows.append([30 * k, 30, k // 4, words])
        words += E.segment_words(30)
    val, nb = _tables(b"abc" * 40)[:2]
    tabs = np.stack([_table_row(val, nb)] * 2)
    return data, rows, tabs, words


@pytest.mark.parametrize("fault,want", [
    ("no_code", E.ERR_NO_CODE), ("overflow", E.ERR_OVERFLOW),
    ("src_outside", E.ERR_BOUNDS), ("table_outside", E.ERR_BOUNDS),
    ("tables_differ", E.ERR_BOUNDS), ("words_outside", E.ERR_BOUNDS)])
def test_pack_plain_status(fault, want):
    """A faulty second stream: its segments get the status, zero words and
    0 bits; the first stream's output is what it is alone."""
    data, rows, tabs, words = _status_case()
    good = E.huf_pack_plain(data, torch.tensor(rows), torch.from_numpy(tabs),
                            words)
    bad_rows = range(4, 8)
    if fault == "no_code":
        tabs[1, ord("b")] = 0
    elif fault == "overflow":          # 20-bit codes: 600 bits > 12 words
        tabs[1] = np.where(tabs[1] != 0, (20 << 16) | (tabs[1] & 0xFFFF), 0)
    elif fault == "src_outside":
        rows[7][0] = 230
        bad_rows = [7]
    elif fault == "table_outside":
        for r in range(4, 8):
            rows[r][2] = 2
    elif fault == "tables_differ":
        rows[6][2] = 0
        bad_rows = [6]
    else:
        rows[7][3] = words - 1
        bad_rows = [7]
    w, bits, status = E.huf_pack_plain(data, torch.tensor(rows),
                                       torch.from_numpy(tabs), words)
    for s in range(8):
        if s in bad_rows:
            assert int(status[s]) == want and int(bits[s]) == 0
        else:
            assert int(status[s]) == E.OK and bits[s] == good[1][s]
    if fault in ("no_code", "overflow"):
        assert (w[rows[4][3]:] == 0).all()
    assert torch.equal(w[:rows[4][3]], good[0][:rows[4][3]])


@functools.cache
def _huf_pack_cases():
    return {name: (plan, expect) for name, plan, expect in huf_pack_cases()}


@pytest.mark.parametrize("name", HUF_PACK_CASES)
def test_pack_cases_plain_equal_encode_1x(name):
    """The plans that bound the kernel's split (tests/torch_cases.py::
    huf_pack_cases): each coded segment's bitstream byte-equal to the
    reference's _huf_encode_1x under its table row, the statuses those
    the case expects, and every other word zero: past each bitstream in
    its reservation, over an error segment's words, and outside every
    reservation."""
    (data, segs, tables, n_words), expect = _huf_pack_cases()[name]
    words, bits, status = E.huf_pack_plain(data, segs, tables, n_words)
    assert status.tolist() == expect
    raw = bytearray(words.numpy().astype("<i4").tobytes())
    src = data.numpy().tobytes()
    for s, (off, n, row, w0) in enumerate(segs.tolist()):
        if expect[s] == E.ERR_BOUNDS:
            continue
        end = 4 * (w0 + E.segment_words(n))
        if expect[s] == E.OK:
            entry = tables[row].numpy().astype(np.int64)
            want = JR._huf_encode_1x(src[off:off + n],
                                     (entry & 0xFFFF).tolist(),
                                     (entry >> 16).tolist())
            assert bytes(raw[4 * w0:4 * w0 + len(want)]) == want
            assert len(want) == (int(bits[s]) + 8) // 8
            raw[4 * w0:4 * w0 + len(want)] = bytes(len(want))
        else:
            assert int(bits[s]) == 0
        assert not any(raw[4 * w0:end])
    assert not any(raw)


def test_pack_profile_runs_on_the_card_only():
    """The profiling instance has no plain version: CPU tensors raise."""
    (data, segs, tables, n_words), _ = _huf_pack_cases()["every_shift"]
    with pytest.raises(ValueError, match="cuda"):
        E.huf_pack_profile(data, segs, tables, n_words)


# ------------------------------------------------------------------ blobs

@pytest.mark.parametrize("name", sorted(STREAMS))
def test_compress_batch_equals_reference_and_native(name):
    d = STREAMS[name]
    got = E.huf_compress_batch([d], device="cpu")[0]
    assert got == JR.huf_compress(d)
    assert (got or b"") == runtime.huf_compress(d)
    if got is not None and len(got) > 1:
        assert bytes(j_huf_decompress(got, len(d))) == d


def test_compress_batch_whole_batch():
    """Every stream kind in one call, with empty, tiny and repeated
    streams; one plan, one huf_pack call."""
    streams = list(STREAMS.values()) + [b"", b"ab" * 7, STREAMS["text"]]
    plan = E.plan_huf_streams(streams)
    assert len(plan.coded) == 7 and plan.segs.shape == (28, 4)
    got = E.huf_compress_batch(streams, device="cpu")
    assert got == [JR.huf_compress(d) if d else None for d in streams]


def test_compress_batch_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.huf_compress_batch([STREAMS["text"]])


# --------------------------------------------------------------- pipeline

HUF_PACK = E.huf_pack


@pytest.fixture
def pack_calls(monkeypatch):
    """Counts huf_pack calls: on the CPU the wrapper runs the plain version
    and launches nothing, so its launch count stays 0."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[1].shape[0] if args else kw["segs"].shape[0])
        return HUF_PACK(*args, **kw)

    monkeypatch.setattr(E, "huf_pack", spy)
    return calls


def _huffman_blocks(seed):
    """Blocks whose flags or literals pass the 1024-byte gate, one of them
    with both Huffman-coded (a 9-symbol alphabet), and a few that code
    nothing."""
    a = gen(9000, seed, proba=0.5)
    few = np.random.default_rng(seed).integers(0, 9, 16_384, np.uint8)
    return [text_like(16_384, seed), gen(16_384, seed + 1, proba=0.6),
            (a + a)[:12_000], gen(3000, seed + 2), b"", few.tobytes()]


@pytest.mark.parametrize("level", [35, 45])
def test_encode_blocks_entropy_routes_equal(level, pack_calls):
    """entropy="gpu" (huf_pack) byte-equal to entropy="host" (native
    Huff0), blocks long enough for streams past the 1024-byte gate; the
    Huffman stage ran and coded streams of both kinds."""
    cfg = dataclasses.replace(P.cfg_for_level(level), n=16_384)
    blocks = _huffman_blocks(level)
    launches = profiling.counters()["huf_pack.launches"]
    got = P.encode_blocks_lanes(blocks, level, cfg=cfg, device="cpu")
    assert len(pack_calls) == 1 and pack_calls[0] >= 8
    # no kernel on the CPU
    assert profiling.counters()["huf_pack.launches"] == launches
    assert got == P.encode_blocks_lanes(blocks, level, cfg=cfg, device="cpu",
                                        entropy="host")
    headers = [s[1] for s in got if len(s) > 1]
    assert 3 in headers                           # flags and literals
    for d, e in zip(blocks, got):
        assert bytes(ref_decompress(e, max_out=max(len(d), 1))) == d


def test_encode_blocks_equals_pallas_pipeline(pack_calls):
    """At -35 under the small geometry of tests/test_enc_huf.py, equal to
    the JAX package's encode_blocks_lanes in interpret mode."""
    jcfg = JEncCfg(n=8192, hl=10, maxoff=2047,
                   probes=(8, 12, 16, 24, 32, 64, 128, 256))
    blocks = [text_like(8192, 31), text_like(8192, 32)]
    want = j_encode_blocks(blocks, level=35, cfg=jcfg, interpret=True)
    got = P.encode_blocks_lanes(blocks, level=35, cfg=port_cfg(jcfg),
                                device="cpu")
    assert pack_calls and got == want
    for d, e in zip(blocks, got):
        assert bytes(ref_decompress(e, max_out=len(d))) == d


def test_below_30_no_huffman_stage(pack_calls):
    cfg = dataclasses.replace(P.cfg_for_level(11), n=16_384)
    P.encode_blocks_lanes(_huffman_blocks(11)[:2], 11, cfg=cfg, device="cpu")
    assert pack_calls == []


def test_frame_entropy_routes(pack_calls):
    a = gen(12_000, 41, proba=0.62)
    d = a + text_like(8_000, 4) + a
    frame = compress_frame_lanes(d, level=41, device="cpu")
    assert pack_calls
    assert frame == compress_frame_lanes(d, level=41, device="cpu",
                                         entropy="host")
    assert decompress_frame_lanes(frame, device="cpu") == d
    with pytest.raises(ValueError, match="entropy"):
        P.encode_blocks_lanes([d], 41, device="cpu", entropy="tpu")
