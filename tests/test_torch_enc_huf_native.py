"""The encoder's native Huff0 plan (ops/enc_huf.py::plan_huf_streams over
csrc/huf_plan.cpp) against its plain version, plan_huf_streams_plain over
ref/huf_encode.py: the same HufEncPlan, field for field, on every stream
kind and gate, on weights headers raw, FSE-coded and refused, on code
tables cut to 11 bits, and on the -41 flags and literals streams of the
benchmark corpus; the blobs of huf_compress_batch equal to the JAX
package's reference HUF_compress and to the native Huff0; and the
counter. CPU only."""

import numpy as np
import pytest
import torch

import lizard_tpu.ref.huf_encode as JR
import lizard_tpu_torch.ops.enc_huf as E
import lizard_tpu_torch.ref.huf_encode as PR
from lizard_tpu_torch import runtime
from lizard_tpu_torch.format.constants import HUF_MIN_STREAM_LEN
from lizard_tpu_torch.ops import split as tsplit
from lizard_tpu_torch.utils import profiling
from lizard_tpu_torch.utils.datagen import build_corpus, gen
from tests.test_torch_enc_huf import STREAMS, _fib_stream
from tests.torch_cases import one_thread  # noqa: F401

TENSORS = ("data", "segs", "tables")
LISTS = ("n_words", "coded", "headers", "blobs")


def _assert_same(got, want):
    for f in TENSORS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    for f in LISTS:
        assert getattr(got, f) == getattr(want, f), f


def _plans_agree(streams):
    """The native plan of `streams`, asserted equal to the plain plan."""
    got = E.plan_huf_streams(streams)
    _assert_same(got, E.plan_huf_streams_plain(streams))
    return got


def _header(src):
    """(weights header or None, nbBits per symbol, max_sym, the table log
    it was built for) of the plain reference's code table of src."""
    count, max_sym, _ = PR.fse_count(src, 255)
    log = PR.fse_optimal_table_log(PR.HUF_TABLELOG_DEFAULT, len(src),
                                   max_sym, minus=1)
    nb, _, huff_log = PR.huf_build_ctable(count, max_sym, log)
    return PR.huf_write_ctable(nb, max_sym, huff_log), nb, max_sym, log


def _shuffled(counts, seed=0):
    """Symbols 0.. with the given counts, in a seeded random order."""
    syms = np.repeat(np.arange(len(counts), dtype=np.uint8), counts)
    return np.random.default_rng(seed).permutation(syms).tobytes()


def _compress_agrees(streams, reference=JR.huf_compress):
    """huf_compress_batch on the CPU equals the JAX package's reference
    HUF_compress (or `reference`) and the native Huff0 on every stream."""
    got = E.huf_compress_batch(streams, device="cpu")
    assert got == [reference(d) if d else None for d in streams]
    assert [g or b"" for g in got] == [runtime.huf_compress(d)
                                       for d in streams]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_native_plan_equals_plain(name):
    plan = _plans_agree([STREAMS[name]])
    assert plan.coded == ([] if name in ("incompressible", "rle") else [0])


def test_native_plan_whole_batch():
    """Every stream kind and gate in one batch: empty, tiny, repeated, one
    byte value (RLE), flat (no count over n/128 + 1: stored) and over
    128 KiB (stored)."""
    flat = bytes(range(256)) * 40
    over = gen(131_073, 3, proba=0.6)
    streams = (list(STREAMS.values())
               + [b"", b"ab" * 7, STREAMS["text"], b"\x07" * 3000, flat,
                  over, b"\x00", STREAMS["generated"]])
    plan = _plans_agree(streams)
    names = list(STREAMS) + ["empty", "tiny", "text again", "rle 3000",
                             "flat", "over", "one byte", "generated again"]
    kinds = {names[i]: ("coded" if i in plan.coded
                        else "rle" if plan.blobs[i] is not None
                        else "stored") for i in range(len(streams))}
    assert kinds == {
        **{k: "coded" for k in STREAMS}, "incompressible": "stored",
        "rle": "rle", "empty": "stored", "tiny": "stored",
        "text again": "coded", "rle 3000": "rle", "flat": "stored",
        "over": "stored", "one byte": "rle", "generated again": "coded"}
    assert plan.blobs[names.index("rle 3000")] == b"\x07"
    # the native Huff0 leaves a one-byte stream uncoded, where the
    # reference calls it RLE; the encoder codes none under 1025 bytes
    _compress_agrees([s for s in streams
                      if 1 < len(s) <= len(STREAMS["128k"])])


def _headers():
    """Streams whose weights header is FSE-coded, raw 4-bit weights, too
    long for the stream (stored; past it, and header and 12 bytes equal to
    it), or cannot be written (over 128 symbols whose weights do not
    compress: stored)."""
    # 193 symbols, the first 192 at depth 8 and the last at depth 2: all
    # 192 written weights equal (FSE's rle case), too many for nibbles
    no_header = _shuffled([3] * 192 + [192], 1)
    return {"fse": STREAMS["text"], "raw": STREAMS["few_symbols"],
            "raw_skewed": STREAMS["skewed"],
            "too_long": _shuffled([5] + [1] * 15, 3),
            "too_long_by_0": _shuffled([6] + [1] * 15, 3),
            "none": no_header}


@pytest.mark.parametrize("case", sorted(_headers()))
def test_native_plan_weights_headers(case):
    src = _headers()[case]
    header, _, max_sym, _ = _header(src)
    want = {"fse": lambda h: h is not None and h[0] < 128,
            "raw": lambda h: h is not None and h[0] >= 128,
            "raw_skewed": lambda h: h is not None and h[0] >= 128,
            "too_long": lambda h: h is not None and len(h) + 12 > len(src),
            "too_long_by_0": lambda h: (h is not None
                                        and len(h) + 12 == len(src)),
            "none": lambda h: h is None and max_sym > 128}
    assert want[case](header)
    plan = _plans_agree([src])
    assert plan.coded == ([0] if case.startswith(("fse", "raw")) else [])
    if plan.coded:
        assert plan.headers == [header]
    # the JAX package's copy raises where no header can be written; the
    # port's reference stores the stream, as the native encoder does
    _compress_agrees([src], JR.huf_compress if header else PR.huf_compress)


# code lengths of 85 symbols (a complete tree) whose weights' FSE counts
# take FSE_normalizeM2, the second normalisation, and whose FSE-coded
# weights are short enough to be the header
M2_DEPTHS = [6, 8, 7, 7, 8, 7, 9, 9, 8, 2, 4, 5, 5, 4, 4, 8, 8, 8, 10, 10, 8,
             11, 11, 9, 10, 10, 10, 9, 9, 9, 9, 10, 10, 7, 7, 11, 11, 11, 11,
             3, 8, 11, 11, 7, 9, 9, 7, 9, 9, 9, 9, 11, 11, 10, 10, 9, 9, 8,
             8, 10, 10, 6, 6, 11, 11, 8, 8, 4, 10, 10, 8, 8, 6, 6, 8, 9, 9,
             5, 5, 10, 10, 11, 11, 9, 9]


def test_native_plan_weights_second_normalisation(monkeypatch):
    src = _shuffled([32 << (11 - d) for d in M2_DEPTHS], 1)
    calls = []
    m2 = PR._fse_normalize_m2
    monkeypatch.setattr(PR, "_fse_normalize_m2",
                        lambda *a: calls.append(1) or m2(*a))
    header = _header(src)[0]
    assert calls and header[0] < 128
    plan = _plans_agree([src])
    assert plan.headers == [header]
    _compress_agrees([src])


@pytest.mark.parametrize("max_sym", [1, 2, 11, 127, 128, 129, 200, 255])
def test_native_plan_max_sym(max_sym):
    """Alphabets whose largest symbol is max_sym, at the raw-header limit
    of 128 and past it."""
    rng = np.random.default_rng(max_sym)
    p = 0.8 ** np.arange(max_sym + 1)
    src = rng.choice(max_sym + 1, 20_000, p=p / p.sum()).astype(np.uint8)
    src[-1] = max_sym
    src = src.tobytes()
    assert PR.fse_count(src, 255)[1] == max_sym
    _plans_agree([src])
    _compress_agrees([src])


@pytest.mark.parametrize("n_sym,seed", [(14, 3), (16, 3), (18, 3), (20, 0),
                                        (22, 1), (24, 1)])
def test_native_plan_limits_code_length(n_sym, seed):
    """Fibonacci counts: the natural tree is n_sym - 1 deep, past the
    table log (8 to 11 bits by the stream's size), so HUF_setMaxHeight
    cuts it."""
    src = _fib_stream(n_sym, seed)
    _, nb, _, log = _header(src)
    assert max(nb) == log < n_sym - 1
    _plans_agree([src])
    _compress_agrees([src])


def test_native_plan_random_skews():
    """Sixty streams of random geometric, power-law and near-flat
    alphabets, sizes
    from just over HUF_MIN_STREAM_LEN to 128 KiB: the height limit's
    repayments, both normalisations of the weights and every gate."""
    rng = np.random.default_rng(20)
    streams = []
    for k in range(60):
        n_sym = int(rng.integers(2, 257))
        if k % 3 == 0:
            p = rng.uniform(0.3, 0.95) ** np.arange(n_sym)
        elif k % 3 == 1:
            p = rng.random(n_sym) ** rng.uniform(1, 30)
        else:                             # near flat: some are stored
            p = rng.random(n_sym) ** rng.uniform(0, 0.3)
        n = int(rng.integers(HUF_MIN_STREAM_LEN + 1, 131_073))
        streams.append(rng.choice(n_sym, n, p=p / p.sum())
                       .astype(np.uint8).tobytes())
    plan = _plans_agree(streams)
    assert 0 < len(plan.coded) < len(streams)
    raw = [h[0] >= 128 for h in plan.headers]
    assert any(raw) and not all(raw)


@pytest.fixture(scope="module")
def corpus_streams():
    """The -41 flags and literals streams over HUF_MIN_STREAM_LEN of the
    first two 4 MiB parts of the corpus (seeds 0 and 1), as the native
    encoder emitted them: each part compressed by the native encoder at
    -41, its inner blocks split and their Huff0 streams decoded."""
    corpus = build_corpus(8 << 20)
    parts = []
    for k in range(2):
        acc = tsplit.new_accumulator()
        tsplit.split_into([runtime.compress(corpus[k << 22:(k + 1) << 22],
                                            41)], acc)
        parts.append([bytes(s) for name in ("flags", "literals")
                      for s in acc[name] if len(s) > HUF_MIN_STREAM_LEN])
    return parts


@pytest.mark.parametrize("part", [0, 1])
def test_native_plan_corpus_part(corpus_streams, part):
    streams = corpus_streams[part]
    assert len(streams) > 32
    plan = _plans_agree(streams)
    assert len(plan.coded) > len(streams) // 2
    for k in range(0, len(streams), 32):
        batch = streams[k:k + 32]
        got = E.huf_compress_batch(batch, device="cpu")
        assert [g or b"" for g in got] == [runtime.huf_compress(d)
                                           for d in batch]
    few = streams[::len(streams) // 3]
    assert (E.huf_compress_batch(few, device="cpu")
            == [JR.huf_compress(d) for d in few])


def test_native_streams_counter():
    """huf_plan.native_streams adds up every stream the native pass
    planned, stored and RLE ones included; the plain plan counts none."""
    streams = [STREAMS["text"], b"", STREAMS["rle"], bytes(range(256)) * 8,
               STREAMS["skewed"]]
    profiling.reset()
    assert profiling.counters()["huf_plan.native_streams"] == 0
    E.plan_huf_streams_plain(streams)
    assert profiling.counters()["huf_plan.native_streams"] == 0
    E.plan_huf_streams(streams)
    assert profiling.counters()["huf_plan.native_streams"] == 5
    E.huf_compress_batch(streams[:2], device="cpu")
    E.plan_huf_streams([])
    assert profiling.counters()["huf_plan.native_streams"] == 7
    profiling.reset()
