"""The plain reference decodes what the benchmark's frozen native encoder
and frame writer make back to their input, and the corpus is a function
of the seed alone."""

import os

import pytest

from h100_bench import corpus, frames, native
from h100_bench.reference import block_decode
from h100_bench.reference.constants import FLAG_FLAGS, FLAG_LITERALS
from h100_bench.reference import frame as ref_frame
from h100_bench.tests import tiny


def _corpus(seed, size=1 << 16):
    cfg = tiny.load_json(os.path.join(tiny.BENCH, "configs",
                                      "fastlz4-l10.json"))
    return corpus.build(seed, size, 1 << 14, cfg["corpus_kinds"])


def test_corpus_follows_the_seed():
    a, b = _corpus(2**31 + 3), _corpus(2**31 + 3)
    assert a == b and len(a) == 1 << 16
    assert _corpus(2**31 + 4) != a
    # the four kinds in turn: word text is the second part
    text = a[1 << 14:2 << 14]
    assert set(text) <= set(b"abcdefghijklmnopqrstuvwxyz ")
    assert len(set(a[:1 << 14])) > 40


@pytest.mark.parametrize("level", [10, 41])
def test_reference_decodes_native_streams(level):
    data = _corpus(5, 1 << 17)
    stream = native.compress(data, level)
    assert len(stream) < len(data)
    if level >= 30:   # the first inner block Huffman-codes a stream
        assert stream[1] & (FLAG_LITERALS | FLAG_FLAGS)
    assert block_decode.decompress(stream) == data


@pytest.mark.parametrize("level", [10, 41])
def test_reference_decodes_benchmark_frames(level):
    data = _corpus(6, 3 << 16)
    f = frames.write_frame(data, level, 1)
    parsed = ref_frame.parse(f, native.xxh32)
    assert len(parsed["blocks"]) == 2 and not parsed["linked"]
    assert parsed["checksum"] == native.xxh32(data)
    assert ref_frame.decode(f, native.xxh32) == data
    assert native.decompress_frame(f, len(data)) == data
    bad = bytearray(f)
    bad[-1] ^= 1
    with pytest.raises(ref_frame.FrameError):
        ref_frame.decode(bytes(bad), native.xxh32)


def test_reference_refuses_trailing_bytes():
    f = frames.write_frame(b"abc" * 100, 10, 1)
    with pytest.raises(ref_frame.FrameError):
        ref_frame.parse(f + b"\x00", native.xxh32)


def test_native_xxh32_matches_the_specification():
    # XXH32 of the empty input and of "abc", seed 0 (xxHash test vectors)
    assert native.xxh32(b"") == 0x02CC5D05
    assert native.xxh32(b"abc") == 0x32D153FF
