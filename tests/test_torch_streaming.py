"""The port's streaming layer (lizard_tpu_torch/streaming.py) against
lizard_tpu/streaming.py on the CPU, tolerance 0 (bytes are exact):
CompressStream's streams byte-equal to the JAX ones (chained, with a
dictionary, after save_dict and set_external_dict); DecompressStream,
decompress_using_dict and decompress_partial on device="cpu" (the plain
lz_decode: each stream one chain headed by the history) returning the JAX
ones' bytes call by call, the 64 KB ring case included; and the one
difference on purpose, decompress_partial's inner-block early exit."""

import pytest

import lizard_tpu.streaming as js
from lizard_tpu.ref.block_decode import CorruptError as JCorruptError
from lizard_tpu.ref.block_decode import decompress as j_decompress
from lizard_tpu.ref.block_encode import compress as j_compress
from lizard_tpu.utils.datagen import gen
from lizard_tpu_torch import streaming as ts
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import LIZARD_BLOCK_SIZE
from lizard_tpu_torch.ops import lane_decode
from tests.torch_cases import one_thread  # noqa: F401


def _chunks(data, size):
    return [data[i:i + size] for i in range(0, len(data), size)]


def _both_decode(streams, sizes, **kw):
    """Each stream through the port's DecompressStream (device="cpu") and
    the JAX one; their outputs, call by call, must be equal."""
    port = ts.DecompressStream(device="cpu", **kw)
    ref = js.DecompressStream(**kw)
    out = []
    for s, n in zip(streams, sizes):
        got = port.decompress_continue(s, n)
        assert got == ref.decompress_continue(s, n)
        assert port.history == ref.history
        out.append(got)
    return b"".join(out)


@pytest.mark.parametrize("level", (11, 17))
def test_compress_stream_equals_jax(level):
    """fuzzer.c:492-570 (double buffer): chunks compressed with the window
    of the earlier ones, a save_dict after every second chunk; every
    stream equal to the JAX one and decoded by both decoders."""
    data = gen(120_000, 11, proba=0.65)
    port, ref = ts.CompressStream(level), js.CompressStream(level)
    streams = []
    for i, chunk in enumerate(_chunks(data, 30_000)):
        s = port.compress_continue(chunk)
        assert s == ref.compress_continue(chunk)
        streams.append(s)
        if i % 2:
            assert port.save_dict(16_384) == ref.save_dict(16_384)
        assert port.buf == ref.buf
    assert _both_decode(streams, [30_000] * len(streams)) == data


def test_chained_streams_chain():
    """A second chunk's stream references the first (it is much shorter
    than a fresh stream), and decodes only with that history."""
    block = gen(40_000, 3, proba=0.5)
    cs = ts.CompressStream(11)
    first = cs.compress_continue(block)
    chained = cs.compress_continue(block)
    fresh = ts.CompressStream(11).compress_continue(block)
    assert len(chained) < len(fresh) * 0.5
    assert _both_decode([first, chained], [40_000] * 2) == block * 2
    with pytest.raises(CorruptError):      # an offset before the history
        ts.DecompressStream(device="cpu").decompress_continue(chained, 40_000)


def test_external_dict_equals_jax():
    """fuzzer.c:870-935: a dictionary in its own buffer, then
    set_external_dict switching to another; decoded by
    decompress_using_dict and decompress_partial with the dictionary."""
    dict_a = gen(30_000, 21, proba=0.6)
    dict_b = gen(20_000, 32, proba=0.6)
    payload = dict_a[5_000:15_000] + gen(5_000, 22, proba=0.4)
    port = ts.CompressStream(11, dict_data=dict_a)
    ref = js.CompressStream(11, dict_data=dict_a)
    comp = port.compress_continue(payload)
    assert comp == ref.compress_continue(payload)
    assert len(comp) < len(ts.CompressStream(11).compress_continue(payload))
    got = ts.decompress_using_dict(comp, len(payload), dict_a, device="cpu")
    assert got == js.decompress_using_dict(comp, len(payload), dict_a)
    assert got == payload
    part = ts.decompress_partial(comp, 5_000, 20_000, dict_data=dict_a,
                                 device="cpu")
    assert part == js.decompress_partial(comp, 5_000, 20_000, dict_a)
    assert part == payload[:5_000]
    port.set_external_dict(dict_b)
    ref.set_external_dict(dict_b)
    payload_b = dict_b[2_000:12_000]
    comp_b = port.compress_continue(payload_b)
    assert comp_b == ref.compress_continue(payload_b)
    assert ts.decompress_using_dict(comp_b, len(payload_b), dict_b,
                                    device="cpu") == payload_b


@pytest.mark.parametrize("max_history", (1 << 16, 1 << 24))
def test_ring_buffer_decode_equals_jax(max_history):
    """lib/lizard_decompress.h:118-134: a retained history of exactly one
    64 KB window (and the default) decodes a chained stream fed in 8 KB
    chunks, call by call as the JAX decoder does."""
    data = gen(120_000, 41, proba=0.6)
    cs = ts.CompressStream(11)
    streams = [cs.compress_continue(c) for c in _chunks(data, 8 * 1024)]
    sizes = [len(c) for c in _chunks(data, 8 * 1024)]
    assert _both_decode(streams, sizes, max_history=max_history) == data


def test_bounded_memory_long_stream():
    """The encoder's window state stays <= 2 windows + a chunk and the
    decoder's history <= max_history, however long the stream."""
    cs = ts.CompressStream(11)
    ds = ts.DecompressStream(max_history=1 << 16, device="cpu")
    for seed in range(8):
        chunk = gen(50_000, seed, proba=0.55)
        assert ds.decompress_continue(cs.compress_continue(chunk),
                                      len(chunk)) == chunk
        assert len(cs.buf) <= 2 * cs.window + 50_000
    assert len(ds.history) <= 1 << 16


def test_one_lz_decode_call_per_continue(monkeypatch):
    """Each decompress_continue is one decode batch (one call of the plain
    lz_decode here, one lz_decode launch on the card)."""
    calls = []
    plain = lane_decode.lz_decode_plain
    monkeypatch.setattr(lane_decode, "lz_decode_plain",
                        lambda *a: calls.append(1) or plain(*a))
    data = gen(40_000, 5, proba=0.6)
    cs = ts.CompressStream(11)
    ds = ts.DecompressStream(device="cpu")
    for i, chunk in enumerate(_chunks(data, 10_000)):
        assert ds.decompress_continue(cs.compress_continue(chunk),
                                      len(chunk)) == chunk
        assert len(calls) == i + 1


@pytest.fixture(scope="module")
def partial_stream():
    """The JAX test's stream: 300,000 bytes at -11, three inner blocks."""
    data = gen(300_000, 51, proba=0.6)
    return data, j_compress(data, 11)


@pytest.mark.parametrize("target", (0, 1, 100, 65_536, 131_072, 131_073,
                                    299_999, 300_000, 400_000))
def test_partial_equals_jax(partial_stream, target):
    data, comp = partial_stream
    got = ts.decompress_partial(comp, target, 310_000, device="cpu")
    assert got == js.decompress_partial(comp, target, 310_000)
    assert got == data[:target]


def test_partial_never_parses_past_target(partial_stream):
    """A truncated last block is never read while the target lies in an
    earlier block; the whole stream raises."""
    data, comp = partial_stream
    bad = comp[:-10]
    for target in (1_000, LIZARD_BLOCK_SIZE, 2 * LIZARD_BLOCK_SIZE):
        got = ts.decompress_partial(bad, target, 310_000, device="cpu")
        assert got == js.decompress_partial(bad, target, 310_000)
        assert got == data[:target]
    with pytest.raises(CorruptError):
        ts.decompress_partial(bad, 300_000, 310_000, device="cpu")
    with pytest.raises(JCorruptError):
        j_decompress(bad, 310_000)


def test_partial_short_inner_blocks():
    """A stream of three short inner blocks (three -21 streams' blocks
    joined): the first stage decodes one block, then more while the bytes
    fall short of the target."""
    parts = [gen(30_000, s, proba=0.6) for s in (1, 2, 3)]
    comp = bytes([21]) + b"".join(j_compress(p, 21)[1:] for p in parts)
    data = b"".join(parts)
    for target in (10, 30_000, 30_001, 75_000, 90_000, 100_000):
        got = ts.decompress_partial(comp, target, 90_000, device="cpu")
        assert got == js.decompress_partial(comp, target, 90_000)
        assert got == data[:target]


def _off16_stream(src: bytes) -> tuple[int, int]:
    """(start, end) of the off16 stream of the first inner block of a
    raw-coded LIZv1 stream."""
    p = 2
    p += 3 + int.from_bytes(src[p:p + 3], "little")      # len
    n = int.from_bytes(src[p:p + 3], "little")
    return p + 3, p + 3 + n


def test_partial_difference_on_purpose():
    """ROADMAP C, a difference on purpose: an offset out of the window in
    the block that reaches the target, but past the target. The oracle's
    token loop stops before it and returns the bytes; the card decodes
    whole inner blocks and raises CorruptError (the kernel's ERR_OFFSET)."""
    data = gen(20_000, 7, proba=0.6)
    comp = bytearray(j_compress(data, 21))
    a, b = _off16_stream(comp)
    assert b - a >= 2
    comp[b - 2:b] = b"\xff\xff"           # the last new offset: 65535
    comp = bytes(comp)
    assert js.decompress_partial(comp, 100, 20_000) == data[:100]
    with pytest.raises(CorruptError):
        ts.decompress_partial(comp, 100, 20_000, device="cpu")
