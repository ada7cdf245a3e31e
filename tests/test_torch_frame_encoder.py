"""The port's incremental frame layer (lizard_tpu_torch/frame.py::
FrameEncoder, FrameDecoder) against lizard_tpu/frame.py's on the CPU,
tolerance 0 (bytes are exact): the ref and native FrameEncoder byte-equal
to the JAX one, the gpu one (device="cpu": the plain encoder) byte-equal to
compress_frame_lanes with one encode_streams_lanes call per update; the
FrameDecoder (device="cpu": the plain decoders) returning the JAX
decoder's bytes update by update, for independent, linked, Huff0,
concatenated and skippable frames, the same exception classes, bounded
memory past the 16 MB window, and one decode batch per update and frame
(counted as calls of the plain lz_decode and huf_decode); the native
streaming xxh32 against the specification."""

import pytest

import lizard_tpu.frame as jframe
from lizard_tpu.ref.block_decode import CorruptError as JCorruptError
from lizard_tpu.utils.datagen import gen
from lizard_tpu.utils.xxh import XXH32 as JXXH32
from lizard_tpu_torch import frame as tframe
from lizard_tpu_torch import runtime
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import (
    LIZARDF_BLOCK_SIZES, LIZARDF_BLOCKUNCOMPRESSED_FLAG)
from lizard_tpu_torch.ops import huf128, lane_decode
from lizard_tpu_torch.utils.xxh import xxh32
from tests.torch_cases import one_thread  # noqa: F401


def _stream_compress(cls, data, chunk, **kw):
    enc = cls(**kw)
    out = bytearray(enc.begin())
    for i in range(0, len(data), chunk):
        out += enc.update(data[i:i + chunk])
    out += enc.end()
    return bytes(out)


@pytest.mark.parametrize("chunks", [(1, 7, 16, 1000), (15, 17, 65_536)])
def test_native_xxh32_stream_equals_spec(chunks):
    data = gen(70_000, 4)
    for seed in (0, 0x9747B28C):
        port, spec = runtime.XXH32(seed), JXXH32(seed)
        i = k = 0
        while i < len(data):
            n = chunks[k % len(chunks)]
            port.update(data[i:i + n])
            spec.update(data[i:i + n])
            i, k = i + n, k + 1
        assert port.digest() == spec.digest() == xxh32(data, seed)
    assert runtime.XXH32().digest() == xxh32(b"")


DATA = gen(150_000, 1, proba=0.6)


@pytest.mark.parametrize("kw, chunk", [
    (dict(level=14, block_size_id=1, backend="ref"), 1000),
    (dict(level=14, block_size_id=1, backend="ref",
          content_checksum=False), 65_536),
    (dict(level=14, block_size_id=1, backend="ref", block_linked=True),
     50_000),
    (dict(level=21, block_size_id=1, backend="ref", block_linked=True,
          content_size=len(DATA)), 7_000),
    (dict(level=11, block_size_id=1, backend="native"), 70_000),
    (dict(level=41, block_size_id=1, backend="native"), 200_000),
    (dict(level=21, block_size_id=1, backend="native", block_linked=True),
     30_000),
], ids=str)
def test_host_backends_equal_jax(kw, chunk):
    """backend="ref" and "native" write the JAX FrameEncoder's bytes; the
    independent ref frame equals the one-shot compress_frame."""
    frame = _stream_compress(tframe.FrameEncoder, DATA, chunk, **kw)
    assert frame == _stream_compress(jframe.FrameEncoder, DATA, chunk, **kw)
    assert jframe.decompress_frame(frame) == DATA
    if kw["backend"] == "ref" and not kw.get("block_linked"):
        assert frame == tframe.compress_frame(
            DATA, 14, 1, content_checksum=kw.get("content_checksum", True))


GPU_DATA = (gen(20_000, 3) * 14)[:280_000]      # few tokens: cheap to parse


@pytest.mark.parametrize("level, chunk, content_size", [
    (12, 100_000, False), (12, 280_000, True), (35, 280_000, False)])
def test_gpu_backend_equals_compress_frame_lanes(monkeypatch, level, chunk,
                                                 content_size):
    """backend="gpu" on device="cpu": one encode_streams_lanes call per
    update that completes whole blocks (all of them in it) and one for the
    flushed tail; the frame equals compress_frame_lanes' and decodes with
    the JAX decoder."""
    calls = []
    enc_fn = tframe.encode_streams_lanes
    monkeypatch.setattr(tframe, "encode_streams_lanes",
                        lambda parts, **kw: calls.append(len(parts))
                        or enc_fn(parts, **kw))
    enc = tframe.FrameEncoder(level, 1, content_size=len(GPU_DATA)
                              if content_size else None, device="cpu")
    out = bytearray(enc.begin())
    for i in range(0, len(GPU_DATA), chunk):
        out += enc.update(GPU_DATA[i:i + chunk])
    out += enc.end()
    bs = LIZARDF_BLOCK_SIZES[1]
    expect = []
    for i in range(0, len(GPU_DATA), chunk):
        whole = min(i + chunk, len(GPU_DATA)) // bs - i // bs
        if whole:
            expect.append(whole)
    assert calls == expect + [1]                # the flushed tail
    monkeypatch.undo()
    assert bytes(out) == tframe.compress_frame_lanes(
        GPU_DATA, level, 1, content_size=content_size, device="cpu")
    assert jframe.decompress_frame(bytes(out)) == GPU_DATA


def test_gpu_backend_refuses_linked_and_states():
    with pytest.raises(ValueError):
        tframe.FrameEncoder(12, block_linked=True, device="cpu")
    with pytest.raises(ValueError):
        tframe.FrameEncoder(12, backend="tpu")
    enc = tframe.FrameEncoder(12, device="cpu")
    with pytest.raises(tframe.FrameError):
        enc.update(b"x")                         # before begin
    enc.begin()
    enc.end()
    with pytest.raises(tframe.FrameError):
        enc.end()


@pytest.mark.parametrize("backend", ("gpu", "ref"))
def test_declared_content_size(backend):
    data = gen(5_000, 5, proba=0.6)
    frame = _stream_compress(tframe.FrameEncoder, data, 1000, level=14,
                             content_size=len(data), backend=backend,
                             device="cpu")
    assert jframe.decompress_frame(frame) == data
    enc = tframe.FrameEncoder(level=14, content_size=999, backend=backend,
                              device="cpu")
    enc.begin()
    enc.update(data)
    with pytest.raises(tframe.FrameError, match="declared 999, got 5000"):
        enc.end()


def test_flush_forces_partial_block():
    data = gen(10_000, 4, proba=0.6)
    enc = tframe.FrameEncoder(level=14, device="cpu")
    out = bytearray(enc.begin())
    assert enc.update(data) == b""               # < one block
    mid = enc.flush()
    assert mid
    out += mid + enc.update(data) + enc.end()
    assert tframe.decompress_frame(bytes(out), device="cpu") == data + data


FRAMES = {
    "independent-14": (gen(200_000, 9, proba=0.6), 14, False),
    "linked-14": (gen(200_000, 9, proba=0.6), 14, True),
    "linked-41": (gen(140_000, 2, proba=0.55), 41, True),
}


@pytest.fixture(scope="module")
def jax_frames():
    return {k: jframe.compress_frame(d, lv, 1, linked)
            for k, (d, lv, linked) in FRAMES.items()}


def _feed_both(src, chunk, **kw):
    """src through the port's FrameDecoder (device="cpu") and the JAX one,
    update by update; returns the port decoder and the joined output."""
    port = tframe.FrameDecoder(device="cpu", **kw)
    ref = jframe.FrameDecoder()
    out = bytearray()
    for i in range(0, len(src), chunk):
        got = port.update(src[i:i + chunk])
        assert got == ref.update(src[i:i + chunk]), i
        assert port.finished == ref.finished
        out += got
    assert bytes(port.buf) == bytes(ref.buf)
    return port, bytes(out)


@pytest.mark.parametrize("name", list(FRAMES))
@pytest.mark.parametrize("chunk", (33, 4096, 1 << 20))
def test_decoder_updates_equal_jax(jax_frames, name, chunk):
    data = FRAMES[name][0]
    dec, out = _feed_both(jax_frames[name], chunk)
    assert out == data and dec.finished


def test_decoder_ref_backend_equals_jax(jax_frames):
    for name, (data, _, _) in FRAMES.items():
        dec, out = _feed_both(jax_frames[name], 4096, backend="ref")
        assert out == data and dec.restaged == []


def test_decoder_concatenated_and_skippable(jax_frames):
    skip = (0x184D2A50 + 3).to_bytes(4, "little") + (1000).to_bytes(
        4, "little") + bytes(1000)
    tail = jframe.compress_frame(b"tail" * 100, 12, content_size=True)
    src = (jax_frames["linked-14"] + skip + jax_frames["independent-14"]
           + skip + tail)
    expect = FRAMES["linked-14"][0] + FRAMES["independent-14"][0] \
        + b"tail" * 100
    for chunk in (999, 70_000):
        dec, out = _feed_both(src, chunk)
        assert out == expect and dec.finished
    dec, out = _feed_both(skip, 3)
    assert out == b"" and dec.finished


def _blocks_at(frame: bytes):
    """(end offset, stored) of every block of a one-frame `frame`."""
    info = tframe.parse_frame_header(frame)
    p, ends = info.header_size, []
    while True:
        bsize = int.from_bytes(frame[p:p + 4], "little")
        p += 4
        if bsize == 0:
            return ends
        n = bsize & ~LIZARDF_BLOCKUNCOMPRESSED_FLAG
        p += n
        ends.append((p, bool(bsize & LIZARDF_BLOCKUNCOMPRESSED_FLAG)))


@pytest.mark.parametrize("name, chunk", [
    ("linked-14", 33), ("linked-14", 150_000), ("independent-14", 4096),
    ("linked-41", 50_000), ("linked-41", 1 << 20)])
def test_one_decode_batch_per_update(monkeypatch, jax_frames, name, chunk):
    """Each update decodes the compressed blocks it completes in one
    lz_decode call, after at most one huf_decode call (levels 30-49), and
    an update that completes none calls neither: counted as calls of the
    plain versions."""
    calls = {"lz": 0, "huf": 0}
    lz, huf = lane_decode.lz_decode_plain, huf128.huf_decode_plain

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(lane_decode, "lz_decode_plain", count("lz", lz))
    monkeypatch.setattr(huf128, "huf_decode_plain", count("huf", huf))
    frame = jax_frames[name]
    done = {(end - 1) // chunk for end, stored in _blocks_at(frame)
            if not stored}
    dec = tframe.FrameDecoder(device="cpu")
    for k, i in enumerate(range(0, len(frame), chunk)):
        before = dict(calls)
        dec.update(frame[i:i + chunk])
        n = int(k in done)
        assert calls["lz"] - before["lz"] == n, k
        assert calls["huf"] - before["huf"] == (n if name.endswith("41")
                                                else 0), k
    assert len(dec.restaged) == len(done) and dec.finished


def test_decoder_exception_classes(jax_frames):
    """A corrupt block raises CorruptError (as the JAX decoder's oracle
    does), a wrong checksum FrameError, in both decoders."""
    frame = bytearray(jax_frames["independent-14"])
    first = tframe.parse_frame_header(bytes(frame)).header_size + 4
    frame[first] = 99                               # a bad level byte
    for dec, err in ((tframe.FrameDecoder(device="cpu"), CorruptError),
                     (jframe.FrameDecoder(), JCorruptError)):
        with pytest.raises(err):
            dec.update(bytes(frame))
    frame = bytearray(jax_frames["linked-14"])
    frame[-1] ^= 1
    for dec in (tframe.FrameDecoder(device="cpu"), jframe.FrameDecoder()):
        with pytest.raises(ValueError, match="content checksum mismatch"):
            dec.update(bytes(frame))
    assert issubclass(tframe.FrameError, ValueError)


def test_decoder_content_size():
    frame = bytearray(jframe.compress_frame(b"abc" * 1000, 12,
                                            content_size=True))
    frame[6:14] = (3001).to_bytes(8, "little")
    frame[14] = (xxh32(bytes(frame[4:14])) >> 8) & 0xFF
    with pytest.raises(tframe.FrameError, match="content size mismatch"):
        tframe.FrameDecoder(device="cpu").update(bytes(frame))


def test_bounded_memory_past_the_window():
    """A linked frame of 20 MB in 4 MB frame blocks, fed a block at a time:
    the retained window stays under 16 MB + 128 KB, the history staged for
    a batch reaches the 16 MB cap from the fifth block on, and the output
    equals the input."""
    data = gen(1 << 16, 7) * 320                  # long matches at 64 KB
    frame = tframe.linked_frame(runtime.compress(data, 21), data, 4)
    dec = tframe.FrameDecoder(device="cpu")
    out, i = [], 0
    for end, _ in _blocks_at(frame) + [(len(frame), False)]:
        out.append(dec.update(frame[i:end]))       # a frame block an update
        i = end
        assert len(dec.out) <= (1 << 24) + 131_072
    assert b"".join(out) == data and dec.finished
    assert dec.restaged == [min(k << 22, 1 << 24) for k in range(5)]


def test_bounded_memory_both_directions():
    """The JAX test's loop: a linked ref FrameEncoder feeding a
    FrameDecoder; encoder window and decoder window stay bounded."""
    enc = tframe.FrameEncoder(level=11, block_linked=True, backend="ref")
    dec = tframe.FrameDecoder(device="cpu")
    out = bytearray(dec.update(enc.begin()))
    total = bytearray()
    for seed in range(6):
        chunk = gen(80_000, seed, proba=0.55)
        total += chunk
        out += dec.update(enc.update(chunk))
        assert len(enc._cs.buf) <= 2 * enc._cs.window + 131_072
        assert len(dec.out) <= (1 << 24) + 131_072
    out += dec.update(enc.end())
    assert bytes(out) == bytes(total) and dec.finished


def test_decoder_trim_does_not_break_checksum():
    data = gen(300_000, 9, proba=0.6)
    frame = jframe.compress_frame(data, 14, block_size_id=1)
    dec = tframe.FrameDecoder(device="cpu")
    out = bytearray()
    for i in range(0, len(frame), 33):
        out += dec.update(frame[i:i + 33])
    assert bytes(out) == data and dec.finished
    assert set(dec.restaged) == {0}             # independent: no history
