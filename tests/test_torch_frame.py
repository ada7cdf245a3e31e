"""The port's frame decode and one-shot API (lizard_tpu_torch.frame, .api)
against lizard_tpu.frame: the same frames decode to the same bytes, the
port's fast frame encoder writes the same bytes, and malformed frames raise
FrameError. The port runs on the CPU here (device="cpu")."""

import numpy as np
import pytest
import torch

import lizard_tpu.frame as jframe
from lizard_tpu.ref.block_encode import compress as jref_compress
import lizard_tpu_torch
from lizard_tpu import runtime as jrt
import lizard_tpu_torch.frame as tframe
from lizard_tpu.utils.datagen import gen, text_like
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.ops.enc_lanes import encode_streams_lanes
from lizard_tpu_torch.ops.fuse import build_fused_plan
from lizard_tpu_torch.runtime import xxh32
from lizard_tpu_torch.utils import profiling


def _data(n, seed):
    rng = np.random.default_rng(seed)
    stored = rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes()
    return (gen(n // 2, seed=seed, proba=0.6) + stored
            + text_like(n - n // 2 - len(stored), seed=seed))


@pytest.mark.parametrize("level,bsid,n", [(10, 1, 400_000), (21, 1, 400_000),
                                          (10, 4, 1_300_000),
                                          (21, 4, 1_300_000)])
def test_frames_equal_reference(level, bsid, n):
    data = _data(n, seed=level + bsid)
    frame = jframe.compress_frame_fast(data, level, block_size_id=bsid)
    assert frame[5] >> 4 == bsid        # 4 MB blocks: 10 chained inner blocks
    assert tframe.compress_frame_fast(data, level, block_size_id=bsid) == frame
    got = tframe.decompress_frame_lanes(frame, device="cpu")
    assert got == data == jframe.decompress_frame(frame)
    assert tframe.decoded_size_bound(frame) == jframe.decoded_size_bound(frame)
    info, ref = tframe.parse_frame_header(frame), jframe.parse_frame_header(frame)
    assert vars(info) == vars(ref)


def test_frame_with_stored_blocks_and_huffman_level():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 140_000, dtype=np.uint8).tobytes() \
        + text_like(200_000, seed=2)
    frame = tframe.compress_frame_fast(data, 41, block_size_id=1,
                                       content_size=True)
    assert lizard_tpu_torch.decompress_frame(frame, device="cpu") == data
    assert jframe.decompress_frame(frame) == data


def test_lanes_frame_shares_the_frame_walk():
    """decompress_frame_lanes decodes a -41 blockIndependent frame with a
    stored block (an incompressible part) as decompress_frame does: one
    batch in which every frame block is a chain, the stored one of
    literal-only inner blocks, not joined on the host; the same bytes as
    the JAX decoder."""
    rng = np.random.default_rng(19)
    data = (text_like(131_072, seed=19)
            + rng.integers(0, 256, 131_072, dtype=np.uint8).tobytes()
            + gen(200_000, seed=19, proba=0.6))
    frame = tframe.compress_frame_fast(data, 41, block_size_id=1)
    blocks = _frame_blocks(frame)
    assert [s for s, _ in blocks] == [False, True, False, False]
    assert build_fused_plan([blocks[0][1]])[1].segs.shape[0]   # Huff0 blobs
    before = profiling.counters()["lz_decode.chains"]
    got = tframe.decompress_frame_lanes(frame, device="cpu")
    assert profiling.counters()["lz_decode.chains"] == before + len(blocks)
    assert got == data == jframe.decompress_frame(frame)
    assert got == tframe.decompress_frame(frame, device="cpu")


def test_malformed_frames_raise():
    data = gen(200_000, seed=4)
    frame = bytearray(tframe.compress_frame_fast(data, 10))
    bad = bytes(frame[:-1]) + bytes([frame[-1] ^ 1])      # content checksum
    with pytest.raises(tframe.FrameError, match="checksum"):
        tframe.decompress_frame_lanes(bad, device="cpu")
    with pytest.raises(tframe.FrameError):
        tframe.decompress_frame_lanes(bytes(frame[:-9]), device="cpu")
    with pytest.raises(tframe.FrameError, match="trailing"):
        tframe.decompress_frame_lanes(bytes(frame) + b"x", device="cpu")
    # a linked frame: clear the blockIndependent bit, re-sign the header
    linked = bytearray(frame)
    linked[4] &= ~(1 << 5)
    linked[6] = (xxh32(bytes(linked[4:6])) >> 8) & 0xFF
    with pytest.raises(tframe.FrameError, match="blockIndependent"):
        tframe.decompress_frame_lanes(bytes(linked), device="cpu")
    corrupt = bytearray(frame)
    corrupt[15] ^= 0xFF                     # inside block 0's streams
    with pytest.raises(tframe.FrameError):
        tframe.decompress_frame_lanes(bytes(corrupt), device="cpu")


def test_api(monkeypatch):
    data = gen(150_000, seed=6)
    for level in (10, 21, 35):
        comp = lizard_tpu_torch.compress(data, level, backend="native")
        assert lizard_tpu_torch.decompress(comp, device="cpu") == data
        with pytest.raises(CorruptError):
            lizard_tpu_torch.decompress(comp, max_out=1000, device="cpu")
    small = data[:5000]
    comp = lizard_tpu_torch.compress(small, 10, backend="ref")
    assert comp == jref_compress(small, 10)
    assert lizard_tpu_torch.decompress(comp, backend="ref") == small
    with pytest.raises(NotImplementedError):
        lizard_tpu_torch.compress(data, 10, backend="tpu")
    frame = tframe.compress_frame_fast(data, 10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lizard_tpu_torch.decompress(comp)
    with pytest.raises(RuntimeError, match="CUDA"):
        lizard_tpu_torch.decompress_frame(frame)


@pytest.fixture
def one_thread():
    """The device encoder's plain versions run many small tensor
    operations: one torch thread, as in tests/test_torch_enc_*.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("level", [11, 35])
def test_api_compress_defaults_to_the_device_encoder(level, monkeypatch,
                                                     one_thread):
    """compress(data, level) is the device encoder: with device="cpu" it
    equals encode_streams_lanes (the plain versions), and without a card
    the default device raises."""
    data = gen(40_000, seed=level, proba=0.6)
    comp = lizard_tpu_torch.compress(data, level, device="cpu")
    assert comp == encode_streams_lanes([data], level, device="cpu")[0]
    assert lizard_tpu_torch.decompress(comp, device="cpu") == data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lizard_tpu_torch.compress(data, level)


# ------------------------------------- every frame the JAX package decodes

def _resign(frame: bytearray) -> bytes:
    """The frame with its header checksum recomputed (no content size)."""
    frame[6] = (xxh32(bytes(frame[4:6])) >> 8) & 0xFF
    return bytes(frame)


def _repetitive(n, seed):
    """Text repeated every 40 KB: matches reach across 128 KB frame blocks."""
    return (text_like(40_000, seed=seed) * (n // 40_000 + 1))[:n]


def _frame_blocks(frame):
    info = tframe.parse_frame_header(frame)
    return tframe._frame_blocks(frame, info.header_size)[0]


@pytest.mark.parametrize("level", [10, 21])
def test_linked_frames_equal_reference(level):
    """A linked frame from the JAX encoder decodes to the JAX decoder's bytes
    (one chain, matches across frame blocks); the same blocks read as
    independent ones do not decode, so matches do cross."""
    data = _repetitive(300_000, seed=level)
    frame = jframe.compress_frame(data, level, block_size_id=1,
                                  block_linked=True)
    assert tframe.parse_frame_header(frame).block_linked
    assert len(_frame_blocks(frame)) == 3
    want = jframe.decompress_frame(frame)
    assert want == data
    assert tframe.decompress_frame(frame, device="cpu") == want
    assert lizard_tpu_torch.decompress_frame(frame, device="cpu") == want
    independent = bytearray(frame)
    independent[4] |= 1 << 5
    with pytest.raises(tframe.FrameError, match="block decode failed"):
        tframe.decompress_frame(_resign(independent), device="cpu")
    with pytest.raises(tframe.FrameError, match="blockIndependent"):
        tframe.decompress_frame_lanes(frame, device="cpu")


def test_linked_frame_with_a_stored_block():
    """A stored frame block in the middle of a linked frame: literal-only
    inner blocks of the chain, which later blocks' matches reach across."""
    rng = np.random.default_rng(5)
    text = _repetitive(200_000, seed=5)
    data = text + rng.integers(0, 256, 260_000, dtype=np.uint8).tobytes() \
        + text
    frame = jframe.compress_frame(data, 21, block_size_id=1,
                                  block_linked=True)
    assert [s for s, _ in _frame_blocks(frame)] == [False, False, True,
                                                    False, False, False]
    want = jframe.decompress_frame(frame)
    assert tframe.decompress_frame(frame, device="cpu") == want == data


def test_skippable_frames():
    """A lone skippable frame is b""; decompress_frames reads across a
    skippable frame between two frames; decompress_frame refuses the
    second frame, as in the JAX package."""
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"12345"
    assert tframe.decompress_frame(skip, device="cpu") == b"" \
        == jframe.decompress_frame(skip)
    a, b = gen(150_000, seed=8), _repetitive(200_000, seed=9)
    stream = (tframe.compress_frame_fast(a, 10) + skip
              + jframe.compress_frame(b, 21, block_size_id=1,
                                      block_linked=True))
    want = jframe.decompress_frames(stream)
    assert tframe.decompress_frames(stream, device="cpu") == want == a + b
    with pytest.raises(tframe.FrameError, match="trailing"):
        tframe.decompress_frame(stream, device="cpu")
    with pytest.raises(tframe.FrameError, match="skippable frame truncated"):
        tframe.decompress_frames(stream + skip[:9], device="cpu")


def test_mixed_family_independent_frame():
    """An independent frame whose blocks are at -11 (fastLZ4) and -21
    (LIZv1): per-block families in one batch, as the JAX scalar path."""
    a, b = gen(131_072, seed=12, proba=0.6), text_like(100_000, seed=13)
    frame = bytearray(tframe.compress_frame_fast(a + b, 11,
                                                 content_checksum=False))
    blocks = _frame_blocks(bytes(frame))
    assert len(blocks) == 2 and not any(s for s, _ in blocks)
    second = jrt.compress(b, 21)
    head = frame[:frame.index(blocks[1][1]) - 4]
    mixed = bytes(head) + len(second).to_bytes(4, "little") + second \
        + (0).to_bytes(4, "little")
    want = jframe.decompress_frame(mixed)
    assert want == a + b
    assert tframe.decompress_frame(mixed, device="cpu") == want
    with pytest.raises(tframe.FrameError, match="mixed"):
        tframe.decompress_frame_lanes(mixed, device="cpu")


@pytest.mark.parametrize("level", [10, 21, 41])
def test_linked_frame_of_a_stream(level):
    """frame.linked_frame cuts one native stream at inner-block boundaries
    into 256 KB frame blocks: a linked frame that the JAX decoder and the
    port decode to the input (the card's full-size phase uses it)."""
    data = _repetitive(500_000, seed=level) + gen(200_000, seed=level)
    stream = jrt.compress(data, level)
    frame = tframe.linked_frame(stream, data, 2)
    assert tframe.parse_frame_header(frame).block_linked
    assert len(_frame_blocks(frame)) == 3
    assert jframe.decompress_frame(frame) == data
    assert tframe.decompress_frames(frame, device="cpu") == data
