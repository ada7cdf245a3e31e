"""The port's frame decode and one-shot API (lizard_tpu_torch.frame, .api)
against lizard_tpu.frame: the same frames decode to the same bytes, the
port's fast frame encoder writes the same bytes, and malformed frames raise
FrameError. The port runs on the CPU here (device="cpu")."""

import numpy as np
import pytest
import torch

import lizard_tpu.frame as jframe
import lizard_tpu_torch
import lizard_tpu_torch.frame as tframe
from lizard_tpu.utils.datagen import gen, text_like
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.ops.enc_lanes import encode_streams_lanes
from lizard_tpu_torch.runtime import xxh32


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
    with pytest.raises(NotImplementedError):
        lizard_tpu_torch.compress(data, 10, backend="ref")
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
