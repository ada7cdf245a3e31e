"""The port's one-shot frame encoder with the oracle
(lizard_tpu_torch/frame.py::compress_frame, api.compress_frame) against
lizard_tpu/frame.py::compress_frame on the CPU, tolerance 0: the same frame
bytes over block sizes, linked and independent blocks, content checksum and
content size, each frame decoded by the port's decompress_frame
(device="cpu") and by the JAX one; xxh64 equal to the JAX and the native
one; the native frame decoder equal to the port's decompress_frames."""

import numpy as np
import pytest
import torch

import lizard_tpu.api as japi
import lizard_tpu.frame as jframe
from lizard_tpu.utils.datagen import gen, text_like
from lizard_tpu.utils.xxh import xxh64 as j_xxh64
from lizard_tpu_torch import api, runtime
from lizard_tpu_torch import frame as tframe
from lizard_tpu_torch.utils.xxh import xxh64
from tests.torch_cases import one_thread  # noqa: F401

DATA = gen(300_000, seed=21, proba=0.6)


# (level, block_size_id, block_linked, content_checksum, content_size)
OPTIONS = [
    (10, 1, True, True, False),     # linked, chains across 128 KB blocks
    (10, 2, True, False, True),     # linked, 256 KB blocks
    (21, 1, True, True, True),      # linked LIZv1
    (21, 2, False, True, False),
    (12, 1, False, False, True),
    (41, 1, True, True, False),     # linked, Huff0 stage
    (35, 2, False, True, True),
]


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX compress_frame of DATA for every option set, once."""
    return {opt: jframe.compress_frame(DATA, *opt) for opt in OPTIONS}


@pytest.mark.parametrize("opt", OPTIONS, ids=str)
def test_compress_frame_equals_jax(jax_frames, opt):
    level, bsid, linked, checksum, size = opt
    frame = tframe.compress_frame(DATA, *opt)
    assert frame == jax_frames[opt]
    info = tframe.parse_frame_header(frame)
    assert (info.block_size_id, info.block_linked) == (bsid, linked)
    assert info.content_size == (len(DATA) if size else None)
    assert tframe.decompress_frame(frame, device="cpu") == DATA
    assert jframe.decompress_frame(frame) == DATA


@pytest.mark.parametrize("data", [b"", b"q", text_like(5000, 3),
                                  gen(65_536, seed=5)],
                         ids=["empty", "one", "5k", "64k"])
def test_small_frames_equal_jax(data):
    """At most one block: block_linked is turned off (lizard_frame.c:285),
    and the block size shrinks to fit (LizardF_optimalBSID)."""
    for opt in [(17, 0, True, True, True), (10, 7, False, False, False)]:
        frame = tframe.compress_frame(data, *opt)
        assert frame == jframe.compress_frame(data, *opt)
        assert not tframe.parse_frame_header(frame).block_linked
        assert tframe.decompress_frame(frame, device="cpu") == data


def test_api_compress_frame(monkeypatch):
    data = DATA[:70_000]
    kw = dict(block_size_id=1, block_linked=True, content_size=True)
    frame = api.compress_frame(data, 21, backend="ref", **kw)
    assert frame == japi.compress_frame(data, 21, **kw)
    assert api.decompress_frame(frame, device="cpu") == data
    with pytest.raises(ValueError, match="block_linked"):
        api.compress_frame(data, 21, block_linked=True, device="cpu")
    with pytest.raises(NotImplementedError):
        api.compress_frame(data, 21, backend="tpu")
    small = data[:3000]
    gpu = api.compress_frame(small, 12, device="cpu")
    assert gpu == tframe.compress_frame_lanes(small, 12, device="cpu")
    assert tframe.decompress_frame(gpu, device="cpu") == small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.compress_frame(small, 12)


@pytest.mark.parametrize("seed", [0, 1, 2**64 - 1])
def test_xxh64_equals_jax_and_native(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    for n in range(101):
        d = rng.integers(0, 256, n, np.uint8).tobytes()
        assert xxh64(d, seed) == j_xxh64(d, seed) == runtime.xxh64(d, seed)


def test_xxh64_1mb():
    d = np.random.default_rng(5).integers(0, 256, 1 << 20, np.uint8).tobytes()
    assert xxh64(d) == j_xxh64(d) == runtime.xxh64(d)
    assert xxh64(d, 7) == runtime.xxh64(d, 7)


def test_native_decompress_frame_equals_decompress_frames():
    assert runtime.available()
    skippable = (0x184D2A50).to_bytes(4, "little") + (3).to_bytes(4, "little")
    stream = (tframe.compress_frame(DATA[:90_000], 12, 1, True)
              + skippable + b"abc"
              + tframe.compress_frame_fast(DATA[:50_000], 35)
              + tframe.compress_frame(b"", 10))
    want = DATA[:90_000] + DATA[:50_000]
    assert runtime.decompress_frame(stream, 1 << 20) == want
    assert tframe.decompress_frames(stream, device="cpu") == want
