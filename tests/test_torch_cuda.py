"""The CUDA kernel csrc/lz_decode.cu against its plain PyTorch version, on
the card. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor lizard_tpu, so it also runs where JAX is
not installed; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import pytest
import torch

from lizard_tpu_torch import runtime
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.ops import lane_decode as tld
from lizard_tpu_torch.ops.split import split_streams
from lizard_tpu_torch.utils.datagen import gen, text_like

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _kernel_and_plain(streams, card):
    args = tld.stage_batch(split_streams(streams), card)
    before = tld.lz_decode.launches
    k = tld.lz_decode(**args)
    torch.cuda.synchronize()
    assert tld.lz_decode.launches == before + 1
    p = tld.lz_decode_plain(**args)
    return args, k, p


def _chain_bytes(out, block_len, chains):
    return [bytes(t.cpu().numpy())
            for t in tld.chain_outputs(out, block_len, chains)]


@pytest.mark.parametrize("level", [10, 19, 21, 29, 41])
def test_kernel_matches_plain(level, card):
    a = gen(300_000, seed=1, proba=0.5)
    datas = [gen(300_000, seed=level), text_like(131072, seed=1),
             b"\x00" * 5000, b"ab" * 3000, b"q",
             a + gen(100_000, seed=2, proba=0.5) + a + a]
    streams = [runtime.compress(d, level) for d in datas]
    args, k, p = _kernel_and_plain(streams, card)
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    assert (_chain_bytes(k[0], k[1], args["chains"])
            == _chain_bytes(p[0], p[1], args["chains"]) == datas)
    assert tld.decompress_lanes(streams) == datas


def _set_token(stream, frac, value):
    s = bytearray(stream)
    p = 2
    for _ in range(3):                     # len, off16, off24; then flags
        p += 3 + int.from_bytes(s[p:p + 3], "little")
    n = int.from_bytes(s[p:p + 3], "little")
    s[p + 3 + min(int(n * frac), n - 1)] = value
    return bytes(s)


@pytest.mark.parametrize("level", [10, 21])
def test_corrupt_status_matches_plain(level, card):
    """Altered tokens: the kernel stops each chain with the plain version's
    status code, and the lengths of the blocks before it agree."""
    base = runtime.compress(gen(100_000, seed=3, proba=0.6), level)
    streams = [base] + [_set_token(base, f, v)
                        for f in (0.0, 0.3, 0.9, 0.999)
                        for v in (0x00, 0x07, 0x0F, 0x1F, 0x88, 0xF0, 0xFF)]
    _, k, p = _kernel_and_plain(streams, card)
    assert torch.equal(k[2], p[2])
    assert torch.equal(k[1], p[1])
    assert int(k[2][0]) == tld.OK and (k[2] < 0).any()
    oversized = bytes([level, 0x80]) + (200_000).to_bytes(3, "little") \
        + bytes(200_000)
    with pytest.raises(CorruptError, match="LIZARD_BLOCK_SIZE"):
        tld.decompress_lanes([oversized])
