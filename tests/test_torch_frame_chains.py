"""Frames whose blocks are chains of inner blocks, as `lizard -46` writes
them: a blockIndependent frame block over 128 KiB is one compressed stream
of several inner blocks whose matches reach into the earlier ones, so
lz_decode decodes it as one chain and pass 2 resolves those matches. On
the CPU (the plain versions): the frame decodes to its input and each
block to the port's oracle's bytes, and lz_decode counts the chains and
their non-first blocks. What pass 2 did (deferred bytes, jump rounds) is
read from the card's meta only, and only while spans record: the gate
and the readback that carries it are checked here on CPU tensors, the
counts themselves in tests/test_torch_cuda.py. Imports no JAX."""

import pytest
import torch

from h100_bench import frames, native
from lizard_tpu_torch import api
from lizard_tpu_torch import frame as tframe
from lizard_tpu_torch.format.constants import (LIZARD_BLOCK_SIZE,
                                                LIZARDF_BLOCK_SIZES)
from lizard_tpu_torch.ops import lane_decode as tld
from lizard_tpu_torch.ops.split import split_streams
from lizard_tpu_torch.ref import block_decode
from lizard_tpu_torch.utils import profiling
from lizard_tpu_torch.utils.datagen import gen, text_like
from tests.torch_cases import one_thread  # noqa: F401

LEVEL = 46


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


def _data(size: int, seed: int) -> bytes:
    half = size // 2
    return text_like(half, seed) + gen(size - half, seed=seed + 1,
                                       proba=0.6)


def _payloads(frame: bytes) -> list[tuple[bool, bytes]]:
    info = tframe.parse_frame_header(frame)
    return tframe._frame_blocks(frame, info.header_size)[0]


@pytest.mark.parametrize("size_id,size,chains,pass2", [
    (3, (1 << 20) + 200_000, 2, 7 + 1),     # 1 MiB blocks: 8 and 2 inner
    (1, 300_000, 3, 0),                     # 128 KiB blocks: one each
])
def test_frame_blocks_decode_as_chains(size_id, size, chains, pass2):
    """decompress_frame(device="cpu") gives the input; each frame block's
    payload decodes with the oracle to its part of it; lz_decode counts a
    chain a compressed frame block and a pass-2 block for each of its
    inner blocks after the first."""
    data = _data(size, seed=size_id)
    frame = frames.write_frame(data, LEVEL, size_id)
    blocks = _payloads(frame)
    assert [stored for stored, _ in blocks] == [False] * chains
    block = LIZARDF_BLOCK_SIZES[size_id]
    for k, (_, payload) in enumerate(blocks):
        assert block_decode.decompress(payload) == \
            data[k * block:(k + 1) * block]
    with profiling.recording():
        assert api.decompress_frame(frame, device="cpu") == data
    n = profiling.counters()
    assert n["lz_decode.chains"] == chains
    assert n["lz_decode.pass2_blocks"] == pass2
    inner = sum(-(-min(block, size - k * block) // LIZARD_BLOCK_SIZE)
                for k in range(chains))
    assert inner - chains == pass2
    # the plain version keeps no meta: no tally, even while recording
    assert n["lz_decode.deferred_bytes"] == n["lz_decode.jump_rounds"] == 0


def test_pass2_tally_only_while_recording():
    """pass2_tally adds nothing (None, no operation) unless spans record
    and a chain has a second block; then it sums meta's deferred-bytes
    and rounds columns."""
    meta = torch.arange(20, dtype=torch.int32).reshape(4, 5)
    assert tld.pass2_tally(meta, 2) is None
    with profiling.recording():
        assert tld.pass2_tally(meta, 4) is None
        tally = tld.pass2_tally(meta, 2)
    assert tally.dtype == torch.int64
    assert tally.tolist() == [3 + 8 + 13 + 18, 4 + 9 + 14 + 19]


def test_tally_rides_the_status_copy():
    """read_blocks with a tally copies it back with the chain statuses, 16
    bytes more, and counts it; without one the readback is the plain one,
    with no pass-2 counter."""
    streams = [native.compress(_data(300_000, seed=5), LEVEL)]
    batch = split_streams(streams)
    args = tld.stage_batch(batch, "cpu")
    out, block_len, status, tally = tld.lz_decode(**args, tally=True)
    assert tally is None
    plain = tld.read_blocks(batch, args, out, block_len, status)
    d2h = profiling.counters()["d2h_bytes"]
    profiling.reset()
    tally = torch.tensor([1 << 33, 5], dtype=torch.int64)
    assert tld.read_blocks(batch, args, out, block_len, status,
                           tally) == plain
    n = profiling.counters()
    assert n["d2h_bytes"] == d2h + 16
    assert n["lz_decode.deferred_bytes"] == 1 << 33
    assert n["lz_decode.jump_rounds"] == 5
    assert b"".join(plain) == block_decode.decompress(streams[0])
