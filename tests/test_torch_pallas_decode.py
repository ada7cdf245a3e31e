"""The port's slot-layout block decode (lizard_tpu_torch.ops.pallas_decode)
against the JAX package's lizard_tpu.ops.pallas_decode, whose Pallas kernels
_lz4_block_kernel and _liz_block_kernel run here in interpret mode: the same
streams, or the same post-split batch carried over with
split.from_reference_batch, give the same bytes (exact). Where the JAX
functions assume well-formed input, the port is held against the input bytes
and the native decoder instead. The port runs its plain PyTorch route here
(device="cpu"); tests/test_torch_cuda.py and chip_smoke.py hold the CUDA
kernel against the same route on the card."""

import numpy as np
import pytest
import torch

from lizard_tpu import runtime as jrt
from lizard_tpu.ops import pallas_decode as jpd
from lizard_tpu.ops import split as jsplit
from lizard_tpu.utils.datagen import gen, text_like
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import LIZARD_BLOCK_SIZE
from lizard_tpu_torch.ops import lane_decode as tld
from lizard_tpu_torch.ops import pallas_decode as tpd
from lizard_tpu_torch.ops.split import (
    STREAMS, TABLE_FIELDS, from_reference_batch, split_streams)
from lizard_tpu_torch.utils import profiling

BLOCK = LIZARD_BLOCK_SIZE
FIELDS = STREAMS + TABLE_FIELDS + ("stream_id",)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain decode is a Python loop of small torch operations; with
    intra-op threads under xdist workers it runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _far_data():
    """700 KB whose last 300 KB repeat its first 300 KB from 400 KB back:
    at levels 20-29 the LIZv1 off24 class reaches past 128 KB."""
    a = gen(300_000, seed=1, proba=0.5)
    return (a + gen(100_000, seed=2, proba=0.5) + a)[:700_000]


def _jax_slots(batch) -> np.ndarray:
    """The JAX decode_batch_pallas output (one byte per i32 lane) as the
    flat uint8 slot layout."""
    out = jpd.decode_batch_pallas(batch, interpret=True)
    return np.asarray(out, dtype=np.int32).astype(np.uint8).reshape(-1)


def _blocks(flat, lens):
    return [bytes(flat[b * BLOCK:b * BLOCK + n]) for b, n in enumerate(lens)]


@pytest.mark.parametrize("level", [10, 19, 21, 29, 35, 49])
def test_decompress_equals_jax(level):
    data = _far_data()
    s = jrt.compress(data, level)
    batch = split_streams([s])
    assert batch.n_blocks == 6
    if level == 29:
        off24 = batch.off24.numpy().reshape(-1, 3).astype(np.int64)
        far = off24[:, 0] | (off24[:, 1] << 8) | (off24[:, 2] << 16)
        assert far.max() > BLOCK               # a match from past 128 KB
    got = tpd.decompress_pallas(s, len(data), device="cpu")
    assert got == data
    assert got == jpd.decompress_pallas(s, len(data), interpret=True)


def _batch_pair(streams):
    """One post-split state for both packages: the JAX host-entropy batch
    and the port's copy of it."""
    ref = jsplit.split_streams(streams, entropy="host")
    port = from_reference_batch({n: np.asarray(getattr(ref, n))
                                 for n in FIELDS}, ref.codewords)
    return ref, port


@pytest.mark.parametrize("level", [21])
def test_three_stream_batch_equals_jax(level):
    datas = [gen(200_000, seed=level, proba=0.6), text_like(50_000, 3),
             gen(300_000, seed=4, proba=0.5)]
    ref, batch = _batch_pair([jrt.compress(d, level) for d in datas])
    assert batch.n_blocks == 6 and batch.stream_id.tolist() == [
        0, 0, 1, 2, 2, 2]
    out, block_len = tpd.decode_batch_pallas(batch, device="cpu")
    assert out.dtype == torch.uint8 and out.numel() == 6 * BLOCK
    assert block_len.dtype == torch.int32
    lens = block_len.tolist()
    got = _blocks(out.numpy(), lens)
    assert got == _blocks(_jax_slots(ref), lens)
    assert [b"".join(got[i] for i in range(6)
                     if batch.stream_id[i] == s) for s in range(3)] == datas


@pytest.mark.parametrize("level", [10])
def test_token_dense_block_equals_jax(level):
    """A block of 8 random symbols (~31 K tokens at -10) after a stream
    whose streams put the dense block's flags at an offset."""
    rng = np.random.default_rng(5)
    dense = rng.integers(0, 8, BLOCK, np.uint8).tobytes()
    datas = [text_like(20_000, 6), dense]
    ref, batch = _batch_pair([jrt.compress(d, level) for d in datas])
    assert int(batch.flags_len[1]) > 30_000
    assert int(batch.flags_off[1]) > 0
    out, block_len = tpd.decode_batch_pallas(batch, device="cpu")
    lens = block_len.tolist()
    assert lens == [20_000, BLOCK]
    got = _blocks(out.numpy(), lens)
    assert got == datas == _blocks(_jax_slots(ref), lens)


@pytest.mark.parametrize("level", [10, 21])
def test_short_non_final_block_keeps_the_slot_layout(level):
    """Two separately compressed streams under one level byte: the first
    inner block is short. The JAX kernels assume full blocks; the port
    decodes the chain and moves each block into its slot."""
    a = gen(50_000, seed=3, proba=0.7)
    b = gen(150_000, seed=4, proba=0.7)
    chain = jrt.compress(a, level) + jrt.compress(b, level)[1:]
    batch = split_streams([chain])
    out, block_len = tpd.decode_batch_pallas(batch, device="cpu")
    assert block_len.tolist() == [50_000, BLOCK, 150_000 - BLOCK]
    flat = out.numpy()
    assert _blocks(flat, block_len.tolist()) == [a, b[:BLOCK], b[BLOCK:]]
    got = tpd.decompress_pallas(chain, len(a) + len(b), device="cpu")
    assert got == a + b == jrt.decompress(chain, len(a) + len(b))


def test_max_out():
    data = gen(200_000, seed=7, proba=0.6)
    s = jrt.compress(data, 12)
    assert tpd.decompress_pallas(s, len(data), device="cpu") == data
    assert tpd.decompress_pallas(s, len(data) + 99, device="cpu") == data
    with pytest.raises(CorruptError, match="max_out"):
        tpd.decompress_pallas(s, len(data) - 1, device="cpu")
    assert tpd.decompress_pallas(bytes([12]), 0, device="cpu") == b""


def _with_first_token(stream: bytes, token: int) -> bytes:
    """`stream` (one raw-coded inner block) with its first flags byte set:
    after the level and header bytes come len, off16, off24, flags and
    literals, each a LE24 length and its bytes."""
    s = bytearray(stream)
    p = 2
    for _ in range(3):
        p += 3 + int.from_bytes(s[p:p + 3], "little")
    s[p + 3] = token
    return bytes(s)


def test_rep_match_without_offset_raises():
    """LIZv1 token 0x88 first: a repeat match of length 1 with no offset
    yet. The JAX kernel skips the copy and returns bytes; the port raises
    (as the native decoder does)."""
    d = gen(6000, seed=8, proba=0.6) + b"abcabcabcabc" * 40
    s = _with_first_token(jrt.compress(d, 21), 0x88)
    assert len(jpd.decompress_pallas(s, len(d), interpret=True)) == len(d)
    with pytest.raises(CorruptError, match="rep match"):
        tpd.decompress_pallas(s, len(d), device="cpu")
    with pytest.raises(Exception):
        jrt.decompress(s, len(d))


def test_corrupt_chain_names_its_stream():
    good = jrt.compress(gen(3000, seed=9), 10)
    bad = _with_first_token(good, 0x00)
    with pytest.raises(CorruptError, match="stream 1: offset"):
        tpd.decode_batch_pallas(split_streams([good, bad]), device="cpu")


def test_one_launch_and_device_rule(monkeypatch):
    data = gen(140_000, seed=10)
    s = jrt.compress(data, 21)
    calls = []
    real = tpd.lz_decode

    def counted(**kw):
        calls.append(kw["chains"].shape[0])
        return real(**kw)
    monkeypatch.setattr(tpd, "lz_decode", counted)
    assert tpd.decompress_pallas(s, len(data), device="cpu") == data
    assert calls == [1]                      # one call, one chain
    before = profiling.counters()["lz_decode.launches"]
    tpd.decode_batch_pallas(split_streams([s]), device="cpu")
    # the CPU runs the plain version
    assert profiling.counters()["lz_decode.launches"] == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpd.decompress_pallas(s, len(data))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpd.decode_batch_pallas(split_streams([s]))
