"""The port's LZ decode (lizard_tpu_torch.ops.lane_decode) against the JAX
package: its Pallas lane kernel (interpret mode, the reduced geometry of
tests/test_lane_decode.py), the bit-exact oracle (lizard_tpu.ref), the
native decoder, and the input bytes. Here the port runs its plain PyTorch
route (device="cpu"); the CUDA kernel is held against the same route on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from lizard_tpu import runtime as jrt
from lizard_tpu.ops.lane_decode import decompress_lanes as jax_decompress_lanes
from lizard_tpu.ref.block_decode import decompress as oracle_decompress
from lizard_tpu.ref.block_encode import compress as ref_compress
from lizard_tpu.utils.datagen import gen, text_like
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.ops import lane_decode as tld
from lizard_tpu_torch.ops.split import split_streams
from lizard_tpu_torch.utils import profiling

# geometry of tests/test_lane_decode.py: 2 KB blocks, 7-tile ring, 8 slots
SPB, RTILES, GROUPS = 4, 7, 1


def _lane_test_datas(family):
    """The streams of tests/test_lane_decode.py for one family: overlaps at
    off=1/2/3/7, incompressible, tiny, several streams per batch and (LIZv1)
    repeat offsets."""
    rng = np.random.default_rng(3)
    datas = [b"\x00" * 2000, b"ab" * 1000, b"abc" * 650,
             bytes(range(7)) * 290,
             rng.integers(0, 256, 1500, dtype=np.uint8).tobytes(),
             b"a", b"hello world!", b"\x00" * 17]
    if family == 0:
        datas.append(gen(1800, seed=1, proba=0.7))
    else:
        rec = bytes(range(48))
        datas += [gen(1800, seed=11, proba=0.7),
                  b"".join(rec[:i % 7 + 40] for i in range(40))[:2000],
                  b"abcabcab" * 250]
    return datas


@pytest.mark.parametrize("level", [10, 21])
def test_against_jax_lane_kernel(level):
    datas = _lane_test_datas(0 if level < 20 else 1)
    streams = [ref_compress(d, level) for d in datas]
    ref = jax_decompress_lanes(streams, interpret=True, spb=SPB,
                               rtiles=RTILES, groups=GROUPS)
    port = tld.decompress_lanes(streams, device="cpu")
    assert port == ref
    assert port == datas


def _block_data(level, k):
    if k == 0:
        return gen(131072, seed=level, proba=0.6)
    return text_like(131072, seed=level)


@pytest.mark.parametrize("level", [10, 12, 19, 21, 29, 35, 41])
def test_production_blocks(level):
    datas = [_block_data(level, k) for k in (0, 1)]
    streams = [jrt.compress(d, level) for d in datas]
    got = tld.decompress_lanes(streams, device="cpu")
    assert got == datas
    assert got == [jrt.decompress(s, len(d)) for s, d in zip(streams, datas)]


@pytest.mark.parametrize("level", [21, 29])
def test_liz_chain_with_off24(level):
    a = gen(300_000, seed=1, proba=0.5)
    d = a + gen(100_000, seed=2, proba=0.5) + a + a
    s = jrt.compress(d, level)
    batch = split_streams([s])
    assert batch.n_blocks == 8
    assert batch.off24.numel() > 0          # far matches: the off24 class
    got = tld.decode_batch_lanes(batch, device="cpu")
    assert b"".join(got) == d == jrt.decompress(s, len(d))


@pytest.mark.parametrize("level", [10, 21])
def test_foreign_chain_short_inner_block(level):
    """Blocks of two separately compressed streams under one level byte:
    the first inner block is short, yet the chain decodes on the kernel's
    route (the TPU decoder sends such chains to the host)."""
    a = gen(50_000, seed=3, proba=0.7)
    b = gen(150_000, seed=4, proba=0.7)
    sa, sb = jrt.compress(a, level), jrt.compress(b, level)
    chain = sa + sb[1:]
    batch = split_streams([chain])
    assert batch.n_blocks == 3
    got = tld.decode_batch_lanes(batch, device="cpu")
    assert [len(g) for g in got] == [50_000, 131072, 150_000 - 131072]
    assert b"".join(got) == a + b == oracle_decompress(chain)


def test_lz_decode_outputs_are_contiguous_per_chain():
    datas = [gen(200_000, seed=5), b"", gen(1000, seed=6)]
    streams = [jrt.compress(d, 10) for d in datas]
    args = tld.stage_batch(split_streams(streams), "cpu")
    out, block_len, status = tld.lz_decode(**args)
    assert status.dtype == block_len.dtype == torch.int32
    assert status.tolist() == [0, 0]      # the empty stream has no block
    assert block_len.tolist() == [131072, 200_000 - 131072, 1000]
    assert out.numel() == 3 * 131072
    assert bytes(out[:200_000].numpy()) == datas[0]
    assert bytes(out[2 * 131072:2 * 131072 + 1000].numpy()) == datas[2]
    assert [bytes(t.numpy()) for t in tld.chain_outputs(
        out, block_len, args["chains"])] == [datas[0], datas[2]]


# 33 fixed corruptions of one fastLZ4 and one LIZv1 stream: (level, kind,
# where, value). "cut" truncates at a fraction of the length; "set" writes
# `value` into block 0's stream `where[0]` at a fraction `where[1]` of it;
# "xor" flips a byte the same way. Most reach the kernel's checks.
_CASES = ([(lv, "cut", w, None) for lv in (10, 21) for w in (0.0, 0.01, 0.5, 0.999)]
          + [(10, "set", ("flags", f), v) for f, v in (
              (0, 0x00), (0, 0xFF), (0, 0x0F), (0.5, 0xFF), (0.5, 0x0F),
              (0.5, 0xF0), (0.999, 0x0F), (0.999, 0xFF))]
          + [(21, "set", ("flags", f), v) for f, v in (
              (0, 0x00), (0, 0x88), (0, 0x1F), (0, 0xFF), (0.5, 0x1F),
              (0.5, 0x00), (0.5, 0x07), (0.999, 0xFF), (0.999, 0x1F))]
          + [(10, "xor", ("literals", f), 0xFF) for f in (0.0, 0.3, 0.9, 0.999)]
          + [(21, "xor", (name, f), 0xFF) for name, f in (
              ("off16", 0.0), ("off16", 0.5), ("off16", 0.999),
              ("literals", 0.999))])


@pytest.fixture(scope="module")
def corrupt_sources():
    d = gen(6000, seed=8, proba=0.6) + b"abcabcabcabc" * 40
    return {lv: ref_compress(d, lv) for lv in (10, 21)}


def _stream_span(s, name):
    """(start, length) of a raw-coded stream of block 0: after the level and
    header bytes come len, off16, off24, flags, literals, each a LE24 length
    and its bytes."""
    p = 2
    for n in ("len", "off16", "off24", "flags", "literals"):
        ln = int.from_bytes(s[p:p + 3], "little")
        if n == name:
            return p + 3, ln
        p += 3 + ln


def _corrupt(src, kind, where, value):
    s = bytearray(src)
    if kind == "cut":
        return bytes(s[:int(len(s) * where)])
    start, ln = _stream_span(s, where[0])
    i = start + min(int(ln * where[1]), ln - 1)
    s[i] = value if kind == "set" else s[i] ^ value
    return bytes(s)


@pytest.mark.parametrize("case", range(len(_CASES)))
def test_corruption(case, corrupt_sources):
    level, kind, where, value = _CASES[case]
    s = _corrupt(corrupt_sources[level], kind, where, value)
    try:
        want = oracle_decompress(s)
    except Exception:
        want = None                        # the oracle rejects the stream
    try:
        got = tld.decompress_lanes([s], device="cpu")[0]
    except CorruptError:
        return
    assert want is not None, "the oracle rejects this stream; the port must"
    assert got == want


def test_device_rule(monkeypatch):
    streams = [jrt.compress(b"abc" * 100, 10)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tld.decompress_lanes(streams)
    assert tld.decompress_lanes(streams, device="cpu") == [b"abc" * 100]


def test_cpu_tensors_take_the_plain_version():
    args = tld.stage_batch(split_streams([jrt.compress(b"xy" * 999, 21)]),
                           "cpu")
    before = profiling.counters()["lz_decode.launches"]
    out, lens, status = tld.lz_decode(**args)
    # no kernel launched
    assert profiling.counters()["lz_decode.launches"] == before
    plain = tld.lz_decode_plain(**args)
    assert torch.equal(lens, plain[1]) and torch.equal(status, plain[2])
    assert torch.equal(out[:1998], plain[0][:1998])
    with pytest.raises(ValueError):
        tld.lz_decode(**{**args, "blocks": args["blocks"].int()})


@pytest.mark.parametrize("counts, error", [
    ((tld.MAX_CHAIN_BLOCKS, 1), "runs on cuda"),
    ((1, tld.MAX_CHAIN_BLOCKS), "runs on cuda"),
    ((tld.MAX_CHAIN_BLOCKS + 1,), "inner blocks"),
    ((2, tld.MAX_CHAIN_BLOCKS + 3), "inner blocks"),
])
def test_card_chain_length_limit(counts, error):
    """The card keeps chain positions in 32 bits: lz_decode_meta refuses a
    chain of more than MAX_CHAIN_BLOCKS inner blocks before any launch
    (these CPU tensors then reach the device check instead)."""
    first = torch.tensor((0,) + counts[:-1]).cumsum(0)
    chains = torch.stack([first, torch.tensor(counts),
                          first * tld.LIZARD_BLOCK_SIZE], dim=1)
    n_blocks = sum(counts)
    empty = torch.zeros(0, dtype=torch.uint8)
    with pytest.raises(ValueError, match=error):
        tld.lz_decode_meta(empty, empty, empty, empty,
                           torch.zeros((n_blocks, 8), dtype=torch.int64),
                           chains, 0)
