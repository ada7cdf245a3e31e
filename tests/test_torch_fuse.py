"""The port's fused Huffman -> LZ decode (lizard_tpu_torch.ops.fuse, the
one route of decompress_lanes and decompress_frame_lanes) against the JAX
package: its host-entropy split
(lizard_tpu.ops.split.split_streams(entropy="host")), the native decoder,
lizard_tpu.frame.decompress_frame, and the input bytes. The port runs its
plain PyTorch versions here (device="cpu"). Every stream is >= 20 KB and
every test asserts that the Huff0 plan is not empty: shorter streams carry
no Huffman blob at all."""

import numpy as np
import pytest
import torch

import lizard_tpu.frame as jframe
from lizard_tpu import runtime as jrt
from lizard_tpu.ops import split as jsplit
from lizard_tpu.ref.huf_encode import huf_compress
from lizard_tpu.utils.datagen import gen, text_like
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import (
    FLAG_OFFSET16, FLAG_OFFSET24, FLAG_UNCOMPRESSED)
from lizard_tpu_torch.frame import decompress_frame_lanes
from lizard_tpu_torch.ops import huf128 as th
from lizard_tpu_torch.ops import lane_decode as tld
from lizard_tpu_torch.ops import split as tsplit
from lizard_tpu_torch.ops.fuse import build_fused_plan, decompress_lanes_fused
from tests.torch_cases import one_thread  # noqa: F401

FIELDS = tsplit.STREAMS + tsplit.TABLE_FIELDS + ("stream_id",)


def _datas(level):
    return [gen(131072, seed=level, proba=0.6), text_like(131072, seed=level),
            gen(40_000, seed=level + 1, proba=0.3)]


def _kinds(plan):
    return {tsplit.STREAMS[k] for k in plan.segs[:, 2].tolist()}


@pytest.mark.parametrize("level", [31, 35, 41, 45, 49])
def test_decompress_lanes_default_entropy(level):
    datas = _datas(level)
    streams = [jrt.compress(d, level) for d in datas]
    assert build_fused_plan(streams)[1].segs.shape[0] >= 8
    got = tld.decompress_lanes(streams, device="cpu")
    assert got == datas
    assert got == [jrt.decompress(s, len(d)) for s, d in zip(streams, datas)]


@pytest.mark.parametrize("level", [35, 41])
def test_filled_batch_equals_reference(level):
    """The holes of the fused plan filled by the Huff0 decode equal the JAX
    host-entropy batch carried over with from_reference_batch, array by
    array."""
    streams = [jrt.compress(d, level) for d in _datas(level)]
    ref = jsplit.split_streams(streams, entropy="host")
    want = tsplit.from_reference_batch(
        {n: np.asarray(getattr(ref, n)) for n in FIELDS}, ref.codewords)
    batch, plan = build_fused_plan(streams)
    assert _kinds(plan) == {"flags", "literals"}
    holed = {k: getattr(batch, k).clone() for k in tsplit.STREAMS}
    status = th.huf_decode(**plan.stage("cpu"),
                           **{k: getattr(batch, k) for k in tsplit.STREAMS})
    assert (status == 0).all()
    for name in FIELDS:
        assert torch.equal(getattr(batch, name), getattr(want, name)), name
    assert any(not torch.equal(holed[k], getattr(batch, k))
               for k in tsplit.STREAMS)


def _huffmanize_offsets(stream: bytes) -> bytes:
    """`stream` with every raw off16 and off24 stream of its blocks Huff0
    coded where huf_compress takes it (the encoder codes only flags and
    literals). Block: header byte, then len, off16, off24, flags, literals,
    each LE24 length + bytes, or LE24 orig + LE24 size + blob if flagged."""
    out = bytearray(stream[:1])
    ip = 1
    while ip < len(stream):
        header = stream[ip]
        ip += 1
        if header == FLAG_UNCOMPRESSED:
            n = int.from_bytes(stream[ip:ip + 3], "little")
            out += stream[ip - 1:ip + 3 + n]
            ip += 3 + n
            continue
        body = bytearray()
        for name, bit in (("len", 0), ("off16", FLAG_OFFSET16),
                          ("off24", FLAG_OFFSET24), ("flags", 2),
                          ("literals", 1)):
            n = int.from_bytes(stream[ip:ip + 3], "little")
            if header & bit:
                size = int.from_bytes(stream[ip + 3:ip + 6], "little")
                body += stream[ip:ip + 6 + size]
                ip += 6 + size
                continue
            raw = stream[ip + 3:ip + 3 + n]
            ip += 3 + n
            blob = huf_compress(raw) if name in ("off16", "off24") else None
            if blob is not None and 1 < len(blob) < n:
                header |= bit
                body += n.to_bytes(3, "little") + len(blob).to_bytes(
                    3, "little") + blob
            else:
                body += n.to_bytes(3, "little") + raw
        out.append(header)
        out += body
    return bytes(out)


def test_offset_stream_blobs_fill_their_holes():
    """Huff0-coded off16 and off24 streams (made by hand: the encoder codes
    only flags and literals) decode into their holes; the JAX fused path
    refuses them."""
    t = text_like(300_000, seed=1)                 # off16 and flags coded
    a = gen(300_000, seed=1, proba=0.5)            # far matches: off24
    datas = [t + gen(100_000, seed=2) + t,
             a + gen(100_000, seed=2, proba=0.5) + a + a]
    streams = [_huffmanize_offsets(jrt.compress(d, 41)) for d in datas]
    batch, plan = build_fused_plan(streams)
    assert _kinds(plan) == {"flags", "literals", "off16", "off24"}
    assert decompress_lanes_fused(streams, device="cpu") == datas
    assert [jrt.decompress(s, len(d)) for s, d in zip(streams, datas)] \
        == datas
    ref = jsplit.split_streams(streams, entropy="host")
    status = th.huf_decode(**plan.stage("cpu"),
                           **{k: getattr(batch, k) for k in tsplit.STREAMS})
    assert (status == 0).all()
    for name in tsplit.STREAMS:
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      getattr(ref, name))


def test_stream_mixing_huffman_raw_and_stored_blocks():
    a = text_like(100_000, seed=5)                  # Huffman-coded (41)
    b = gen(60_000, seed=6, proba=0.7)              # raw streams (21)
    c = np.random.default_rng(7).integers(0, 256, 30_000,
                                          dtype=np.uint8).tobytes()
    d = gen(50_000, seed=8, proba=0.6)              # Huffman again
    chain = (jrt.compress(a, 41) + jrt.compress(b, 21)[1:]
             + jrt.compress(c, 41)[1:] + jrt.compress(d, 45)[1:])
    batch, plan = build_fused_plan([chain])
    assert batch.n_blocks == 4
    assert batch.flags_len[2] == 0 and batch.lit_len[2] == len(c)  # stored
    blocks = {int(n.split("block ")[1].split()[0]) for n in plan.names}
    assert blocks == {0, 3}                         # a's and d's blobs
    want = a + b + c + d
    assert decompress_lanes_fused([chain], device="cpu") == [want]
    assert jrt.decompress(chain, len(want)) == want


@pytest.mark.parametrize("level,bsid,n", [(41, 4, 1_300_000),
                                          (35, 1, 600_000)])
def test_frames(level, bsid, n):
    data = gen(n // 2, seed=level, proba=0.6) + text_like(n - n // 2,
                                                          seed=level)
    frame = jframe.compress_frame_fast(data, level, block_size_id=bsid)
    assert frame[5] >> 4 == bsid
    got = decompress_frame_lanes(frame, device="cpu")
    assert got == data == jframe.decompress_frame(frame)


def test_corrupt_blob_names_stream_and_block():
    datas = _datas(41)
    streams = [jrt.compress(d, 41) for d in datas]
    batch, plan = build_fused_plan(streams)
    # stream 1's first Huffman blob: flip its last byte's end mark away
    # (raw position found by searching the blob's bytes in the stream)
    s = bytearray(streams[1])
    seg0 = plan.segs[4 * plan.names.index(
        next(n for n in plan.names if n.startswith("stream 1,")))]
    blob_tail = plan.data[seg0[0]:seg0[0] + seg0[1]].numpy().tobytes()
    at = bytes(s).index(blob_tail) + len(blob_tail) - 1
    s[at] = 0
    with pytest.raises(CorruptError, match="stream 1, block 1"):
        tld.decompress_lanes(streams[:1] + [bytes(s)] + streams[2:],
                             device="cpu")


def test_gpu_entropy_needs_a_device(monkeypatch):
    streams = [jrt.compress(d, 41) for d in _datas(41)[:1]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tld.decompress_lanes(streams)
    with pytest.raises(RuntimeError, match="CUDA"):
        th.huf_decompress_128([(huf_compress(text_like(3000, 1)), 3000)])
    with pytest.raises(ValueError, match="entropy"):
        tld.decompress_lanes(streams, device="cpu", entropy="tpu")
