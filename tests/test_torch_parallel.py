"""The port's sharded paths (lizard_tpu_torch/parallel/pipeline.py and
multihost.py) on lists of CPU devices, against the JAX package's on the
conftest's 8-device CPU mesh: decoded bytes and global offsets exactly
equal (tolerance 0); the sharded encoder byte-equal to the port's
one-device encoder; decode_streams_global across two processes of a gloo
group; the entry points of lizard_tpu_torch/entry.py."""

import dataclasses
import json
import multiprocessing
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lizard_tpu.parallel import multihost as JM
from lizard_tpu.parallel import pipeline as JP
from lizard_tpu_torch import entry, runtime
from lizard_tpu_torch.format.constants import (
    FLAG_FLAGS, FLAG_LITERALS, LIZARD_BLOCK_SIZE)
from lizard_tpu_torch.frame import (
    FrameError, compress_frame_fast, decompress_frame)
from lizard_tpu_torch.ops import enc_lanes as te
from lizard_tpu_torch.ops.decode import decode_batch
from lizard_tpu_torch.ops.encode_tpu import encode_blocks_tpu
from lizard_tpu_torch.ops.split import split_streams
from lizard_tpu_torch.parallel import multihost as PM
from lizard_tpu_torch.parallel import pipeline as PP
from lizard_tpu_torch.utils.datagen import gen, text_like
from tests.test_enc_lanes import CFG
from tests.test_torch_enc_maps import port_cfg
from tests.torch_cases import global_decode_datas, global_decode_worker
from tests.torch_cases import one_thread  # noqa: F401

GLOO_TIMEOUT_S = 60


def _mesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("dp",))


def _streams(level, n=5):
    datas = [gen(6_000 + 700 * i, seed=i, proba=0.6) for i in range(n)]
    return datas, [runtime.compress(d, level) for d in datas]


def _block_lens(datas, n_shards):
    """[shard, slot] decoded lengths of every inner block, padded with 0."""
    rows = [[] for _ in range(n_shards)]
    for s, d in zip(JP._group(len(datas), n_shards), datas):
        rows[s] += [len(d[i:i + LIZARD_BLOCK_SIZE])
                    for i in range(0, len(d), LIZARD_BLOCK_SIZE)]
    out = np.zeros((n_shards, max(map(len, rows))), np.int64)
    for s, r in enumerate(rows):
        out[s, :len(r)] = r
    return out


def _jax_sharded(streams, k, level):
    """The JAX decode_streams_sharded's results on a k-device mesh. At the
    LIZv1 levels that function raises TypeError under this JAX (shard_map's
    varying-axes check on token_parse_liz's scan carry), so the results of
    decode_streams_global, the same decode step without that check, stand
    in."""
    if level < 20:
        return JP.decode_streams_sharded(streams, 131072, _mesh(k))
    return JM.decode_streams_global(streams, 131072, _mesh(k))[0]


@pytest.mark.parametrize("k,level", [(1, 21), (3, 12), (8, 21)])
def test_decode_streams_sharded_equals_jax(k, level):
    """k CPU shards against the JAX decode on a k-device mesh; at k = 8
    there are fewer streams than shards."""
    datas, streams = _streams(level)
    want = _jax_sharded(streams, k, level)
    got = PP.decode_streams_sharded(streams, 131072, ["cpu"] * k)
    assert got == want == datas


@pytest.mark.parametrize("k,level", [(1, 12), (3, 21), (8, 12)])
def test_decode_streams_global_equals_jax(k, level):
    """Results and the [shard, slot] offsets equal the JAX function's on a
    k-device mesh, and the host's exclusive cumsum of the block lengths."""
    datas, streams = _streams(level)
    streams.append(runtime.compress(gen(140_000, seed=9, proba=0.6), level))
    datas.append(gen(140_000, seed=9, proba=0.6))        # two inner blocks
    want, want_offs = JM.decode_streams_global(streams, 262144, _mesh(k))
    got, offs = PM.decode_streams_global(streams, 262144, ["cpu"] * k)
    assert got == want == datas
    assert np.array_equal(offs.numpy(), np.asarray(want_offs))
    lens = _block_lens(datas, k).reshape(-1)
    assert np.array_equal(offs.numpy().reshape(-1), np.cumsum(lens) - lens)
    empty, empty_offs = PM.decode_streams_global([], 131072, ["cpu"] * k)
    assert empty == [] and tuple(empty_offs.shape) == (k, 0)


def test_decode_frame_sharded_equals_jax():
    """A frame with a stored block (random bytes) among compressed ones;
    a bad checksum and a linked frame raise FrameError, as in JAX."""
    rng = np.random.default_rng(4)
    data = (gen(200_000, seed=5, proba=0.6)
            + rng.integers(0, 256, 131072, np.uint8).tobytes()
            + gen(50_000, seed=6, proba=0.6))
    frame = compress_frame_fast(data, 12, block_size_id=1)
    assert JP.decode_frame_sharded(frame, _mesh(8)) == data
    assert PP.decode_frame_sharded(frame, ["cpu"] * 3) == data
    bad = frame[:-1] + bytes([frame[-1] ^ 1])
    with pytest.raises(FrameError, match="content checksum mismatch"):
        PP.decode_frame_sharded(bad, ["cpu"] * 3)
    linked = frame[:4] + bytes([frame[4] & ~(1 << 5)]) + frame[5:]
    with pytest.raises(FrameError, match="header checksum|independent"):
        PP.decode_frame_sharded(linked, ["cpu"] * 2)


@pytest.mark.parametrize("level", [12, 21])
def _c2_cases():
    """(name, a malformed variant of a 300,000-byte -12 frame with a content
    size) for the checks after a frame's endmark."""
    frame = compress_frame_fast(gen(300_000, seed=8, proba=0.6), 12,
                                content_size=True)
    size = bytearray(frame)
    size[6:14] = (300_001).to_bytes(8, "little")
    size[14] = (runtime.xxh32(bytes(size[4:14])) >> 8) & 0xFF
    return frame, {"content_size": bytes(size),
                   "junk": frame + b"\x01\x02\x03\x04",
                   "second_frame": frame + frame, "cut_checksum": frame[:-1]}


C2_FRAME, C2_CASES = _c2_cases()


@pytest.mark.parametrize("case", sorted(C2_CASES))
def test_decode_frame_sharded_refuses_like_decompress_frame(case):
    """C2: a wrong content size, bytes after the frame, a second frame and a
    cut checksum raise FrameError with decompress_frame's message; the
    good frame still decodes."""
    bad = C2_CASES[case]
    with pytest.raises(FrameError) as want:
        decompress_frame(bad, device="cpu")
    with pytest.raises(FrameError) as got:
        PP.decode_frame_sharded(bad, ["cpu"] * 3)
    assert str(got.value) == str(want.value)
    assert PP.decode_frame_sharded(C2_FRAME, ["cpu"] * 3) == (
        decompress_frame(C2_FRAME, device="cpu"))


@pytest.mark.parametrize("level", [12, 21])
def test_decode_streams_sharded_lanes_equals_jax(level):
    """The port's lane decoder over 3 CPU shards against the JAX Pallas
    lane kernel under shard_map in interpret mode, at the dry run's
    shrunken geometry (blocks of at most 2 KB)."""
    datas = [gen(1400 + 23 * i, seed=20 + i, proba=0.6) for i in range(7)]
    streams = [runtime.compress(d, level) for d in datas]
    want = JP.decode_streams_sharded_lanes(
        streams, _mesh(3), interpret=True, spb=4, rtiles=7, groups=1, il=1)
    got = PP.decode_streams_sharded_lanes(streams, ["cpu"] * 3)
    assert got == want == datas


def test_sharded_lanes_mixed_families_and_depths():
    """Shards of different codeword families, and shards of unequal chain
    depth, decode: each shard is its own launch. The JAX function refuses
    both for its one TPU kernel instance."""
    fam = [gen(3000 + i, seed=30 + i, proba=0.6) for i in range(6)]
    streams = [runtime.compress(d, lv) for d, lv in
               zip(fam, (12, 12, 21, 21, 41, 41))]
    assert PP.decode_streams_sharded_lanes(streams, ["cpu"] * 3) == fam
    with pytest.raises(ValueError, match="mixed codeword families"):
        JP.decode_streams_sharded_lanes(streams[:4], _mesh(2),
                                        interpret=True)
    deep = [gen(3000, seed=40), gen(140_000, seed=41, proba=0.6)]
    got = PP.decode_streams_sharded_lanes(
        [runtime.compress(d, 12) for d in deep], ["cpu"] * 2)
    assert got == deep


def test_run_sharded_one_thread_a_device():
    """Distinct devices run at once, one thread each (the first shard of
    each device meets the other's at a barrier), the shards of one device
    one after another in its thread, and the results come back in shard
    order. torch.device("cpu") and ("cpu", 0) are two devices here."""
    barrier = threading.Barrier(2, timeout=30)

    def fn(shard, device):
        if shard < 2:
            barrier.wait()
        return shard, device, threading.get_ident()

    devices = [torch.device("cpu"), torch.device("cpu", 0),
               torch.device("cpu")]
    out = PP.run_sharded(devices, fn, [0, 1, 2])
    assert [r[:2] for r in out] == list(zip([0, 1, 2], devices))
    assert out[0][2] == out[2][2] != out[1][2]


ENCODE_CASES = {
    17: dataclasses.replace(CFG, n=4096, maxoff=2047, lazy=1, chain=2),
    44: dataclasses.replace(CFG, n=16384, maxoff=2047, lazy=2, k5=2, far=1,
                            far_dist=1024),
}


@pytest.mark.parametrize("level", sorted(ENCODE_CASES))
def test_encode_blocks_sharded_equals_lanes(level):
    """Byte-equal to the port's one-device encode_blocks_lanes, with the
    small configs of tests/test_enc_lanes.py (a chain tier; LIZv1 with the
    far table and the Huff0 stage at 16 KB, so that streams pass its
    1024-byte gate), over four shards on two CPU devices (two threads)."""
    cfg = port_cfg(ENCODE_CASES[level])
    blocks = [gen(cfg.n - 3 * i, seed=70 + i, proba=0.6) for i in range(5)]
    blocks += [text_like(cfg.n - 5 * i, 80 + i) for i in range(3)]
    blocks += [b"", b"abc"]
    want = te.encode_blocks_lanes(blocks, level=level, cfg=cfg,
                                  device="cpu")
    got = PP.encode_blocks_sharded(blocks, level=level, cfg=cfg,
                                   devices=["cpu", "cpu:0"] * 2)
    assert got == want
    if level == 44:
        assert any(e[1] & (FLAG_FLAGS | FLAG_LITERALS) for e in got)
    for d, e in zip(blocks, got):
        assert runtime.decompress(e, max(len(d), 1)) == d


def test_global_two_processes_gloo(tmp_path):
    """decode_streams_global across a gloo group of two processes, two CPU
    shards each: each rank decodes its own shards' streams, and both hold
    the same offsets, equal to the host's cumsum of the block lengths."""
    ctx = multiprocessing.get_context("spawn")
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [ctx.Process(target=global_decode_worker,
                         args=(r, 2, str(store), str(outs[r]), 2))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(GLOO_TIMEOUT_S)
        assert not any(p.is_alive() for p in procs), "a rank timed out"
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    res = [json.loads(o.read_text()) for o in outs]
    datas = global_decode_datas()
    assert res[0]["offs"] == res[1]["offs"]
    lens = _block_lens(datas, 4).reshape(-1)
    assert np.array_equal(np.array(res[0]["offs"]).reshape(-1),
                          np.cumsum(lens) - lens)
    assert sorted(res[0]["own"] + res[1]["own"]) == list(range(len(datas)))
    assert all(res[0]["equal"]) and all(res[1]["equal"])
    assert res[0]["own"] == [i for i, s in enumerate(
        JP._group(len(datas), 4)) if s < 2]


def test_init_process_single_is_noop():
    assert PM.init_process() is False
    assert PM.init_process(num_processes=1) is False


def test_entry_batch_equals_graft_entry():
    """entry()'s example batch is __graft_entry__'s, byte for byte: both
    are the oracle's streams."""
    import __graft_entry__
    _, args = entry.entry("cpu")
    _, jargs = __graft_entry__.entry()
    assert len(args) == len(jargs)
    for a, j in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(j))


def test_entry_and_dryrun():
    """entry()'s decode step gives its batch's bytes; dryrun_multichip runs
    every sharded path over four CPU shards and raises on any mismatch."""
    fn, args = entry.entry("cpu")
    out, blk_len = fn(*args)
    assert bytes(out.numpy()) == b"".join(
        gen(3000, seed=s) for s in range(2))
    assert blk_len.tolist() == [3000, 3000]
    entry.dryrun_multichip(4, ["cpu"] * 4)
    with pytest.raises(ValueError, match="need 4 devices"):
        entry.dryrun_multichip(4, ["cpu"] * 3)


def test_no_cuda_device_raises():
    """With no CUDA device, devices=None (and device=None) raises in every
    new entry point; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, streams = _streams(12, 2)
    batch = split_streams(streams)
    frame = compress_frame_fast(b"x" * 1000, 12)
    calls = [
        lambda: PP.decode_streams_sharded(streams, 131072),
        lambda: PP.decode_streams_sharded_lanes(streams),
        lambda: PP.decode_frame_sharded(frame),
        lambda: PP.encode_blocks_sharded([b"abc"], 11),
        lambda: PM.decode_streams_global(streams, 131072),
        lambda: PM.global_devices(),
        lambda: decode_batch(batch, 20_000),
        lambda: encode_blocks_tpu([b"abc"]),
        lambda: entry.entry(),
        lambda: entry.dryrun_multichip(1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
