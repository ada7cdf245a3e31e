"""The port's batch Huff0 decode (lizard_tpu_torch.ops.lane_huf) against the
JAX package: its lizard_tpu.ops.lane_huf.huf_decompress_lanes (the Pallas
kernel _huf_lane_kernel in interpret mode) on the cases of
tests/test_lane_huf.py, and the bit-exact oracle lizard_tpu.ref.huf and the
native ltpu_huf_decompress where the JAX function fails by its layout or a
fault (tableLog 12, more bitstreams than its slots take, corrupt blobs). The
port runs its plain PyTorch route here (device="cpu"); tests/test_torch_cuda.py
and chip_smoke.py hold the CUDA kernel against the same route on the card."""

import numpy as np
import pytest
import torch

from lizard_tpu import runtime as jrt
from lizard_tpu.ops import lane_huf as jlh
from lizard_tpu.ref import huf as jhuf
from lizard_tpu.ref import huf_encode as jenc
from lizard_tpu_torch.errors import HufError
from lizard_tpu_torch.ops import huf128 as th
from lizard_tpu_torch.ops import lane_huf as tlh
from tests.torch_cases import one_thread  # noqa: F401


def _texty(n, seed):
    """tests/test_lane_huf.py's skewed text."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"etaoin shrdlu\n.,", np.uint8),
                      size=n).tobytes()


def _blobs(datas):
    blobs = [(jenc.huf_compress(d), len(d)) for d in datas]
    assert all(b is not None and 1 < len(b) < n for b, n in blobs)
    return blobs


# the cases of tests/test_lane_huf.py: (datas, groups, il); an RLE blob
# joins "rle_and_degenerate"
LANE_CASES = {
    "single_blob": ([_texty(3000, 1)], 1, 1),
    "multiple_blobs_sizes": ([_texty(500 + 711 * i, 10 + i)
                              for i in range(7)], 1, 1),
    "rle_and_degenerate": ([_texty(2000, 3)], 1, 1),
    "interleaved": ([_texty(1000 + 333 * i, 20 + i) for i in range(6)], 2, 2),
}


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_equals_jax_lane_kernel(name):
    datas, groups, il = LANE_CASES[name]
    blobs = _blobs(datas)
    if name == "rle_and_degenerate":
        blobs.append((b"\x41", 100))
        datas = datas + [b"A" * 100]
    got = tlh.huf_decompress_lanes(blobs, device="cpu")
    assert got == datas
    assert got == jlh.huf_decompress_lanes(blobs, groups=groups, il=il,
                                           interpret=True)


def _fib_blob(table_log: int, scale: int = 8):
    """A blob of tableLog `table_log` made with the reference encoder's
    pieces: symbols 0..table_log with Fibonacci counts (times `scale`) give
    a code tree of that depth, and the most frequent symbol is the last, so
    its weight is the implied one."""
    fib = [1, 1]
    while len(fib) < table_log + 1:
        fib.append(fib[-1] + fib[-2])
    data = bytes(np.random.default_rng(table_log).permutation(np.repeat(
        np.arange(table_log + 1, dtype=np.uint8), np.array(fib) * scale)))
    count, max_sym, _ = jenc._fse_count(data, 255)
    nb, val, log = jenc.huf_build_ctable(count, max_sym, table_log)
    assert log == table_log
    seg = (len(data) + 3) // 4
    parts = [jenc._huf_encode_1x(data[i * seg:(i + 1) * seg], val, nb)
             for i in range(4)]
    blob = (jenc.huf_write_ctable(nb, max_sym, log)
            + b"".join(len(p).to_bytes(2, "little") for p in parts[:3])
            + b"".join(parts))
    return blob, data


@pytest.mark.parametrize("table_log", range(2, 13))
def test_table_logs_equal_oracle_and_native(table_log):
    """Every tableLog 2-12 decodes as ref/huf.py and native do; at 12 the
    JAX function differs (its table expansion shifts by -1 and every lookup
    reads entry 0: a fault on the reference side)."""
    blob, data = _fib_blob(table_log)
    assert jhuf.huf_read_stats(blob)[1] == table_log
    got = tlh.huf_decompress_lanes([(blob, len(data))], device="cpu")
    assert got == [data] == [jhuf.huf_decompress(blob, len(data))]
    assert jrt.huf_decompress(blob, len(data)) == data
    if table_log == 12:
        jax = jlh.huf_decompress_lanes([(blob, len(data))], groups=1,
                                       interpret=True)
        assert jax != [data]


def test_blob_not_shorter_than_its_output_raises():
    blob = _blobs([_texty(3000, 4)])[0][0]
    for dst in (len(blob), len(blob) - 1):
        with pytest.raises(jhuf.HufError):
            jlh.prepare_huf_batch([(blob, dst)], groups=1)
        with pytest.raises(HufError, match="blob 0: not a compressed"):
            tlh.huf_decompress_lanes([(blob, dst)], device="cpu")
    with pytest.raises(HufError, match="blob 1"):
        tlh.huf_decompress_lanes([(blob, 3000), (b"\x41", 1)], device="cpu")


def test_more_bitstreams_than_jax_slots_take():
    """61 blobs are 244 bitstreams, more than 8 slots x MAX_TASKS (30) at
    groups=1: the JAX function raises; the port has no such cap."""
    datas = [_texty(300 + 9 * i, 40 + i) for i in range(61)]
    blobs = _blobs(datas)
    assert 4 * len(blobs) > 8 * jlh.MAX_TASKS
    with pytest.raises(jhuf.HufError, match="too many"):
        jlh.huf_decompress_lanes(blobs, groups=1, interpret=True)
    got = tlh.huf_decompress_lanes(blobs, device="cpu")
    assert got == datas == [jrt.huf_decompress(b, n) for b, n in blobs]


def _jump(blob):
    h = jhuf.huf_read_stats(blob)[2]
    return h, [int.from_bytes(blob[h + k:h + k + 2], "little")
               for k in (0, 2, 4)]


def test_corrupt_blobs_raise():
    """A segment cut by one byte (its jump entry fixed) is not consumed
    exactly; a zeroed last byte loses segment 1's end mark. Both raise
    HufError naming the blob and segment (the JAX kernel never checks
    consumption: over-reads supply zero bits)."""
    good, data = _blobs([_texty(5000, 6)])[0], _texty(5000, 6)
    blob = _blobs([_texty(4000, 7)])[0][0]
    h, (l1, l2, _) = _jump(blob)
    cut = bytearray(blob)
    cut[h:h + 2] = (l1 - 1).to_bytes(2, "little")
    del cut[h + 6]
    with pytest.raises(HufError, match="blob 1, segment 0: huf stream not"):
        tlh.huf_decompress_lanes([good, (bytes(cut), 4000)], device="cpu")
    zero = bytearray(blob)
    zero[h + 6 + l1 + l2 - 1] = 0
    with pytest.raises(HufError, match="blob 1, segment 1: missing end"):
        tlh.huf_decompress_lanes([good, (bytes(zero), 4000)], device="cpu")
    assert tlh.huf_decompress_lanes([good], device="cpu") == [data]


def test_one_call_for_the_batch_and_device_rule(monkeypatch):
    calls = []
    real = th.huf_decode

    def counted(**kw):
        calls.append(kw["segs"].shape[0])
        return real(**kw)
    monkeypatch.setattr(th, "huf_decode", counted)
    datas = [_texty(700 + 100 * i, 50 + i) for i in range(5)]
    blobs = _blobs(datas) + [(b"\x07", 33)]
    assert tlh.huf_decompress_lanes(blobs, device="cpu") == datas + [
        b"\x07" * 33]
    assert calls == [20]                     # 5 blobs x 4 segments, once
    assert tlh.huf_decompress_lanes([(b"\x07", 33), (b"z", 2)],
                                    device="cpu") == [b"\x07" * 33, b"zz"]
    assert calls == [20]                     # all RLE: nothing launched
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlh.huf_decompress_lanes(blobs)
