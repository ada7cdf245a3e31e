"""The port's host split (lizard_tpu_torch.ops.split) against
lizard_tpu.ops.split: the same flat streams, offsets, lengths and stream ids
for the same compressed streams, at each codeword family with and without
the Huffman stage."""

import numpy as np
import pytest
import torch

from lizard_tpu import runtime as jrt
from lizard_tpu.ops import split as jsplit
from lizard_tpu.utils.datagen import gen, text_like
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.levels import Codewords
from lizard_tpu_torch.ops import lane_decode as tld
from lizard_tpu_torch.ops import split as tsplit
from tests.torch_cases import one_thread  # noqa: F401

FIELDS = tsplit.STREAMS + tsplit.TABLE_FIELDS + ("stream_id",)


def _streams(level):
    datas = [gen(300_000, seed=level, proba=0.6), text_like(150_000, seed=level),
             np.random.default_rng(level).integers(0, 256, 20_000,
                                                   dtype=np.uint8).tobytes(),
             b"", b"z"]
    return datas, [jrt.compress(d, level) for d in datas]


@pytest.mark.parametrize("level", [10, 21, 35, 41])
def test_split_equals_reference(level):
    _, streams = _streams(level)
    ref = jsplit.split_streams(streams, entropy="host")
    port = tsplit.split_streams(streams)
    assert port.n_blocks == ref.n_blocks
    assert port.codewords.value == ref.codewords.value
    for name in FIELDS:
        got = getattr(port, name)
        assert got.dtype == (torch.uint8 if name in tsplit.STREAMS
                             else torch.int64), name
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), getattr(ref, name), name)
    if level >= 30:   # the Huffman stage was present and decoded on the host
        assert any(s[1] & 3 for s in streams if len(s) > 1)


def test_from_reference_batch_decodes_like_split():
    datas, streams = _streams(21)
    ref = jsplit.split_streams(streams, entropy="host")
    fields = {name: np.asarray(getattr(ref, name)) for name in FIELDS}
    carried = tsplit.from_reference_batch(fields, ref.codewords)
    assert carried.codewords == Codewords.LIZv1
    own = tsplit.split_streams(streams)
    for name in FIELDS:
        assert torch.equal(getattr(carried, name), getattr(own, name)), name
    a = tld.decode_batch_lanes(carried, device="cpu")
    b = tld.decode_batch_lanes(own, device="cpu")
    assert a == b
    assert b"".join(a) == b"".join(datas)


def test_from_reference_batch_rejects_table_outside_streams():
    _, streams = _streams(10)
    ref = jsplit.split_streams(streams[:1], entropy="host")
    fields = {name: np.asarray(getattr(ref, name)) for name in FIELDS}
    fields["lit_len"] = fields["lit_len"] + 1
    with pytest.raises(CorruptError):
        tsplit.from_reference_batch(fields, "LZ4")


def test_chain_table():
    sid = torch.tensor([0, 0, 0, 1, 2, 2], dtype=torch.int64)
    want = [[0, 3, 0], [3, 1, 3 << 17], [4, 2, 4 << 17]]
    assert tld.chain_table(sid).tolist() == want
    assert tld.chain_table(torch.zeros(0, dtype=torch.int64)).shape == (0, 3)


def test_split_rejects_mixed_families_and_bad_headers():
    d = gen(5000, seed=1)
    with pytest.raises(CorruptError, match="mixed"):
        tsplit.split_streams([jrt.compress(d, 10), jrt.compress(d, 21)])
    s = bytearray(jrt.compress(d, 10))
    s[1] |= 0x40                     # an undefined header bit
    with pytest.raises(CorruptError, match="header"):
        tsplit.split_streams([bytes(s)])
    with pytest.raises(CorruptError):
        tsplit.split_streams([bytes([9])])
