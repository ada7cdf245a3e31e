"""The port's all-XLA fastLZ4 encoder (lizard_tpu_torch/ops/encode_tpu.py)
against the JAX package's (lizard_tpu/ops/encode_tpu.py) on the CPU: the
five outputs of _encode_batch and every stream's bytes exactly equal
(tolerance 0); frame.compress_frame_tpu against the JAX function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lizard_tpu import frame as JF
from lizard_tpu.ops import encode_tpu as J
from lizard_tpu_torch import frame as PF
from lizard_tpu_torch import runtime
from lizard_tpu_torch.ops import encode_tpu as P
from lizard_tpu_torch.utils.datagen import gen, text_like
from tests.torch_cases import one_thread  # noqa: F401


def _blocks():
    """Four full 128 KB blocks (mixed, text, zeros, random) and the edge
    sizes around the encoder's gates."""
    rng = np.random.default_rng(0)
    return ([gen(131072, 1, proba=0.6), text_like(131072, 2), bytes(131072),
             rng.integers(0, 256, 131072, np.uint8).tobytes()]
            + [gen(size, size, proba=0.5)
               for size in (0, 1, 19, 20, 21, 64, 513, 65536)])


def test_encode_batch_equals_jax():
    """flags, ntok, lits, lit_len and last_end, each row exactly, in the
    JAX module's fixed batches of 8 rows."""
    blocks = _blocks()
    for base in range(0, len(blocks), 8):
        part = blocks[base:base + 8]
        u8 = np.zeros((8, J.N), np.uint8)
        n = np.zeros(8, np.int32)
        for k, d in enumerate(part):
            u8[k, :len(d)] = np.frombuffer(d, np.uint8)
            n[k] = len(d)
        want = J._encode_batch(jnp.asarray(u8), jnp.asarray(n))
        got = P._encode_batch(torch.from_numpy(u8),
                              torch.from_numpy(n.astype(np.int64)))
        for name, w, g in zip(("flags", "ntok", "lits", "lit_len",
                               "last_end"), want, got):
            assert np.array_equal(g.numpy(), np.asarray(w)), name


def test_encode_blocks_equal_jax():
    """encode_blocks_tpu's streams byte-equal to JAX's, each decoding with
    the native decoder; the random block is stored."""
    blocks = _blocks()
    got = P.encode_blocks_tpu(blocks, level=10, device="cpu")
    assert got == J.encode_blocks_tpu(blocks, level=10)
    for d, e in zip(blocks, got):
        assert runtime.decompress(e, max(len(d), 1)) == d
    assert len(got[3]) == 131072 + 5          # level, flag, size, payload
    with pytest.raises(ValueError):
        P.encode_blocks_tpu([b"x" * 131073], device="cpu")


def test_encode_streams_equal_jax():
    """A 300 KB buffer (three inner blocks), an empty and a short one, in
    shared batches."""
    datas = [gen(300 * 1024, 9, proba=0.6), b"", gen(5000, 4)]
    got = P.encode_streams_tpu(datas, level=11, device="cpu")
    assert got == J.encode_streams_tpu(datas, level=11)
    assert got[0][0] == 11
    for d, e in zip(datas, got):
        assert runtime.decompress(e, max(len(d), 1)) == d


def test_compress_frame_tpu_equals_jax():
    """engine="xla" byte-equal to JAX's, decoded by the port; levels 20 and
    up refused there; level 50 clamps; the lanes engine (the default) is
    compress_frame_lanes."""
    d = gen(150_000, 4, proba=0.6)
    f = PF.compress_frame_tpu(d, 11, block_size_id=1, engine="xla",
                              device="cpu")
    assert f == JF.compress_frame_tpu(d, 11, block_size_id=1, engine="xla")
    assert PF.decompress_frame(f, device="cpu") == d
    with pytest.raises(ValueError, match="levels 10-19"):
        PF.compress_frame_tpu(b"x" * 100, 21, engine="xla", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        PF.compress_frame_tpu(b"x" * 100, 11, engine="jax", device="cpu")
    small = gen(20_000, 5)
    lanes = PF.compress_frame_tpu(small, 50, device="cpu")
    assert lanes == PF.compress_frame_lanes(small, 49, device="cpu")
    assert PF.decompress_frame(lanes, device="cpu") == small
