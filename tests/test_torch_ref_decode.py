"""The port's oracle decoder (lizard_tpu_torch/ref/block_decode.py, and
api.decompress(backend="ref")) against lizard_tpu/ref/block_decode.py on
the CPU, tolerance 0: the JAX oracle's and the native encoder's streams at
every level decode to the input and to the JAX decoder's bytes; out= and
window_base= on a linked continuation, stop_at and max_out give the JAX
decoder's bytes; truncated, altered and bad-level streams raise
CorruptError where the JAX decoder raises it."""

import numpy as np
import pytest

from lizard_tpu.errors import CorruptError as JCorruptError
from lizard_tpu.ref import block_decode as JD
from lizard_tpu.ref import block_encode as JE
from lizard_tpu.utils.datagen import gen
from lizard_tpu_torch import api, runtime
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.ref import block_decode as PD
from tests.torch_cases import is_optimal

ALL_LEVELS = list(range(10, 50))


def _oracle_input(level):
    return gen(2000 if is_optimal(level) else 8000, seed=100 + level,
               proba=0.6)


@pytest.fixture(scope="module")
def oracle_streams():
    """The JAX oracle's stream of _oracle_input at every level, once."""
    return {lv: JE.compress(_oracle_input(lv), lv) for lv in ALL_LEVELS}


@pytest.mark.parametrize("level", ALL_LEVELS)
def test_streams_decode_like_jax(oracle_streams, level):
    data = _oracle_input(level)
    s = oracle_streams[level]
    assert PD.decompress(s) == JD.decompress(s) == data
    assert api.decompress(s, len(data), backend="ref") == data
    native_in = gen(40_000, seed=level)
    n = runtime.compress(native_in, level)
    assert PD.decompress(n, len(native_in)) == JD.decompress(n) == native_in


def _same(src, out=None, **kw):
    """The port's and the JAX decoder's outcomes on src, asserted equal:
    ("ok", bytes), or ("corrupt", None) where the JAX decoder raises its
    CorruptError and the port raises the port's. Returned."""
    def run(decompress, corrupt_error):
        try:
            return "ok", decompress(
                src, out=None if out is None else bytearray(out), **kw)
        except corrupt_error:
            return "corrupt", None
    got = run(PD.decompress, CorruptError)
    assert got == run(JD.decompress, JCorruptError)
    return got


@pytest.mark.parametrize("level", [10, 17, 21, 41, 45])
def test_linked_continuation_out_and_window_base(level):
    """A second stream whose matches reach into the first part: decoded
    with out= (the first part), as JAX decodes it; window_base past a
    match's source raises in both."""
    data = gen(40_000, seed=7)
    k = 16_000
    ctx = JE.Ctx(level, JE.LEVELS[level])
    tables = JE.Tables(JE.LEVELS[level])
    JE.compress_range(ctx, tables, data, 0, k)
    second = JE.compress_range(ctx, tables, data, k, len(data))
    assert _same(second, out=data[:k]) == ("ok", data[k:])
    assert _same(second, out=data[:k], window_base=0) == ("ok", data[k:])
    assert _same(second, out=data[:k], window_base=k)[0] == "corrupt"
    with pytest.raises(CorruptError):
        PD.decompress(second)                   # no prefix: out of window


@pytest.mark.parametrize("level", [12, 25, 35, 49])
def test_stop_at_and_max_out(oracle_streams, level):
    data = _oracle_input(level)
    s = oracle_streams[level]
    for stop in (1, 100, 1999, len(data), len(data) + 5):
        got = _same(s, stop_at=stop)
        assert got[1][:stop] == data[:stop]
    assert _same(s, max_out=len(data)) == ("ok", data)
    assert _same(s, max_out=len(data) - 1)[0] == "corrupt"
    assert _same(b"")[0] == "corrupt"


@pytest.mark.parametrize("level", [10, 14, 21, 24, 35, 41])
def test_corrupt_streams_raise_like_jax(level):
    """Truncations, altered bytes and bad level bytes: the same bytes or
    CorruptError in both decoders."""
    data = gen(20_000, seed=level, proba=0.6)
    s = runtime.compress(data, level)
    rng = np.random.default_rng(level)
    corrupt = 0
    for cut in sorted(set(rng.integers(1, len(s), 12).tolist())) + [1, 2]:
        corrupt += _same(s[:cut])[0] == "corrupt"
    for pos in rng.integers(1, len(s), 12).tolist():
        bad = bytearray(s)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        corrupt += _same(bytes(bad), max_out=len(data))[0] == "corrupt"
    for lv in (0, 9, 50, 255):
        assert _same(bytes([lv]) + s[1:])[0] == "corrupt"
    assert corrupt > 0
