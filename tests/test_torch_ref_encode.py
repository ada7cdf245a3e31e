"""The port's oracle encoder (lizard_tpu_torch/ref/block_encode.py with
parsers.py, parser_optimal.py, price.py, and the serial Huff0 encode of
ref/huf_encode.py) against lizard_tpu/ref/ on the CPU, tolerance 0: the
same bytes at every level 10-49, on edge inputs, across inner blocks, with
tables reused and with compress_range continued; huf_compress equal to the
JAX one and to the native Huff0. Each JAX output is computed once, in a
module fixture."""

import numpy as np
import pytest

from lizard_tpu.ref import block_decode as JD
from lizard_tpu.ref import block_encode as JE
from lizard_tpu.ref import huf_encode as JH
from lizard_tpu.utils.datagen import gen, text_like
from lizard_tpu_torch import api, runtime
from lizard_tpu_torch.format.constants import FLAG_FLAGS, FLAG_LITERALS
from lizard_tpu_torch.ref import block_decode as PD
from lizard_tpu_torch.ref import block_encode as PE
from lizard_tpu_torch.ref import huf_encode as PH
from tests.torch_cases import alphabet16, is_optimal

ALL_LEVELS = list(range(10, 50))


def level_input(level: int) -> bytes:
    """16 KB at the levels that are not optimal-parser, ~3 KB at the 11
    that are; at 30-49 the skewed 16-symbol alphabet, so literals pass
    1024 bytes."""
    n = 3000 if is_optimal(level) else 16384
    return alphabet16(n, 1) if level >= 30 else gen(n, seed=level)


EDGE = {"empty": b"", "one": b"z", "fifteen": b"abcdefghijklmno",
        "run20k": b"\x61" * 20_000}
EDGE_LEVELS = (10, 17, 21, 35, 41, 49)
BIG = gen(300_000, seed=31, proba=0.6)        # three inner blocks


@pytest.fixture(scope="module")
def jax_out():
    """Every JAX oracle output of this module, computed once."""
    out = {("level", lv): JE.compress(level_input(lv), lv)
           for lv in ALL_LEVELS}
    for name, d in EDGE.items():
        for lv in EDGE_LEVELS:
            out[(name, lv)] = JE.compress(d, lv)
    for lv in (12, 21):
        out[("big", lv)] = JE.compress(BIG, lv)
    return out


@pytest.mark.parametrize("level", ALL_LEVELS)
def test_compress_equals_jax(jax_out, level):
    data = level_input(level)
    s = PE.compress(data, level)
    assert s == jax_out[("level", level)]
    assert api.compress(data, level, backend="ref") == s
    assert PD.decompress(s) == data
    if level >= 30:                         # known fault 3: Huff0 really ran
        assert s[1] & (FLAG_FLAGS | FLAG_LITERALS)


@pytest.mark.parametrize("name", sorted(EDGE))
@pytest.mark.parametrize("level", EDGE_LEVELS)
def test_edge_inputs_equal_jax(jax_out, name, level):
    s = PE.compress(EDGE[name], level)
    assert s == jax_out[(name, level)]
    if name == "empty":
        assert s == bytes([level])          # the level byte alone
    assert JD.decompress(s) == EDGE[name]


@pytest.mark.parametrize("level", [12, 21])
def test_three_inner_blocks_equal_jax(jax_out, level):
    s = PE.compress(BIG, level)
    assert s == jax_out[("big", level)]
    assert PD.decompress(s) == BIG == runtime.decompress(s, len(BIG))


@pytest.mark.parametrize("level", [12, 17, 24, 41])
def test_tables_reuse_equals_jax(level):
    """The tables of one call reused by the next, not cleared: only
    next_to_update is reset, and the second stream's bytes show it."""
    a, b = gen(9000, seed=2), gen(9000, seed=3)
    jt, pt = JE.Tables(JE.LEVELS[level]), PE.Tables(PE.LEVELS[level])
    got = [PE.compress(a, level, pt), PE.compress(b, level, pt)]
    assert got == [JE.compress(a, level, jt), JE.compress(b, level, jt)]
    assert pt.next_to_update == jt.next_to_update
    assert PD.decompress(got[1]) == b


@pytest.mark.parametrize("level", [10, 21, 45])
def test_compress_range_continued_equals_jax(level):
    """One Ctx and Tables over a split input (Lizard_compress_continue):
    the second stream's matches reach into the first part."""
    data = gen(24_000, seed=4)
    k = 10_000
    outs = []
    for mod in (JE, PE):
        ctx = mod.Ctx(level, mod.LEVELS[level])
        tables = mod.Tables(mod.LEVELS[level])
        outs.append([mod.compress_range(ctx, tables, data, 0, k),
                     mod.compress_range(ctx, tables, data, k, len(data))])
    assert outs[1] == outs[0]
    assert PD.decompress(outs[1][1], out=bytearray(data[:k])) == data[k:]


HUF_INPUTS = {
    "text": text_like(20_000, 1),
    "skewed": alphabet16(5000, 2),
    "generated": gen(30_000, 12, proba=0.7),
    "incompressible": np.random.default_rng(3).integers(
        0, 256, 4000, np.uint8).tobytes(),
    "rle": b"\x42" * 700,
    "one": b"\x07",
    "tiny": b"abcabcabcab",
    "two_symbols": bytes([1, 2] * 300),
    "128k": gen(131_072, 5, proba=0.6),
}


@pytest.mark.parametrize("name", sorted(HUF_INPUTS))
def test_huf_compress_equals_jax_and_native(name):
    src = HUF_INPUTS[name]
    got = PH.huf_compress(src)
    assert got == JH.huf_compress(src)
    if len(src) > 1:    # the native Huff0 declines a 1-byte input (b"");
        # Lizard hands Huff0 only streams over 1024 bytes
        assert got == (runtime.huf_compress(src) or None)
    if name == "rle":
        assert got == b"\x42"
    if name in ("incompressible", "tiny"):
        assert got is None


@pytest.mark.parametrize("name", ["text", "skewed", "128k"])
def test_huf_encode_1x_equals_jax(name):
    src = HUF_INPUTS[name]
    count, max_sym, _ = PH.fse_count(src, 255)
    hl = PH.fse_optimal_table_log(PH.HUF_TABLELOG_DEFAULT, len(src), max_sym,
                                  minus=1)
    nb, val, _ = PH.huf_build_ctable(count, max_sym, hl)
    for chunk in (src, src[:1], src[:2], src[:3], src[:4099]):
        assert (PH._huf_encode_1x(chunk, val, nb)
                == JH._huf_encode_1x(chunk, val, nb))
