"""The device encoder's parse, emission and entry points against the JAX
package, on the CPU: parse_tokens (B7) against p2_reference on the mirrors'
own maps, the native emitters against the numpy ones, edge sizes, frames,
api.compress(backend="gpu") and the device rule. Tolerance 0 throughout.
The whole encode_blocks_lanes against the Pallas pipeline is in
test_torch_enc_pipeline.py."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import lizard_tpu.ops.enc_lanes as J
from lizard_tpu.frame import decompress_frame as jdecompress_frame
from lizard_tpu.ref.block_decode import decompress as ref_decompress
from lizard_tpu.utils.datagen import gen, text_like
import lizard_tpu_torch as ltt
import lizard_tpu_torch.ops.enc_lanes as P
from lizard_tpu_torch import runtime
from lizard_tpu_torch.frame import (compress_frame_fast, compress_frame_lanes,
                                    decompress_frame_lanes)
from lizard_tpu_torch.ops.lane_decode import decompress_lanes
from tests.test_enc_lanes import CFG, FAR_CFG, _mk_blocks, _mk_far_blocks
from tests.torch_cases import parse_edge_blocks
from tests.torch_cases import one_thread  # noqa: F401
from tests.test_torch_enc_maps import SWEEP, port_cfg, sweep_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tokens_of(blocks, jcfg, dmap):
    """The port's parse on the mirror's maps `dmap` (after the mirror's
    chain walk at chain > 0): per block, its token list."""
    cfg = port_cfg(jcfg)
    if cfg.chain:
        dmap = J.p15_reference(blocks, jcfg, dmap=dmap)
    data, lens = P.pack_blocks(blocks, cfg)
    maps = P.maps_from_reference(dmap, cfg)[:len(blocks)]
    pcfg = dataclasses.replace(cfg, chain=0)
    got = P.token_arrays(*P.parse_tokens(data, lens, maps, pcfg))
    return [list(zip(*(a.tolist() for a in t))) for t in got]


@pytest.mark.parametrize("combo", SWEEP, ids=str)
def test_parse_equals_p2_reference(combo):
    jcfg, blocks = sweep_case(combo)
    ref, _ = J.p1_reference(blocks, jcfg)
    want = J.p2_reference(blocks, jcfg, dmap=ref)
    assert tokens_of(blocks, jcfg, ref) == want
    assert sum(map(len, want)) > 1000


def test_parse_far_equals_p2_reference():
    jcfg = dataclasses.replace(FAR_CFG, lazy=2)
    blocks = _mk_far_blocks(6)
    ref, _ = J.p1_reference(blocks, jcfg)
    got = tokens_of(blocks, jcfg, ref)
    assert got == J.p2_reference(blocks, jcfg, dmap=ref)
    fars = [t for t in got[0] if t[2] >= jcfg.far_dist]
    assert fars and all(t[1] >= 16 for t in fars)


@pytest.mark.parametrize("combo", [dict(lazy=True, k5=0),
                                   dict(lazy=True, k5=4)], ids=str)
def test_parse_edge_blocks_equal_p2_reference(combo):
    """The card test's parse edge blocks at the 8 KB geometry (a run of
    one byte, random bytes, matches ending at segment boundaries, lengths
    21, 22, 149 and n - 1) through parse_tokens_plain, equal to
    p2_reference on the mirror's maps."""
    jcfg = dataclasses.replace(CFG, **combo)
    blocks = parse_edge_blocks(CFG.n)
    ref, _ = J.p1_reference(blocks, jcfg)
    got = tokens_of(blocks, jcfg, ref)
    assert got == J.p2_reference(blocks, jcfg, dmap=ref)
    assert len(got[0]) >= 1 and len(got[1]) <= 4
    assert any((st + ml) % 128 == 0 for st, ml, _ in got[2])


def test_token_arrays_copy_the_used_prefix():
    tok = torch.zeros((3, 10, 3), dtype=torch.int32)
    tok[1, :2] = torch.tensor([[5, 4, 8], [20, 6, 9]])
    got = P.token_arrays(tok, torch.tensor([0, 2, 1], dtype=torch.int32))
    assert [len(t[0]) for t in got] == [0, 2, 1]
    assert got[1][0].tolist() == [5, 20] and got[1][2].tolist() == [8, 9]
    assert got[1][0].dtype == np.int64
    with pytest.raises(RuntimeError, match="block 2"):
        P.token_arrays(tok, torch.tensor([0, 2, -1], dtype=torch.int32))


def far_tokens():
    """A block with near tokens, a repeated offset and an off24 token, and
    its token arrays."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, 3000, np.uint8).tobytes()
    y = rng.integers(0, 256, 5000, np.uint8).tobytes()
    a = rng.integers(0, 256, 80000, np.uint8).tobytes()
    data = x + x + y + a + a[:20000]
    st = np.array([3000, 4500, 91000], np.int64)
    ml = np.array([1500, 1500, 19984], np.int64)
    off = np.array([3000, 3000, 80000], np.int64)
    return data, st, ml, off


def test_native_emitters_equal_numpy_emitters():
    data, st, ml, off = far_tokens()
    flags, lits, off16, off24 = runtime.emit_liz_far(data, st, ml, off)
    want = J._emit_tokens_liz_scalar(data, st, ml, off)
    assert (flags, lits, off16, off24) == tuple(w.tobytes() for w in want)
    assert len(off24) == 3                           # the off24 class
    block = P.assemble_block(data, flags, lits, off16, off24=off24)
    assert runtime.decompress(bytes([21]) + block, len(data)) == data
    blocks = _mk_blocks(5)
    ref, _ = J.p1_reference(blocks, CFG)
    for d, toks in zip(blocks, J.p2_reference(blocks, CFG, dmap=ref)):
        s, m, o = (np.array([t[k] for t in toks], np.int64)
                   for k in range(3))
        assert runtime.emit_lz4(d, s, m, o) == tuple(
            w.tobytes() for w in J.emit_tokens(d, s, m, o))
        assert runtime.emit_liz(d, s, m, o) == tuple(
            w.tobytes() for w in J.emit_tokens_liz(d, s, m, o)[:3])
        assert runtime.emit_liz_far(d, s, m, o) == tuple(
            w.tobytes() for w in J._emit_tokens_liz_scalar(d, s, m, o))


def test_assemble_block_equals_reference():
    data, st, ml, off = far_tokens()
    text = text_like(50_000, 3)
    for d, huff in ((data, False), (data, True), (text, True)):
        toks = [st, ml, off] if d is data else [np.zeros(0, np.int64)] * 3
        r = runtime.emit_liz_far(d, *toks)
        assert P.assemble_block(d, r[0], r[1], r[2], huff, r[3]) == \
            J.assemble_block(d, r[0], r[1], r[2], huff, r[3])
    assert runtime.huf_compress(bytes(range(256)) * 8) == b""  # incompressible


def small_cfg(level, **kw):
    """cfg_for_level(level) shrunk to the test geometry of
    tests/test_enc_lanes.py (the far table 2 KB late), then `kw`."""
    geometry = dict(n=CFG.n, hl=CFG.hl, maxoff=CFG.maxoff, probes=CFG.probes,
                    far_dist=FAR_CFG.far_dist)
    return dataclasses.replace(J.cfg_for_level(level), **{**geometry, **kw})


@pytest.mark.parametrize("level", [10, 21, 31, 47])
def test_edge_sizes_round_trip(level):
    cfg = port_cfg(small_cfg(level))
    blocks = [gen(sz, sz, proba=0.5)
              for sz in (0, 1, 3, 19, 20, 21, 22, 64, 511, 4097)]
    got = P.encode_blocks_lanes(blocks, level=level, cfg=cfg, device="cpu")
    assert decompress_lanes(got, device="cpu") == blocks
    for d, e in zip(blocks, got):
        assert e[0] == level
        assert bytes(ref_decompress(e, max_out=max(len(d), 1))) == d
        assert runtime.decompress(e, max(len(d), 1)) == d


def test_encode_streams_chunks_and_joins():
    cfg = port_cfg(small_cfg(11))
    datas = [gen(3 * cfg.n + 777, 9, proba=0.6), b"", b"xyz"]
    got = P.encode_streams_lanes(datas, level=11, cfg=cfg, device="cpu")
    blocks = P.encode_blocks_lanes(
        [datas[0][i:i + cfg.n] for i in range(0, len(datas[0]), cfg.n)],
        level=11, cfg=cfg, device="cpu")
    assert got[0] == bytes([11]) + b"".join(b[1:] for b in blocks)
    assert decompress_lanes(got, device="cpu") == datas


def test_frame_and_api():
    """compress_frame_lanes at full geometry (-21), decoded by the port and
    by the JAX package; api.compress(backend="gpu") at -11 and -35."""
    a = gen(12_000, 13, proba=0.62)
    d = a + text_like(8_000, 1) + a
    frame = compress_frame_lanes(d, level=21, device="cpu")
    assert decompress_frame_lanes(frame, device="cpu") == d
    assert jdecompress_frame(frame) == d
    assert compress_frame_lanes(b"", 11, device="cpu") == \
        compress_frame_fast(b"", 11)
    for level in (11, 35):
        out = ltt.compress(d, level, backend="gpu", device="cpu")
        assert ltt.decompress(out, device="cpu") == d
        assert runtime.decompress(out, len(d)) == d
    with pytest.raises(ValueError):
        ltt.compress(d, 55, backend="gpu", device="cpu")
    with pytest.raises(ValueError, match="max_out"):
        ltt.compress(d, 11, backend="gpu", max_out=100, device="cpu")
    with pytest.raises(NotImplementedError):
        ltt.compress(d, 11, backend="tpu")


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.encode_blocks_lanes([b"abc"], level=11)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ltt.compress(b"abc" * 100, 11, backend="gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compress_frame_lanes(b"abc" * 100, 11)


@pytest.mark.parametrize("rel", ["ops/enc_lanes.py", "runtime.py",
                                 "frame.py", "api.py", "ops/enc_huf.py",
                                 "ref/huf_encode.py", "__init__.py"])
def test_encoder_modules_import_no_jax(rel):
    path = os.path.join(ROOT, "lizard_tpu_torch", rel)
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "lizard_tpu")
