"""The CUDA kernels (csrc/lz_decode.cu, csrc/huf_decode.cu and the device
encoder's csrc/enc_match.cu, csrc/enc_chain.cu, csrc/enc_parse.cu,
csrc/huf_encode.cu) against their plain PyTorch versions, on the card, on
every path that launches them (ops/pallas_decode.py, ops/lane_huf.py and
the sharded paths of parallel/pipeline.py included); the all-XLA paths
(ops/decode.py, ops/encode_tpu.py) on the card against their CPU runs; the
oracle's streams (ref/block_encode.py) decoded on the card. Every test here
needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor lizard_tpu, so it also runs where JAX is
not installed; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from h100_bench import frames
from lizard_tpu_torch import api
from lizard_tpu_torch import frame as tframe
from lizard_tpu_torch import runtime
from lizard_tpu_torch.errors import CorruptError, HufError
from lizard_tpu_torch.ops import enc_huf as teh
from lizard_tpu_torch.ops import enc_lanes as te
from lizard_tpu_torch.ops import huf128 as th
from lizard_tpu_torch.ops import lane_decode as tld
from lizard_tpu_torch.ops import lane_huf as tlh
from lizard_tpu_torch.ops import pallas_decode as tpd
from lizard_tpu_torch.ops import decode as xla_decode
from lizard_tpu_torch.ops import encode_tpu as xla_encode
from lizard_tpu_torch.ops import split as tsplit
from lizard_tpu_torch.parallel import pipeline
from lizard_tpu_torch.ops.fuse import build_fused_plan
from lizard_tpu_torch.ops.split import (
    STREAMS, new_accumulator, split_into, split_streams)
from lizard_tpu_torch.ref import block_encode
from lizard_tpu_torch.ref.huf import huf_read_stats
from lizard_tpu_torch.utils import profiling
from lizard_tpu_torch.utils.datagen import gen, text_like
from tests.torch_cases import (HUF_PACK_CASES, chain_tail_maps,
                               huf_pack_against_plain, huf_pack_cases,
                               is_optimal, lane_split_against_plain,
                               lane_split_cases, match_edge_blocks,
                               parse_edge_blocks, segment_plan,
                               tablelog12_blob)

pytestmark = pytest.mark.cuda


def count(name: str) -> int:
    """A counter of utils/profiling.py: kernel calls ("<kernel>.launches")
    and kernels launched ("<kernel>.kernel_launches")."""
    return profiling.counters()[name]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _kernel_and_plain(streams, card):
    args = tld.stage_batch(split_streams(streams), card)
    before = count("lz_decode.launches")
    k = tld.lz_decode(**args)
    torch.cuda.synchronize()
    assert count("lz_decode.launches") == before + 1
    p = tld.lz_decode_plain(**args)
    return args, k, p


def _chain_bytes(out, block_len, chains):
    return [bytes(t.cpu().numpy())
            for t in tld.chain_outputs(out, block_len, chains)]


@pytest.mark.parametrize("level", [10, 19, 21, 29, 41])
def test_kernel_matches_plain(level, card):
    a = gen(300_000, seed=1, proba=0.5)
    datas = [gen(300_000, seed=level), text_like(131072, seed=1),
             b"\x00" * 5000, b"ab" * 3000, b"q",
             a + gen(100_000, seed=2, proba=0.5) + a + a]
    streams = [runtime.compress(d, level) for d in datas]
    args, k, p = _kernel_and_plain(streams, card)
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    assert (_chain_bytes(k[0], k[1], args["chains"])
            == _chain_bytes(p[0], p[1], args["chains"]) == datas)
    assert tld.decompress_lanes(streams) == datas


def _set_token(stream, frac, value):
    s = bytearray(stream)
    p = 2
    for _ in range(3):                     # len, off16, off24; then flags
        p += 3 + int.from_bytes(s[p:p + 3], "little")
    n = int.from_bytes(s[p:p + 3], "little")
    s[p + 3 + min(int(n * frac), n - 1)] = value
    return bytes(s)


@pytest.mark.parametrize("level", [10, 21])
def test_corrupt_status_matches_plain(level, card):
    """Altered tokens: the kernel stops each chain with the plain version's
    status code, and the lengths of the blocks before it agree."""
    base = runtime.compress(gen(100_000, seed=3, proba=0.6), level)
    streams = [base] + [_set_token(base, f, v)
                        for f in (0.0, 0.3, 0.9, 0.999)
                        for v in (0x00, 0x07, 0x0F, 0x1F, 0x88, 0xF0, 0xFF)]
    _, k, p = _kernel_and_plain(streams, card)
    assert torch.equal(k[2], p[2])
    assert torch.equal(k[1], p[1])
    assert int(k[2][0]) == tld.OK and (k[2] < 0).any()
    oversized = bytes([level, 0x80]) + (200_000).to_bytes(3, "little") \
        + bytes(200_000)
    with pytest.raises(CorruptError, match="LIZARD_BLOCK_SIZE"):
        tld.decompress_lanes([oversized])


def _huf_kernel_and_plain(batch, plan, card):
    """huf_decode and huf_decode_plain on one staged plan, each into its
    own copy of the staged streams: (kernel status, streams), (plain...)."""
    staged = plan.stage(card)
    runs = []
    for fn in (th.huf_decode, th.huf_decode_plain):
        dests = {k: getattr(batch, k).to(card) for k in STREAMS}
        before = count("huf_decode.launches")
        status = fn(**staged, **dests)
        torch.cuda.synchronize()
        assert count("huf_decode.launches") == before + (fn is th.huf_decode)
        runs.append((status, dests))
    return runs


@pytest.mark.parametrize("level", [31, 35, 41, 45, 49])
def test_huf_kernel_matches_plain(level, card):
    datas = [gen(131072, seed=level, proba=0.6), text_like(131072, seed=2),
             text_like(300_000, seed=3)]
    streams = [runtime.compress(d, level) for d in datas]
    batch, plan = build_fused_plan(streams)
    assert plan.segs.shape[0] >= 4 * len(datas)      # Huffman blobs present
    (ks, kd), (ps, pd) = _huf_kernel_and_plain(batch, plan, card)
    assert torch.equal(ks, ps) and (ks == th.OK).all()
    host = split_streams(streams)
    for k in STREAMS:
        assert torch.equal(kd[k], pd[k]), k
        assert torch.equal(kd[k].cpu(), getattr(host, k)), k
    before = (count("huf_decode.launches"), count("lz_decode.launches"))
    assert tld.decompress_lanes(streams) == datas
    assert (count("huf_decode.launches"), count("lz_decode.launches")) == (
        before[0] + 1, before[1] + 1)


def test_huf_kernel_tablelog_12_and_corrupt_status(card):
    """A tableLog-12 blob decodes on the card as in the plain version; a
    segment cut by one byte (its jump table fixed) is not consumed exactly
    and both give it the same status."""
    rng = torch.Generator().manual_seed(5)
    data = bytes((12 - torch.multinomial(
        torch.tensor([2.0 ** -k for k in range(13)]), 40_000, True,
        generator=rng)).tolist())
    blob = tablelog12_blob(data)
    assert th.prepare_huf128([(blob, len(data))]).table_log.tolist() == [12]
    cut = bytearray(blob)
    head = huf_read_stats(blob)[2]                  # the jump table's start
    l1 = int.from_bytes(cut[head:head + 2], "little")
    cut[head:head + 2] = (l1 - 1).to_bytes(2, "little")
    del cut[head + 6]                   # the first (lowest) byte of segment 0
    blobs = [(blob, len(data)), (bytes(cut), len(data))]
    plan = th.prepare_huf128(blobs)
    out = []
    for dev in (card, "cpu"):
        flat = torch.zeros(2 * len(data), dtype=torch.uint8, device=dev)
        e = torch.empty(0, dtype=torch.uint8, device=dev)
        status = th.huf_decode(**plan.stage(dev), flags=flat, literals=e,
                               off16=e, off24=e)
        out.append((status.cpu(), flat[:len(data)].cpu()))
    (ks, kb), (ps, pb) = out
    assert torch.equal(ks, ps)
    assert ks[:4].tolist() == [0] * 4 and ks[4] == th.ERR_NOT_CONSUMED
    assert bytes(kb.numpy()) == bytes(pb.numpy()) == data
    assert th.huf_decompress_128(blobs[:1]) == [data]
    with pytest.raises(HufError, match="blob 1, segment 0"):
        th.huf_decompress_128(blobs)


# ------------------------------------ huf_decode: inputs of the lane split

def test_huf_kernel_lane_split_cases(card):
    """huf_decode against huf_decode_plain on the card on every lane-split
    case and their corruptions, plus a row out of bounds: statuses equal,
    bytes equal wherever the status is OK, and the OK cases equal their
    data (tests/torch_cases.py::lane_split_against_plain)."""
    r = lane_split_against_plain(card)
    assert r["max_abs_err"] == 0 and r["statuses"][-1] == th.ERR_BOUNDS


def test_huf_kernel_rounds(card):
    """The per-segment synchronisation rounds: codes of one length from a
    misaligned start need many (the serial fallback inside the kernel),
    text codes fall into step at once."""
    cases = lane_split_cases()
    plan = segment_plan([(b, len(d)) for _, b, d in cases])
    total = sum(len(d) for _, _, d in cases)
    out = torch.zeros(total, dtype=torch.uint8, device=card)
    e = torch.empty(0, dtype=torch.uint8, device=card)
    before = count("huf_decode.launches")
    status, rounds = th.huf_decode_rounds(*(t.to(card) for t in plan), out,
                                          e, e, e)
    assert count("huf_decode.launches") == before + 1
    assert (status == th.OK).all()
    r = rounds.cpu().view(-1, 4).tolist()
    names = [n for n, _, _ in cases]
    assert max(r[names.index("equal_8bit")]) > 8
    assert max(r[names.index("equal_7bit")]) > 8
    assert max(r[names.index("segments_of_25000")]) <= 2


@pytest.mark.parametrize("level", [10, 21])
def test_pallas_decode_matches_plain(level, card):
    """decode_batch_pallas on the card (one lz_decode launch) against its
    plain route (device="cpu"): a multi-stream batch, and one 2 MB stream
    (a chain of 16 inner blocks, off24 matches at -21)."""
    a = gen(600_000, seed=1, proba=0.5)
    chain = (a + gen(900_000, seed=level, proba=0.5) + a)[:2 << 20]
    datas = [gen(300_000, seed=level), text_like(131072, seed=1),
             b"\x00" * 5000, b"q", gen(200_000, seed=2, proba=0.7)]
    for parts in (datas, [chain]):
        batch = split_streams([runtime.compress(d, level) for d in parts])
        before = count("lz_decode.launches")
        out, lens = tpd.decode_batch_pallas(batch)
        torch.cuda.synchronize()
        assert count("lz_decode.launches") == before + 1
        p_out, p_lens = tpd.decode_batch_pallas(batch, device="cpu")
        assert torch.equal(lens.cpu(), p_lens)
        k, p = out.cpu().numpy(), p_out.numpy()
        got = [bytes(k[b * 131072:b * 131072 + n])
               for b, n in enumerate(p_lens.tolist())]
        assert got == [bytes(p[b * 131072:b * 131072 + n])
                       for b, n in enumerate(p_lens.tolist())]
        assert [b"".join(g for g, sid in zip(got, batch.stream_id.tolist())
                         if sid == i) for i in range(len(parts))] == parts
    assert batch.n_blocks == 16 and (level < 20 or batch.off24.numel() > 0)
    s = runtime.compress(chain, level)
    assert tpd.decompress_pallas(s, len(chain)) == chain


def test_lane_huf_matches_huf128_and_native(card):
    """huf_decompress_lanes on the card (one huf_decode launch) on the
    Huff0 blobs of -41 streams, a tableLog-12 blob and an RLE blob: equal
    to huf_decompress_128, to its plain route and to the native Huff0."""
    datas = [gen(131072, seed=41, proba=0.6), text_like(300_000, seed=3)]
    blobs = []
    split_into([runtime.compress(d, 41) for d in datas], new_accumulator(),
               lambda b, n, k: blobs.append((b, n)) or bytes(n))
    rng = torch.Generator().manual_seed(6)
    data12 = bytes((12 - torch.multinomial(
        torch.tensor([2.0 ** -k for k in range(13)]), 30_000, True,
        generator=rng)).tolist())
    blobs += [(tablelog12_blob(data12), len(data12)), (b"\x41", 100)]
    before = count("huf_decode.launches")
    got = tlh.huf_decompress_lanes(blobs)
    assert count("huf_decode.launches") == before + 1
    assert got == th.huf_decompress_128(blobs)
    assert got == tlh.huf_decompress_lanes(blobs, device="cpu")
    assert got[:-1] == [runtime.huf_decompress(b, n) for b, n in blobs[:-1]]
    assert got[-2:] == [data12, b"A" * 100] and len(blobs) >= 6


# ------------------------------------- lz_decode: deferred copies, layout

def _plain_equal(streams, card, datas=None):
    """lz_decode (through lz_decode_meta) against lz_decode_plain on one
    staged batch: equal statuses, lengths and (for OK chains) bytes.
    Returns (kernel status, block_len, meta)."""
    args = tld.stage_batch(split_streams(streams), card)
    before = count("lz_decode.launches")
    out, lens, status, meta = tld.lz_decode_meta(**args)
    torch.cuda.synchronize()
    assert count("lz_decode.launches") == before + 1
    p = tld.lz_decode_plain(**args)
    assert torch.equal(status, p[2]) and torch.equal(lens, p[1])
    ok = (status == tld.OK).cpu().tolist()
    got = _chain_bytes(out, lens, args["chains"])
    want = _chain_bytes(*p[:2], args["chains"])
    assert [g for g, o in zip(got, ok) if o] == [w for w, o in zip(want, ok)
                                                   if o]
    if datas is not None:
        assert got == datas
    return status.cpu(), lens.cpu(), meta.cpu()


def _deferred_bytes(meta):
    return int(meta[:, tld.META_DEFERRED_BYTES].sum())


@pytest.mark.parametrize("level", [10, 21])
def test_repeated_pattern_defers_and_resolves(level, card):
    """One stream of eight 128 KB inner blocks of a repeated pattern: every
    block's first match reaches back into the previous block, and in-block
    matches cascade on those deferred bytes."""
    datas = [(b"lizard-" * 200_000)[:8 << 17],
             (bytes(range(251)) * 5000)[:5 << 17] + b"tail"]
    _, _, meta = _plain_equal([runtime.compress(d, level) for d in datas],
                              card, datas)
    assert _deferred_bytes(meta) > (6 << 17)


@pytest.mark.parametrize("level", [21, 29])
def test_off24_reaches_several_blocks_back(level, card):
    """LIZv1 chains whose off24 matches reach 4-6 inner blocks back."""
    a = gen(200_000, seed=4, proba=0.3)
    data = a + text_like(600_000, seed=5) + a + a[:100_000]
    batch = split_streams([runtime.compress(data, level)])
    assert batch.off24.numel() > 0
    _, _, meta = _plain_equal([runtime.compress(data, level)], card, [data])
    assert _deferred_bytes(meta) > 0


def _uncompressed_block(data: bytes) -> bytes:
    return bytes([0x80]) + len(data).to_bytes(3, "little") + data


@pytest.mark.parametrize("level", [10, 21])
def test_short_non_final_block_compacts(level, card):
    """A chain whose first 128 KB inner block is replaced by two stored
    inner blocks of 100,000 and 31,072 bytes: the chain positions of later
    blocks do not move, their matches still reach back, and the output is
    compacted from the slot layout."""
    data = text_like(400_000, seed=6) + gen(200_000, seed=7, proba=0.6)
    s = runtime.compress(data, level)
    spans = tsplit.inner_block_spans(s)
    head = data[:1 << 17]
    mixed = (s[:1] + _uncompressed_block(head[:100_000])
             + _uncompressed_block(head[100_000:]) + s[spans[1][0]:])
    status, lens, meta = _plain_equal([mixed, s], card, [data, data])
    assert lens[0] == 100_000 and _deferred_bytes(meta) > 0
    assert tpd.decompress_pallas(mixed, len(data)) == data


def test_late_corruption_and_bad_cross_block_offset(card):
    """Statuses and lengths equal the plain version's: a token altered in
    the sixth block of a chain, and a chain whose first block is cut to
    1,000 stored bytes, so that the second block's cross-block matches
    reach before the chain's start (offset error in block 1)."""
    data = text_like(900_000, seed=8)
    for level in (10, 21):
        s = runtime.compress(data, level)
        spans = tsplit.inner_block_spans(s)
        late = bytearray(s)
        p = spans[5][0] + 1
        for _ in range(3):                  # len, off16, off24; then flags
            p += 3 + int.from_bytes(late[p:p + 3], "little")
        for k in range(40):
            late[p + 3 + 7 * k] = 0x0F if level < 20 else 0x1F
        cut = s[:1] + _uncompressed_block(data[:1000]) + s[spans[1][0]:]
        status, lens, _ = _plain_equal([s, bytes(late), cut], card)
        n = len(spans)                      # blocks of each chain
        assert status.tolist()[::2] == [tld.OK, tld.ERR_OFFSET]
        assert status[1] < 0 and (lens[n:n + 5] >= 0).all()
        assert (lens[n + 5:2 * n] == -1).all()
        assert lens[2 * n] == 1000 and (lens[2 * n + 1:] == -1).all()


def test_linked_frame_on_the_card(card):
    """A linked frame (one native stream cut into 256 KB frame blocks, a
    stored frame block after it) decodes on the card in one lz_decode
    call to the input, equal to the plain route."""
    data = text_like(700_000, seed=9) + gen(300_000, seed=10, proba=0.6)
    frame = tframe.linked_frame(runtime.compress(data, 21), data, 2)
    before = count("lz_decode.launches")
    assert tframe.decompress_frame(frame) == data
    assert count("lz_decode.launches") == before + 1
    assert tframe.decompress_frame(frame, device="cpu") == data
    assert tframe.decompress_frames(frame + frame) == data + data


@pytest.mark.parametrize("level", [10, 21])
def test_kernel_launches_follow_the_chains(level, card):
    """A batch of one-block chains launches pass1 and scan only (pass 2 has
    no scratch then), also where a block's matches reach before its start
    (the second inner block of a stream, alone: an offset error); a batch
    with a chain of several blocks launches all five kernels."""
    data = text_like(400_000, seed=11)
    s = runtime.compress(data, level)
    spans = tsplit.inner_block_spans(s)
    alone = s[:1] + s[spans[1][0]:spans[1][1]]
    singles = [runtime.compress(data[i:i + (1 << 17)], level)
               for i in range(0, len(data), 1 << 17)]
    for streams, want in ((singles + [alone], 2), (singles + [s], 5)):
        before = count("lz_decode.kernel_launches")
        status, _, meta = _plain_equal(streams, card)
        assert count("lz_decode.kernel_launches") == before + want
        assert (status[:-1] == tld.OK).all()
    assert status[-1] == tld.OK and (meta[:, tld.META_ROUNDS] > 0).any()
    status, _, meta = _plain_equal(singles + [alone], card)
    assert status[-1] == tld.ERR_OFFSET
    assert (meta[:, tld.META_ROUNDS] == 0).all()


def test_chained_frame_tallies_pass2_while_recording(card):
    """A -46 frame of 1 MiB blocks (each a chain of up to 8 inner blocks,
    as a -B4 block is of 32) decodes on the card in one lz_decode call of
    five kernels. While spans record, its readback also counts pass 2's
    deferred bytes (> 0) and jump rounds (>= 1), 16 bytes more; with
    recording off both stay 0 and the call copies back exactly what the
    plain route does, whose readback this path has always had. The bytes
    are the input's either way."""
    data = text_like(1_200_000, seed=12) + gen(1_200_000, seed=13, proba=0.6)
    frame = frames.write_frame(data, 46, 3)
    block = 1 << 20
    chains = -(-len(data) // block)
    pass2 = sum(-(-min(block, len(data) - k * block) // (1 << 17))
                for k in range(chains)) - chains
    profiling.reset()
    assert tframe.decompress_frame(frame, device="cpu") == data
    d2h_plain = count("d2h_bytes")
    profiling.reset()
    off = tframe.decompress_frame(frame)
    n_off = profiling.counters()
    profiling.reset()
    with profiling.recording():
        on = tframe.decompress_frame(frame)
    n_on = profiling.counters()
    assert on == off == data
    for n in (n_off, n_on):
        assert n["lz_decode.launches"] == 1
        assert n["lz_decode.kernel_launches"] == 5
        assert n["lz_decode.chains"] == chains
        assert n["lz_decode.pass2_blocks"] == pass2
    assert n_off["lz_decode.deferred_bytes"] == 0
    assert n_off["lz_decode.jump_rounds"] == 0
    assert n_off["d2h_bytes"] == d2h_plain
    assert n_on["lz_decode.deferred_bytes"] > 0
    assert n_on["lz_decode.jump_rounds"] >= 1
    assert n_on["d2h_bytes"] == d2h_plain + 16


# ------------------------------------------------------- device encoder

SMALL = te.EncCfg(n=8192, hl=10, maxoff=2047,
                  probes=(8, 12, 16, 24, 32, 64, 128, 256), far_dist=2048)


def _enc_blocks(seed):
    """8 KB blocks: redundant, text, far repeats (2-4 KB back), a 4-symbol
    alphabet (dense tokens), a run, random, short and empty."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 256, 4096, np.uint8).tobytes()
    return [gen(8192, seed, proba=0.7), text_like(8192, seed + 1),
            head[:3000] * 2 + head[:2000],
            rng.integers(0, 4, 8192, np.uint8).tobytes(), b"\x55" * 3000,
            rng.integers(0, 256, 8192, np.uint8).tobytes(),
            gen(100, seed + 2), b""]


def _encode_against_plain(blocks, cfg, card):
    """match_find, chain_walk (chain tiers) and parse_tokens on the card
    against their plain versions on the same inputs, launches counted.
    Returns the kernel's token arrays."""
    data, lens = te.pack_blocks(blocks, cfg, card)
    before = (count("match_find.launches"), count("chain_walk.launches"),
              count("parse_tokens.launches"))
    maps = te.match_find(data, lens, cfg)
    torch.cuda.synchronize()
    assert torch.equal(maps, te.match_find_plain(data, lens, cfg))
    if cfg.chain:
        won = te.chain_walk(data, lens, maps, cfg)
        torch.cuda.synchronize()
        assert torch.equal(won, te.chain_walk_plain(data, lens, maps, cfg))
        maps = won
    pcfg = dataclasses.replace(cfg, chain=0)
    tok, counts = te.parse_tokens(data, lens, maps, pcfg)
    torch.cuda.synchronize()
    ptok, pcounts = te.parse_tokens_plain(data, lens, maps, pcfg)
    assert torch.equal(counts, pcounts) and (counts >= 0).all()
    got = te.token_arrays(tok, counts)
    want = te.token_arrays(ptok, pcounts)
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
    assert (count("match_find.launches"), count("chain_walk.launches"),
            count("parse_tokens.launches")) == (before[0] + 1,
                                          before[1] + bool(cfg.chain),
                                          before[2] + 1)
    return got


@pytest.mark.parametrize("tier", [
    dict(), dict(lazy=1, k5=1), dict(lazy=2, k5=2), dict(lazy=2, k5=4),
    dict(lazy=1, far=1), dict(lazy=2, k5=4, far=1),
    dict(lazy=2, k5=4, far=1, hl=16),               # tables in global memory
    dict(lazy=2, chain=2), dict(lazy=2, k5=2, chain=3, pref=16),
    dict(lazy=2, chain=16, pref=16, hl=16),         # global, as at x8-x9
], ids=str)
def test_encoder_kernels_match_plain(tier, card):
    cfg = dataclasses.replace(SMALL, **tier)
    blocks = _enc_blocks(len(tier))
    toks = _encode_against_plain(blocks, cfg, card)
    assert len(toks[3][0]) > 1000                   # the dense block
    if cfg.far:
        assert (toks[2][2] >= cfg.far_dist).any()   # far tokens
    level = (21 if cfg.far else 11) + 20 * (cfg.k5 == 4)
    streams = te.encode_blocks_lanes(blocks, level, cfg=cfg)
    assert [runtime.decompress(s, max(len(d), 1))
            for s, d in zip(streams, blocks)] == blocks
    assert tld.decompress_lanes(streams) == blocks


@pytest.mark.parametrize("level", [11, 21, 35, 49])
def test_encoder_kernels_full_geometry(level, card):
    """Two 128 KB blocks at the level's own geometry; the API on the card
    gives the same stream as on the CPU."""
    cfg = te.cfg_for_level(level)
    a = gen(70_000, level, proba=0.5)
    blocks = [gen(131072, level, proba=0.7), (a + a)[:131072]]
    _encode_against_plain(blocks, cfg, card)
    data = b"".join(blocks)
    out = ltt_compress(data, level)
    assert out == ltt_compress(data, level, device="cpu")
    assert runtime.decompress(out, len(data)) == data


@pytest.mark.parametrize("level", [11, 21, 35, 45, 49])
def test_parse_kernel_edge_blocks(level, card):
    """The parse's edge blocks at the level's own geometry, the kernels
    against their plain versions; the run is one token to lim, the random
    block almost none, a boundary match ends on a segment end, and at the far
    levels (21, 45) a token reaches 80,000 bytes back."""
    cfg = te.cfg_for_level(level)
    blocks = parse_edge_blocks(cfg.n)
    toks = _encode_against_plain(blocks, cfg, card)
    st, ml, off = toks[0]
    assert len(st) == 1 and st[0] + ml[0] == cfg.n - 16
    assert len(toks[1][0]) <= 4                      # chance matches
    st, ml, _ = toks[2]
    assert ((st + ml) % 128 == 0).any()
    assert all(len(t[0]) == 0 for t in toks[3:5])
    if cfg.far:
        assert (toks[7][2] == 80_000).any()


@pytest.mark.parametrize("level,tier", [
    (11, {}), (21, {}), (35, {}), (45, {}), (49, {}),
    (45, dict(hl=16)),                  # six 2^16 tables: global memory
], ids=str)
def test_match_chain_kernels_edge_blocks(level, tier, card):
    """The blocks that bound match_find's and chain_walk's designs at the
    level's own geometry (x8-x9: one 2^16 table; 45 at hl 16: six), the
    kernels against their plain versions, chain_walk also on tail maps
    whose prefixes run into the zero pad; the profiling instances give the
    same outputs; the streams decode."""
    cfg = dataclasses.replace(te.cfg_for_level(level), **tier)
    blocks = match_edge_blocks(cfg.n, cfg.far_dist)
    data, lens = te.pack_blocks(blocks, cfg, card)
    maps = te.match_find(data, lens, cfg)
    torch.cuda.synchronize()
    assert torch.equal(maps, te.match_find_plain(data, lens, cfg))
    pmaps, prof = te.match_find_profile(data, lens, cfg)
    assert torch.equal(pmaps, maps)
    p = prof.cpu()
    assert (p[:, 1] > 0).all() and (p[:, 1] <= p[:, 0]).all()
    if cfg.chain:
        for m in (maps, chain_tail_maps(maps)):
            won = te.chain_walk(data, lens, m, cfg)
            torch.cuda.synchronize()
            assert torch.equal(won, te.chain_walk_plain(data, lens, m, cfg))
            pwon, prof = te.chain_walk_profile(data, lens, m, cfg)
            assert torch.equal(pwon, won)
        nodes = prof.cpu().view(len(blocks), -1, 6).sum(1)[:, 3]
        assert nodes[9] > cfg.chain * cfg.n // 4         # counted period
    if not tier:
        streams = te.encode_blocks_lanes(blocks, level)
        assert [runtime.decompress(s, max(len(d), 1))
                for s, d in zip(streams, blocks)] == blocks


@pytest.mark.parametrize("level", [46, 49])
def test_chain_tally_equals_plain(level, card):
    """While spans record, chain_tally of the card's walk equals that of
    the plain version's, and a frame encode at the level on the card
    counts the same "chain_walk.positions" and "chain_walk.replaced" as on
    the CPU, with the same bytes; with spans off there is no tally."""
    cfg = te.cfg_for_level(level)
    blocks = [gen(cfg.n, level, proba=0.6), text_like(cfg.n, level + 1),
              gen(cfg.n // 2, level + 2, proba=0.4)]
    data, lens = te.pack_blocks(blocks, cfg, card)
    maps = te.match_find(data, lens, cfg)
    won = te.chain_walk(data, lens, maps, cfg)
    assert te.chain_tally(maps, won) is None
    with profiling.recording():
        tally = te.chain_tally(maps, won)
        cpu_maps = maps.cpu()
        plain = te.chain_tally(cpu_maps, te.chain_walk_plain(
            data.cpu(), lens.cpu(), cpu_maps, cfg))
    assert tally.device.type == "cuda"
    assert tally.cpu().tolist() == plain.tolist()
    assert 0 < plain[1] < plain[0]
    seen = []
    for dev in (card, "cpu"):
        profiling.reset()
        with profiling.recording():
            f = api.compress_frame(b"".join(blocks), level=level,
                                   block_size_id=4, device=dev)
        n = profiling.counters()
        seen.append((f, n["chain_walk.positions"], n["chain_walk.replaced"]))
    assert seen[0] == seen[1] and seen[0][1] > seen[0][2] > 0


def ltt_compress(data, level, device=None):
    from lizard_tpu_torch import compress
    return compress(data, level, backend="gpu", device=device)


def _huf_plan():
    rng = np.random.default_rng(9)
    streams = [text_like(60_000, 11), gen(131_072, 5, proba=0.6),
               gen(30_000, 12, proba=0.7), b"\x42" * 500, text_like(1025, 3),
               rng.integers(0, 9, 5000, np.uint8).tobytes(),
               rng.integers(0, 256, 4000, np.uint8).tobytes()]
    return streams, teh.plan_huf_streams(streams)


def test_huf_pack_matches_plain(card):
    """huf_pack against huf_pack_plain (words, bits, status exactly), and
    the blobs of huf_compress_batch on the card equal the native Huff0's."""
    streams, plan = _huf_plan()
    args = plan.stage(card)
    before = count("huf_pack.launches")
    k = teh.huf_pack(**args)
    torch.cuda.synchronize()
    assert count("huf_pack.launches") == before + 1
    p = teh.huf_pack_plain(**args)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert (k[2] == teh.OK).all() and len(plan.coded) == 5
    blobs = teh.huf_compress_batch(streams)
    assert [b or b"" for b in blobs] == [runtime.huf_compress(s)
                                         for s in streams]


def test_huf_pack_status_matches_plain(card):
    """A symbol whose table entry is missing (stream 0), codes too long for
    the reserved words (stream 1), a row outside its tensors (stream 2,
    segment 1): the same status, zeroed words and bits as the plain
    version, and the error names the stream."""
    _, plan = _huf_plan()
    tables, segs = plan.tables.clone(), plan.segs.clone()
    data = plan.data.numpy()
    first = data[:int(segs[0, 1])]
    tables[0, int(np.bincount(first).argmax())] = 0
    tables[1] = torch.where(tables[1] != 0,
                            (20 << 16) | (tables[1] & 0xFFFF), 0)
    segs[9, 0] = data.size
    args = dict(data=plan.data.to(card), segs=segs.to(card),
                tables=tables.to(card), n_words=plan.n_words)
    k = teh.huf_pack(**args)
    p = teh.huf_pack_plain(**args)
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b.cpu())
    st = k[2].cpu().tolist()
    assert st[0] == teh.ERR_NO_CODE and st[4:8] == [teh.ERR_OVERFLOW] * 4
    assert st[9] == teh.ERR_BOUNDS and st[8] == st[10] == teh.OK
    assert (k[2] == teh.OK).sum() >= 8
    with pytest.raises(RuntimeError, match="stream 0, segment 0: a symbol"):
        teh.raise_on_status(k[2], plan)


def test_huf_pack_edge_cases(card):
    """huf_pack against huf_pack_plain on the plans that bound its split
    (tests/torch_cases.py::huf_pack_cases: segment lengths around the
    steps, rounds and the word buffer, 1-, 8-, 11-, 16-, 20- and 32-bit
    codes, overflow, a missing code in the last step, rows out of bounds):
    words, bits and status exactly, one call (two kernels) a case. The
    profiling instance gives the same outputs and a row per segment: one
    round up to PACK_WHOLE symbols, else ceil(len / PACK_ROUND), where no
    code is missing; zeros for a row out of bounds."""
    before = count("huf_pack.launches"), count("huf_pack.kernel_launches")
    r = huf_pack_against_plain(card)
    assert r["cases"] == list(HUF_PACK_CASES) and r["max_abs_err"] == 0
    assert count("huf_pack.launches") == before[0] + len(HUF_PACK_CASES)
    assert count("huf_pack.kernel_launches") == \
        before[1] + 2 * len(HUF_PACK_CASES)
    for name, (data, segs, tables, n_words), expect in huf_pack_cases():
        args = [t.to(card) for t in (data, segs, tables)] + [n_words]
        k = teh.huf_pack(*args)
        *p, prof = teh.huf_pack_profile(*args)
        for a, b in zip(k, p):
            assert torch.equal(a, b), name
        prof = prof.cpu()
        for s, n in enumerate(segs[:, 1].tolist()):
            if expect[s] == teh.ERR_BOUNDS:
                assert (prof[s] == 0).all(), name
                continue
            assert prof[s, 0] >= prof[s, 1:7].sum() > 0, name
            rounds = (min(n, 1) if n <= teh.PACK_WHOLE
                      else -(-n // teh.PACK_ROUND))
            if expect[s] != teh.ERR_NO_CODE:
                assert prof[s, 7] == rounds, name


@pytest.mark.parametrize("level", [35, 49])
def test_encode_entropy_routes_equal(level, card):
    """encode_blocks_lanes at the level's own geometry: entropy="gpu" (one
    huf_pack launch) byte-equal to entropy="host"; the streams decode."""
    rng = np.random.default_rng(level)
    blocks = [text_like(131_072, level), gen(131_072, level, proba=0.6),
              rng.integers(0, 9, 131_072, np.uint8).tobytes(), b"",
              gen(5000, level)]
    before = count("huf_pack.launches")
    got = te.encode_blocks_lanes(blocks, level)
    torch.cuda.synchronize()
    assert count("huf_pack.launches") == before + 1
    assert got == te.encode_blocks_lanes(blocks, level, entropy="host")
    assert any(s[1] & 3 == 3 for s in got if len(s) > 1)
    assert [runtime.decompress(s, max(len(d), 1))
            for s, d in zip(got, blocks)] == blocks
    assert tld.decompress_lanes(got) == blocks


# ---------------------------------------- sharded and all-XLA paths (A2-A3)


@pytest.mark.parametrize("level", [12, 21, 41])
def test_sharded_lanes_decode_on_card(level, card):
    """decode_streams_sharded_lanes over ["cuda:0"] * 3 equal to one
    decompress_lanes call and to the input: one lz_decode call a shard,
    one huf_decode call a shard at 41 (every shard holds text)."""
    datas = [text_like(131_072, level + i) if i % 2 == 0
             else gen(131_072, level + i, proba=0.6) for i in range(7)]
    streams = [runtime.compress(d, level) for d in datas]
    before = count("lz_decode.launches"), count("huf_decode.launches")
    got = pipeline.decode_streams_sharded_lanes(streams, ["cuda:0"] * 3)
    torch.cuda.synchronize()
    assert count("lz_decode.launches") == before[0] + 3
    assert count("huf_decode.launches") == \
        before[1] + (3 if level >= 30 else 0)
    assert got == tld.decompress_lanes(streams) == datas


@pytest.mark.parametrize("level", [10, 21])
def test_xla_decode_batch_card_equals_cpu(level, card):
    """ops/decode.py's decode_batch on the card equal to its CPU run (bytes
    and lengths), and the sharded all-XLA decode on the card equal to the
    input."""
    datas = [gen(40_000 + 999 * i, seed=i, proba=0.6) for i in range(4)]
    datas.append(gen(140_000, seed=9))
    streams = [runtime.compress(d, level) for d in datas]
    batch = split_streams(streams)
    total = sum(map(len, datas))
    out, lens = xla_decode.decode_batch(batch, total, device=card)
    cpu_out, cpu_lens = xla_decode.decode_batch(batch, total, device="cpu")
    assert torch.equal(out.cpu(), cpu_out) and torch.equal(lens.cpu(),
                                                           cpu_lens)
    assert bytes(cpu_out.numpy()) == b"".join(datas)
    assert pipeline.decode_streams_sharded(streams, 262_144,
                                           ["cuda:0"] * 2) == datas


def test_xla_encode_batch_card_equals_cpu(card):
    """ops/encode_tpu.py's _encode_batch on the card equal to its CPU run
    (all five outputs), and encode_blocks_tpu's streams equal."""
    rng = np.random.default_rng(3)
    blocks = [gen(131_072, 1, proba=0.6), text_like(131_072, 2),
              rng.integers(0, 256, 131_072, np.uint8).tobytes(), b"",
              gen(21, 21), gen(513, 5)]
    u8 = np.zeros((len(blocks), xla_encode.N), np.uint8)
    n = np.array([len(d) for d in blocks], np.int64)
    for k, d in enumerate(blocks):
        u8[k, :len(d)] = np.frombuffer(d, np.uint8)
    u8, n = torch.from_numpy(u8), torch.from_numpy(n)
    k = xla_encode._encode_batch(u8.to(card), n.to(card))
    p = xla_encode._encode_batch(u8, n)
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)
    got = xla_encode.encode_blocks_tpu(blocks, device=card)
    assert got == xla_encode.encode_blocks_tpu(blocks, device="cpu")
    assert [runtime.decompress(s, max(len(d), 1))
            for s, d in zip(got, blocks)] == blocks


@pytest.mark.parametrize("level", [11, 49])
def test_encode_blocks_sharded_on_card(level, card):
    """encode_blocks_sharded over ["cuda:0"] * 3 byte-equal to one
    encode_blocks_lanes call: one match_find and one parse_tokens call a
    shard."""
    blocks = [gen(131_072 - 7 * i, level + i, proba=0.6) for i in range(5)]
    blocks += [text_like(131_072, 3), b"", b"abc"]
    before = count("match_find.launches"), count("parse_tokens.launches")
    got = pipeline.encode_blocks_sharded(blocks, level,
                                         devices=["cuda:0"] * 3)
    torch.cuda.synchronize()
    assert count("match_find.launches") == before[0] + 3
    assert count("parse_tokens.launches") == before[1] + 3
    assert got == te.encode_blocks_lanes(blocks, level)
    assert tld.decompress_lanes(got) == blocks


# ------------------------------------------------- the oracle's streams (A5)


@pytest.mark.parametrize("level", [10, 11, 12, 17, 19, 20, 21, 24, 46])
def test_oracle_streams_decode_on_card(level, card):
    """The oracle's streams (ref/block_encode.py: liblizard's bytes) from
    one level of each parser family, decoded on the card by one
    decompress_lanes call and by api.decompress, equal to the input."""
    n = 3000 if is_optimal(level) else 40_000
    datas = [gen(n, seed=level, proba=0.6), text_like(n, level)]
    streams = [block_encode.compress(d, level) for d in datas]
    before = count("lz_decode.launches")
    assert tld.decompress_lanes(streams) == datas
    assert count("lz_decode.launches") == before + 1
    assert [api.decompress(s) for s in streams] == datas


# ------------------------------------------- the incremental layer (A6)


def test_frame_decoder_on_card(card):
    """FrameDecoder on the card: a linked frame of 256 KB frame blocks fed
    a frame block an update (each update one lz_decode call, its chain
    headed by the window kept in `out`) and in 64 KB chunks, equal to
    decompress_frame; DecompressStream on the card equal to its input."""
    from lizard_tpu_torch.streaming import CompressStream, DecompressStream
    data = text_like(700_000, seed=9) + gen(300_000, seed=10, proba=0.6)
    frame = tframe.linked_frame(runtime.compress(data, 21), data, 2)
    info = tframe.parse_frame_header(frame)
    blocks = tframe._frame_blocks(frame, info.header_size)[0]
    dec = tframe.FrameDecoder()
    before = count("lz_decode.launches")
    out, p = [dec.update(frame[:info.header_size])], info.header_size
    for stored, blob in blocks:
        out.append(dec.update(frame[p:p + 4 + len(blob)]))
        p += 4 + len(blob)
    out.append(dec.update(frame[p:]))
    torch.cuda.synchronize()
    assert b"".join(out) == data == tframe.decompress_frame(frame)
    assert count("lz_decode.launches") == before + 1 + len(blocks)
    assert dec.restaged == [k * (256 << 10) for k in range(len(blocks))]
    assert dec.finished
    dec = tframe.FrameDecoder()
    assert b"".join(dec.update(frame[i:i + 65_536])
                    for i in range(0, len(frame), 65_536)) == data
    cs, ds = CompressStream(11), DecompressStream()
    chunks = [data[i:i + 65_536] for i in range(0, 262_144, 65_536)]
    assert [ds.decompress_continue(cs.compress_continue(c), len(c))
            for c in chunks] == chunks
