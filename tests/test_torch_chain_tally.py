"""What the device encoder's hash-chain tier (levels 46-49) did, counted
while spans record: chain_walk's tally of the positions whose map-0
candidate it walked from and of those whose match it replaced with a
longer one, carried back in the token readback's copy as the counters
"chain_walk.positions" and "chain_walk.replaced". On the CPU (the plain
versions): the counts equal those read straight off chain_walk_plain's
input and output maps, nothing is counted and no operation is added with
spans off, and a -49 frame of the benchmark's corpus decodes to its
input through the benchmark's plain reference and the port's decoder.
The card's counts against these: tests/test_torch_cuda.py. Imports no
JAX."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from h100_bench import corpus, native
from h100_bench.reference import frame as ref_frame
from lizard_tpu_torch import api
from lizard_tpu_torch.ops import enc_lanes as te
from lizard_tpu_torch.utils import profiling
from tests.torch_cases import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("chain_walk.positions", "chain_walk.replaced")
SEED = 2**31 + 49
SMALL = te.EncCfg(n=8192, hl=10, maxoff=2047, lazy=2, chain=16, pref=16,
                  probes=(8, 12, 16, 24, 32, 64, 128, 256), far_dist=2048)


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


def _corpus(size: int, part: int) -> bytes:
    """`size` bytes of the lizv1huf-l49 configuration's corpus recipe."""
    with open(os.path.join(ROOT, "h100_bench", "configs",
                           "lizv1huf-l49.json")) as f:
        kinds = json.load(f)["corpus_kinds"]
    return corpus.build(SEED, size, part, kinds)


def _direct(blocks, cfg) -> tuple[int, int]:
    """Positions with a map-0 candidate, and those whose map 0 the walk
    changed, counted on chain_walk_plain's input and output maps."""
    data, lens = te.pack_blocks(blocks, cfg)
    maps = te.match_find_plain(data, lens, cfg)
    won = te.chain_walk_plain(data, lens, maps, cfg)
    m_in, m_out = maps[:, 0].numpy(), won[:, 0].numpy()
    return int(np.count_nonzero(m_in)), int(np.count_nonzero(m_out != m_in))


class _OpCount(TorchDispatchMode):
    """Counts the tensor operations run inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _inner_blocks(data: bytes, n: int) -> list[bytes]:
    return [data[i:i + n] for i in range(0, len(data), n)]


@pytest.mark.parametrize("level", [46, 49])
def test_tally_counts_what_the_walk_did(level):
    """chain_tally of a chain_walk call while recording, read back with the
    token counts, counts the positions and replacements seen directly on
    chain_walk_plain's maps."""
    cfg = te.cfg_for_level(level)
    blocks = _inner_blocks(_corpus(1 << 18, 1 << 16), cfg.n)
    data, lens = te.pack_blocks(blocks, cfg)
    maps = te.match_find(data, lens, cfg)
    with profiling.recording():
        tally = te.chain_tally(maps, te.chain_walk(data, lens, maps, cfg))
        counts = torch.zeros(len(blocks), dtype=torch.int32)
        tok = torch.zeros((len(blocks), 1, 3), dtype=torch.int32)
        te.token_arrays(tok, counts, tally)
    n = profiling.counters()
    positions, replaced = _direct(blocks, cfg)
    assert (n[COUNTERS[0]], n[COUNTERS[1]]) == (positions, replaced)
    assert 0 < replaced < positions <= len(b"".join(blocks))
    assert n["d2h_bytes"] == counts.numel() * 4 + 16


def test_nothing_counted_while_spans_are_off():
    """With spans off chain_tally is None and runs no tensor operation, and
    an encode counts no chain counter and reads back the counts alone;
    while recording it counts both, 16 bytes more."""
    blocks = _inner_blocks(_corpus(3 * SMALL.n, SMALL.n), SMALL.n)
    data, lens = te.pack_blocks(blocks, SMALL)
    maps = te.match_find(data, lens, SMALL)
    won = te.chain_walk(data, lens, maps, SMALL)
    with _OpCount() as seen:
        assert te.chain_tally(maps, won) is None
    assert seen.n == 0
    with profiling.recording(), _OpCount() as seen:
        assert te.chain_tally(maps, won) is not None
    assert seen.n > 0
    off = te.encode_blocks_lanes(blocks, 49, SMALL, device="cpu")
    n_off = profiling.counters()
    assert not set(COUNTERS) & set(n_off)
    profiling.reset()
    with profiling.recording():
        on = te.encode_blocks_lanes(blocks, 49, SMALL, device="cpu")
    n_on = profiling.counters()
    assert on == off
    assert (n_on[COUNTERS[0]], n_on[COUNTERS[1]]) == _direct(blocks, SMALL)
    assert n_on["d2h_bytes"] == n_off["d2h_bytes"] + 16


def test_l49_frame_decodes_and_counts():
    """compress_frame at -49 (backend="gpu", device="cpu") of 256 KiB of
    the configuration's corpus: a frame asked for at -B4, its block size
    shrunk to the input's (lizard_frame.c's rule), so one frame block of
    two inner blocks, that the benchmark's plain reference and the port's
    decoder both decode to the input; the call's root span carries the
    walk's counts."""
    data = _corpus(1 << 18, 1 << 16)
    with profiling.recording():
        f = api.compress_frame(data, level=49, block_size_id=4,
                               content_checksum=True, backend="gpu",
                               device="cpu")
    roots = [r for r in profiling.records() if r.parent is None]
    assert [r.name for r in roots] == ["compress_frame"]
    parsed = ref_frame.parse(f, native.xxh32)
    assert parsed["block_size"] == 1 << 18 and len(parsed["blocks"]) == 1
    assert parsed["checksum"] == native.xxh32(data)
    assert ref_frame.decode(f, native.xxh32) == data
    assert api.decompress_frame(f, device="cpu") == data
    assert len(f) < len(data) // 2
    cfg = te.cfg_for_level(49)
    positions, replaced = _direct(_inner_blocks(data, cfg.n), cfg)
    assert roots[0].counts[COUNTERS[0]] == positions
    assert roots[0].counts[COUNTERS[1]] == replaced


def test_tally_sums_both_maps_in_one_tensor():
    """chain_tally on hand-made maps: a position counts when map 0 held a
    candidate, and as replaced when the walk's map 0 differs from it."""
    n = 2 * te.SEG
    maps = torch.zeros((2, 2, n), dtype=torch.uint16)
    maps[0, 0, :4] = torch.tensor([0, 5, 7, 9])
    maps[1, 0, 6] = 3
    maps[1, 0, te.SEG:] = 1                     # a whole segment: 128
    maps[:, 1] = 11                             # the delta map: not read
    out = maps[:, :1].clone()
    out[0, 0, 2:4] = torch.tensor([70, 90])
    out[1, 0, n - 1] = 2
    assert te.chain_tally(maps, out) is None
    with profiling.recording():
        tally = te.chain_tally(maps, out)
    assert tally.dtype == torch.int64
    assert tally.tolist() == [3 + 1 + te.SEG, 3]
