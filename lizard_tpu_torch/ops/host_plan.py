"""The decoder's host split and Huff0 plan of a whole batch in one native
pass (csrc/split_plan.cpp): the main path's form of ops/fuse.py::
plan_split_plain, which splits with ops/split.py and plans with
ops/huf128.py::prepare_huf128 in Python, and which the tests hold this
module against.

`split_plan` takes the batch's inputs, compressed streams or stored frame
blocks, and makes two ctypes calls whatever their number: a walk of the
block headers that sizes every output, then, once the outputs are
allocated, the pass that writes the BlockBatch's flat streams (a Huffman-
coded stream is a hole of `orig` zero bytes, or holds its bytes where the
blob is stored or RLE), its block tables, stream ids and families, and the
HufPlan: every kernel blob's weights header read (ref/huf.py::
huf_read_stats), its segments checked and its bytes appended, its four
`segs` rows and its 4096-entry decode table. The plan half runs only where
a block header flags a Huffman-coded stream. The result equals the plain
version's field for field; its HufPlan's `fills` is empty (the pass wrote
them) and its `names` are formatted only when read. Every fault raises the
class and message that the plain version raises.

The `split` span holds the whole pass, the plan half included, and `plan`
the HufPlan's assembly; the counters "split.native_blocks" and
"plan.native_blobs" add up the inner blocks and the Huff0 blobs (stored and
RLE ones included) of each call.
"""

import collections.abc
import ctypes

import numpy as np
import torch

from lizard_tpu_torch import runtime
from lizard_tpu_torch.errors import CorruptError, HufError
from lizard_tpu_torch.format.constants import (
    LIZARD_MAX_CLEVEL, LIZARD_MIN_CLEVEL)
from lizard_tpu_torch.format.levels import LEVELS, Codewords
from lizard_tpu_torch.ops.huf128 import SEGMENTS, TABLE_ENTRIES, HufPlan
from lizard_tpu_torch.ops.split import STREAMS, TABLE_FIELDS, BlockBatch
from lizard_tpu_torch.utils import profiling

# status codes of csrc/split_plan.cpp and the messages of the plain version
SPLIT_TEXT = {          # CorruptError
    1: "empty stream", 2: "bad level {}",
    3: "uncompressed block header truncated",
    4: "uncompressed block truncated", 5: "FLAG_LEN set",
    6: "bad header byte {}", 7: "stream header truncated",
    8: "stream truncated", 9: "huf stream header truncated",
    10: "huf stream truncated", 11: "mixed codeword families in one batch",
}
BLOB_TEXT = {           # HufError "<name>: ..."
    20: "dst size 0", 21: "csize > dsize", 22: "huf body too small",
    23: "jump table overflow", 24: "bad segmentation",
}
SEGMENT_TEXT = {        # HufError "<name>, segment k: ..."
    30: "empty bitstream", 31: "missing end mark",
}
STATS_TEXT = {          # HufError of the weights header, unnamed
    40: "empty weights header", 41: "weights truncated",
    42: "ncount too small", 43: "tableLog too large", 44: "ncount corrupt",
    45: "ncount overran", 46: "weights tableLog too large",
    47: "fse table spread failed", 48: "empty bitstream",
    49: "missing end mark", 50: "fse output too large",
    51: "weight too large", 52: "all-zero weights",
    53: "huf tableLog too large", 54: "implied weight not a power of 2",
    55: "invalid weight distribution",
}
E_BYTE_RANGE = 60       # a weights symbol past 255: the plain version's
                        # bytearray raises ValueError

ERR_CODE, ERR_ITEM, ERR_BLOCK, ERR_KIND, ERR_SEGMENT, ERR_VALUE = range(6)
(SZ_BLOCKS, SZ_FLAGS, SZ_LITERALS, SZ_OFF16, SZ_OFF24, SZ_BLOBS, SZ_TABLES,
 SZ_DATA, SZ_FAMILY, SZ_FAMILIES) = range(10)

# a level byte's codeword family: 0 fastLZ4, 1 LIZv1, -1 not a level
_LEVEL_FAMILY = np.full(256, -1, np.int8)
for _level in range(LIZARD_MIN_CLEVEL, LIZARD_MAX_CLEVEL + 1):
    _LEVEL_FAMILY[_level] = LEVELS[_level].codewords == Codewords.LIZv1

_lib = None


def _load() -> ctypes.CDLL:
    """csrc/split_plan.cpp (runtime.own_library), its entries declared:
    every pointer as c_void_p."""
    global _lib
    if _lib is None:
        lib = runtime.own_library("split_plan")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fields = (ctypes.c_int64 * 2)()
        lib.ltt_split_plan_fields(fields)
        if tuple(fields) != (ERR_VALUE + 1, SZ_FAMILIES + 1):
            raise RuntimeError("csrc/split_plan.cpp does not match "
                               "ops/host_plan.py")
        lib.ltt_split_size.restype = i64
        lib.ltt_split_size.argtypes = [i64, p, p, p, p, ctypes.c_int, p, p]
        lib.ltt_split_plan.restype = i64
        lib.ltt_split_plan.argtypes = ([i64, p, p, p, p, ctypes.c_int, p, p]
                                       + [p] * 11)
        _lib = lib
    return _lib


class BlobNames(collections.abc.Sequence):
    """HufPlan.names of a native plan: table t's blob as "stream s, block
    b (kind)", formatted when read from `where`, (n_tables, 3) int64 rows
    of stream id, block and kind (an index of split.STREAMS)."""

    def __init__(self, where: torch.Tensor):
        self.where = where

    def __len__(self) -> int:
        return self.where.shape[0]

    def __getitem__(self, t: int) -> str:
        sid, block, kind = self.where[t].tolist()
        return f"stream {sid}, block {block} ({STREAMS[kind]})"


def _raise(err, sids) -> None:
    code = int(err[ERR_CODE])
    if code in SPLIT_TEXT:
        raise CorruptError(SPLIT_TEXT[code].format(int(err[ERR_VALUE])))
    name = (f"stream {sids[int(err[ERR_ITEM])]}, block {int(err[ERR_BLOCK])}"
            f" ({STREAMS[int(err[ERR_KIND])]})")
    if code in BLOB_TEXT:
        raise HufError(f"{name}: {BLOB_TEXT[code]}")
    if code in SEGMENT_TEXT:
        raise HufError(f"{name}, segment {int(err[ERR_SEGMENT])}: "
                       f"{SEGMENT_TEXT[code]}")
    if code in STATS_TEXT:
        raise HufError(STATS_TEXT[code])
    if code == E_BYTE_RANGE:
        raise ValueError("byte must be in range(0, 256)")
    raise RuntimeError(f"split_plan failed with status {code}")


def _ptr(a) -> int:
    return a.data_ptr() if isinstance(a, torch.Tensor) else a.ctypes.data


def split_plan(payloads, stream_ids, stored=None, check_family: bool = True
               ) -> tuple[BlockBatch, HufPlan, list[int]]:
    """Split `payloads` with a hole for every Huffman-coded stream and plan
    the Huff0 decode of every blob into its hole, in one native pass.

    payload i is a compressed stream (level byte + inner blocks), or, where
    stored[i] is true, a stored frame block's bytes (split.split_stored);
    its blocks take stream id stream_ids[i]. check_family refuses inputs
    of two codeword families (split.split_into); without it the blocks
    carry their families (a frame, frame.decode_blocks). Returns the batch,
    the plan, and for each input the end of its inner blocks in the batch.
    The batch and plan are on the CPU and equal ops/fuse.py::
    plan_split_plain's."""
    lib = _load()
    n = len(payloads)
    bufs = [p if isinstance(p, bytes) else bytes(p) for p in payloads]
    src = (ctypes.c_char_p * max(n, 1))(*bufs)
    lens = np.array([len(b) for b in bufs], np.int64)
    flags = (np.zeros(n, np.uint8) if stored is None
             else np.array(stored, np.uint8).reshape(n))
    sids = np.array(stream_ids, np.int64).reshape(n)
    sizes = np.zeros(SZ_FAMILIES + 1, np.int64)
    err = np.zeros(ERR_VALUE + 1, np.int64)
    head = [n, src, _ptr(lens), _ptr(flags), _ptr(_LEVEL_FAMILY),
            int(check_family)]
    with profiling.span("split", "host"):
        if lib.ltt_split_size(*head, _ptr(sizes), _ptr(err)):
            _raise(err, sids)
        nb, nt = int(sizes[SZ_BLOCKS]), int(sizes[SZ_TABLES])
        flat = [torch.empty(int(sizes[SZ_FLAGS + k]), dtype=torch.uint8)
                for k in range(len(STREAMS))]
        table = torch.empty((8, nb), dtype=torch.int64)
        stream_id = torch.empty(nb, dtype=torch.int64)
        family = torch.empty(nb, dtype=torch.uint8)
        item_end = np.zeros(n, np.int64)
        data = torch.empty(int(sizes[SZ_DATA]), dtype=torch.uint8)
        segs = torch.empty((SEGMENTS * nt, 6), dtype=torch.int64)
        tables = torch.empty((nt, TABLE_ENTRIES), dtype=torch.uint16)
        table_log = torch.empty(nt, dtype=torch.int32)
        where = torch.empty((nt, 3), dtype=torch.int64)
        flat_ptrs = (ctypes.c_void_p * len(flat))(*map(_ptr, flat))
        if lib.ltt_split_plan(*head, _ptr(sids), _ptr(sizes), flat_ptrs,
                              *map(_ptr, (table, stream_id, family, item_end,
                                          data, segs, tables, table_log,
                                          where)), _ptr(err)):
            _raise(err, sids)
        cols = dict(zip(TABLE_FIELDS, table))
        batch = BlockBatch(
            codewords=(Codewords.LIZv1 if sizes[SZ_FAMILY] == 1
                       else Codewords.LZ4),
            n_blocks=nb, **dict(zip(STREAMS, flat)), **cols,
            stream_id=stream_id,
            block_family=family if sizes[SZ_FAMILIES] == 3 else None)
    with profiling.span("plan", "host"):
        plan = HufPlan(data=data, segs=segs, tables=tables,
                       table_log=table_log, names=BlobNames(where), fills=[])
    profiling.count("split.native_blocks", nb)
    profiling.count("plan.native_blobs", int(sizes[SZ_BLOBS]))
    return batch, plan, item_end.tolist()
