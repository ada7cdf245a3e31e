"""Host-side stream splitting: compressed Lizard streams -> struct-of-arrays
block batch for the CUDA decode kernel (the port of lizard_tpu/ops/split.py).

The block format (1 level byte + per-block 5 separated streams,
lib/lizard_decompress.c:115-264) is parsed on the host; stream payloads are
concatenated into flat uint8 tensors with per-block int64 offsets and
lengths. Huffman-coded streams (levels 30-49) are either entropy-decoded
during the split by the native Huff0 (entropy="host"), or left as holes of
zero bytes that the Huff0 kernel fills (entropy="gpu"; ops/huf128.py, and
ops/fuse.py for the fused path, where the holes are filled on the card).

Everything in a `BlockBatch` lies on the CPU; the decoder moves it to the
device once (ops/lane_decode.py::stage_batch).
"""

from dataclasses import dataclass

import numpy as np
import torch

from lizard_tpu_torch import runtime
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import (
    FLAG_FLAGS,
    FLAG_LEN,
    FLAG_LITERALS,
    FLAG_OFFSET16,
    FLAG_OFFSET24,
    FLAG_UNCOMPRESSED,
    LIZARD_BLOCK_SIZE,
    LIZARD_MAX_CLEVEL,
    LIZARD_MIN_CLEVEL,
)
from lizard_tpu_torch.format.levels import LEVELS, Codewords
from lizard_tpu_torch.ops.huf128 import huf_decompress_128
from lizard_tpu_torch.utils import profiling

STREAMS = ("flags", "literals", "off16", "off24")
# per-block (offset, length) field names, in the column order of
# BlockBatch.block_table()
TABLE_FIELDS = ("flags_off", "flags_len", "lit_off", "lit_len",
                "off16_off", "off16_len", "off24_off", "off24_len")


@dataclass
class BlockBatch:
    """A batch of inner blocks in SoA form, on the CPU. Blocks belonging to
    one compressed stream stay in order: match windows span inner blocks."""
    codewords: Codewords
    n_blocks: int
    # flat payload tensors (uint8)
    flags: torch.Tensor
    literals: torch.Tensor
    off16: torch.Tensor
    off24: torch.Tensor
    # per-block [n_blocks] int64 offsets/lengths into the flat tensors
    flags_off: torch.Tensor
    flags_len: torch.Tensor
    lit_off: torch.Tensor
    lit_len: torch.Tensor
    off16_off: torch.Tensor
    off16_len: torch.Tensor
    off24_off: torch.Tensor
    off24_len: torch.Tensor
    # stream id per block (int64); consecutive blocks of one id form a chain
    stream_id: torch.Tensor
    # codeword family per block (uint8: 0 fastLZ4, 1 LIZv1) where the batch
    # mixes them; None: every block is `codewords`
    block_family: torch.Tensor | None = None

    @property
    def max_tokens(self) -> int:
        """The most tokens (flags bytes) of any block: the trip count of
        ops/decode.py's token parse."""
        return int(self.flags_len.max()) if self.n_blocks else 0

    def family_arg(self, device):
        """lz_decode's `family`: one int for the batch, or the per-block
        tensor on `device` where the blocks mix families."""
        if self.block_family is None:
            return int(self.codewords == Codewords.LIZv1)
        return self.block_family.to(device)

    def block_table(self) -> torch.Tensor:
        """(n_blocks, 8) int64: the TABLE_FIELDS columns side by side."""
        return torch.stack([getattr(self, f) for f in TABLE_FIELDS], dim=1)

    def validate(self) -> None:
        """Raise CorruptError unless every block's streams lie inside the
        flat tensors (the kernel trusts the table)."""
        for data, off, ln in ((self.flags, self.flags_off, self.flags_len),
                              (self.literals, self.lit_off, self.lit_len),
                              (self.off16, self.off16_off, self.off16_len),
                              (self.off24, self.off24_off, self.off24_len)):
            if self.n_blocks and (bool((off < 0).any()) or bool((ln < 0).any())
                                  or bool((off + ln > data.numel()).any())):
                raise CorruptError("block table outside the stream tensors")


def _le24(b, i):
    return int(b[i]) | (int(b[i + 1]) << 8) | (int(b[i + 2]) << 16)


def _read_stream(src, ip, flag, hd=None, kind=None):
    """One stream at ip: (its bytes, the next ip). A Huffman-coded stream
    goes to hd(blob, orig, kind) when hd is given, and its result stands
    for the stream; else the native Huff0 decodes it."""
    if not flag:
        if ip > len(src) - 3:
            raise CorruptError("stream header truncated")
        n = _le24(src, ip)
        start = ip + 3
        if start + n > len(src):
            raise CorruptError("stream truncated")
        return src[start:start + n], start + n
    if ip > len(src) - 6:
        raise CorruptError("huf stream header truncated")
    orig = _le24(src, ip)
    comp = _le24(src, ip + 3)
    if ip + 6 + comp > len(src):
        raise CorruptError("huf stream truncated")
    blob = bytes(src[ip + 6:ip + 6 + comp])
    if hd is not None:
        return hd(blob, orig, kind), ip + 6 + comp
    data = runtime.huf_decompress(blob, orig)
    return np.frombuffer(data, dtype=np.uint8), ip + 6 + comp


def split_stored(data: bytes, batch: dict, stream_id: int) -> None:
    """Append `data` to `batch` as literal-only inner blocks of at most
    LIZARD_BLOCK_SIZE bytes each (a stored frame block in a linked chain),
    of no codeword family of their own."""
    data = np.frombuffer(data, dtype=np.uint8)
    for pos in range(0, len(data), LIZARD_BLOCK_SIZE):
        _append(batch, stream_id, None, flags=np.zeros(0, np.uint8),
                literals=data[pos:pos + LIZARD_BLOCK_SIZE],
                off16=np.zeros(0, np.uint8), off24=np.zeros(0, np.uint8))


def split_stream(src: bytes, batch: dict, stream_id: int,
                 hd=None) -> Codewords:
    """Split one compressed stream (level byte + inner blocks) into `batch`
    accumulator lists. Returns the codeword family. `hd(blob, orig, kind)`,
    when given, stands in for every Huffman-coded stream (see
    _read_stream); kind is its name in STREAMS."""
    src = np.frombuffer(src, dtype=np.uint8)
    if len(src) < 1:
        raise CorruptError("empty stream")
    level = int(src[0])
    if level < LIZARD_MIN_CLEVEL or level > LIZARD_MAX_CLEVEL:
        raise CorruptError(f"bad level {level}")
    family = LEVELS[level].codewords

    ip = 1
    iend = len(src)
    while ip < iend:
        header = int(src[ip])
        ip += 1
        if header == FLAG_UNCOMPRESSED:
            if ip > iend - 3:
                raise CorruptError("uncompressed block header truncated")
            n = _le24(src, ip)
            ip += 3
            if ip + n > iend:
                raise CorruptError("uncompressed block truncated")
            _append(batch, stream_id, family,
                    flags=np.zeros(0, np.uint8),
                    literals=src[ip:ip + n],
                    off16=np.zeros(0, np.uint8),
                    off24=np.zeros(0, np.uint8))
            ip += n
            continue
        if header & FLAG_LEN:
            raise CorruptError("FLAG_LEN set")
        if header & ~(FLAG_LITERALS | FLAG_FLAGS | FLAG_OFFSET16 | FLAG_OFFSET24):
            raise CorruptError(f"bad header byte {header}")
        _, ip = _read_stream(src, ip, 0)          # "len" stream: unused
        o16, ip = _read_stream(src, ip, header & FLAG_OFFSET16, hd, "off16")
        o24, ip = _read_stream(src, ip, header & FLAG_OFFSET24, hd, "off24")
        flags, ip = _read_stream(src, ip, header & FLAG_FLAGS, hd, "flags")
        lits, ip = _read_stream(src, ip, header & FLAG_LITERALS, hd,
                                "literals")
        _append(batch, stream_id, family, flags=flags, literals=lits,
                off16=o16, off24=o24)
    return family


def inner_block_end(src: bytes, ip: int) -> int:
    """The end in `src` of the inner block whose header byte is at `ip`,
    from the headers alone; raises CorruptError when it lies past the end
    of `src`."""
    n = len(src)
    header = src[ip]
    ip += 1
    if header == FLAG_UNCOMPRESSED:
        ip += 3 + (_le24(src, ip) if ip + 3 <= n else 0)
    else:
        for bit in (0, FLAG_OFFSET16, FLAG_OFFSET24, FLAG_FLAGS,
                    FLAG_LITERALS):
            if ip + (6 if header & bit else 3) > n:
                raise CorruptError("stream header truncated")
            ip += (6 + _le24(src, ip + 3) if header & bit
                   else 3 + _le24(src, ip))
    if ip > n:
        raise CorruptError("inner block truncated")
    return ip


def inner_block_spans(src: bytes) -> list[tuple[int, int]]:
    """The byte span (start, end) in `src` of every inner block of one
    compressed stream (after its level byte), from the headers alone."""
    spans, ip = [], 1
    while ip < len(src):
        spans.append((ip, inner_block_end(src, ip)))
        ip = spans[-1][1]
    return spans


def _append(batch, stream_id, family, **streams):
    for name, arr in streams.items():
        batch[name].append(arr)
    batch["stream_id"].append(stream_id)
    batch["family"].append(family)


def new_accumulator() -> dict:
    return {"flags": [], "literals": [], "off16": [], "off24": [],
            "stream_id": [], "family": []}


def finalize(batch: dict, codewords: Codewords) -> BlockBatch:
    def cat(name):
        arrs = batch[name]
        flat = np.concatenate(arrs) if arrs else np.zeros(0, np.uint8)
        lens = torch.tensor([len(a) for a in arrs], dtype=torch.int64)
        offs = torch.cumsum(lens, 0) - lens
        return torch.from_numpy(np.ascontiguousarray(flat)), offs, lens

    flags, f_off, f_len = cat("flags")
    lits, l_off, l_len = cat("literals")
    o16, s_off, s_len = cat("off16")
    o24, b_off, b_len = cat("off24")
    fams = {f for f in batch["family"] if f is not None}
    block_family = None
    if len(fams) > 1:       # a literal-only block takes the batch's family
        block_family = torch.tensor(
            [(f or codewords) == Codewords.LIZv1 for f in batch["family"]],
            dtype=torch.uint8)
    return BlockBatch(
        codewords=codewords,
        n_blocks=len(batch["stream_id"]),
        flags=flags, literals=lits, off16=o16, off24=o24,
        flags_off=f_off, flags_len=f_len,
        lit_off=l_off, lit_len=l_len,
        off16_off=s_off, off16_len=s_len,
        off24_off=b_off, off24_len=b_len,
        stream_id=torch.tensor(batch["stream_id"], dtype=torch.int64),
        block_family=block_family,
    )


def split_into(streams: list[bytes], acc: dict, hd=None) -> Codewords:
    """Split every stream into the accumulator `acc` (stream i gets id i);
    returns the batch's codeword family. Raises CorruptError when the
    streams mix families (decompress_lanes takes one family, as in the
    JAX package; frames may mix them, see frame.py)."""
    family = None
    for i, s in enumerate(streams):
        f = split_stream(s, acc, i, hd)
        if family is None:
            family = f
        elif family != f:
            raise CorruptError("mixed codeword families in one batch")
    return family or Codewords.LZ4


def split_streams(streams: list[bytes], entropy: str = "host",
                  device=None) -> BlockBatch:
    """Split multiple independent compressed streams into one batch.

    entropy="host" decodes Huffman-coded streams inline with the native
    Huff0. entropy="gpu" leaves each as a hole and then decodes every
    blob of the batch in one huf_decompress_128 call on `device` (the card
    unless device="cpu"), and fills the holes; the batch is on the CPU
    either way. (The main path, ops/fuse.py, fills the holes on the card
    instead and never brings the entropy bytes back.)"""
    if entropy not in ("host", "gpu"):
        raise ValueError(f"unknown entropy route {entropy!r}")
    acc = new_accumulator()
    if entropy == "host":
        with profiling.span("split", "host"):
            return finalize(acc, split_into(streams, acc))
    pend = []

    def hole(blob, orig, kind):
        buf = np.zeros(orig, np.uint8)
        pend.append((blob, orig, buf))
        return buf
    with profiling.span("split", "host"):
        family = split_into(streams, acc, hole)
    if pend:
        outs = huf_decompress_128([(blob, orig) for blob, orig, _ in pend],
                                  device=device)
        for (_, _, buf), out in zip(pend, outs):
            buf[:] = np.frombuffer(out, np.uint8)
    return finalize(acc, family)


def from_reference_batch(fields: dict[str, np.ndarray], codewords) -> BlockBatch:
    """Build a BlockBatch from the arrays of a lizard_tpu BlockBatch (as
    numpy; the same field names), so that one post-split state can be fed to
    both decoders. `codewords` is a Codewords of either package or its value
    string ("LZ4", "LIZv1")."""
    cw = Codewords(getattr(codewords, "value", codewords))
    t = {name: torch.from_numpy(np.ascontiguousarray(fields[name], np.uint8))
         for name in STREAMS}
    for name in TABLE_FIELDS + ("stream_id",):
        t[name] = torch.from_numpy(np.asarray(fields[name]).astype(np.int64))
    batch = BlockBatch(codewords=cw, n_blocks=int(t["stream_id"].numel()), **t)
    batch.validate()
    return batch
