"""LZ block decode of post-entropy streams on the card: the port of
lizard_tpu/ops/lane_decode.py (decode_batch_lanes, decompress_lanes, and its
Pallas kernel `_lane_kernel`, here the CUDA kernels of csrc/lz_decode.cu).

A CHAIN is the consecutive inner blocks of one compressed stream (or of one
linked frame), which share one LZ77 window (64 KB for fastLZ4, up to 16 MB
for LIZv1). The output of chain c lies contiguously at its base (first
block index x LIZARD_BLOCK_SIZE). On the card the unit of work is the inner
block: one CTA decodes each block into a tile in shared memory, defers the
matches that reach before the block's start, and a second pass resolves
them against the chain's output (the design is in csrc/lz_decode.cu). None
of the TPU kernel's layout is needed: no (R,128) word pool, no slots or
bands, no VMEM ring or far window, and so no host fallback. A chain whose
non-final inner block is short decodes like any other.

`lz_decode` is the kernel wrapper; `lz_decode_plain` is the plain PyTorch
version with the same signature and outputs. A CPU tensor goes to the plain
version; a CUDA tensor launches the kernels or raises. Its calls and kernel
launches are counted in utils/profiling.py as "lz_decode.launches" and
"lz_decode.kernel_launches".
"""

import ctypes

import torch

from lizard_tpu_torch.device import resolve_device
from lizard_tpu_torch.errors import CorruptError
from lizard_tpu_torch.format.constants import (
    LIZARD_BLOCK_SIZE,
    LIZARD_LAST_LONG_OFF,
    MAX_SHORT_LITLEN,
    MAX_SHORT_MATCHLEN,
    MINMATCH,
    ML_MASK_LZ4,
    ML_RUN_BITS,
    MM_LONGOFF,
    RUN_BITS_LIZ,
    RUN_BITS_LZ4,
    RUN_MASK_LZ4,
)
from lizard_tpu_torch.ops import _build
from lizard_tpu_torch.ops.split import STREAMS, BlockBatch, split_streams
from lizard_tpu_torch.utils import profiling

# per-chain status codes, shared with csrc/lz_decode.cu
OK = 0
ERR_LEN_EXT = -1        # length extension past the literals stream
ERR_LITERALS = -2       # literal run past its margin (iend-(2+16) / iend-16)
ERR_OFFSET = -3         # offset 0 or before the chain's start
ERR_OFF16 = -4          # off16 stream overrun
ERR_OFF24 = -5          # off24 stream overrun
ERR_REP0 = -6           # non-empty repeat match with last_off == 0
ERR_CAPACITY = -7       # block output beyond LIZARD_BLOCK_SIZE
STATUS_TEXT = {
    ERR_LEN_EXT: "length extension past literals end",
    ERR_LITERALS: "literals overrun",
    ERR_OFFSET: "offset out of window",
    ERR_OFF16: "off16 overrun",
    ERR_OFF24: "off24 overrun",
    ERR_REP0: "rep match with last_off==0",
    ERR_CAPACITY: "block output exceeds LIZARD_BLOCK_SIZE",
}


def chain_table(stream_id: torch.Tensor) -> torch.Tensor:
    """(n_chains, 3) int64 rows (first block, block count, output base) for
    the runs of equal consecutive stream ids. A chain's output capacity is
    its block count x LIZARD_BLOCK_SIZE, starting at its base."""
    n = stream_id.numel()
    if n == 0:
        return torch.zeros((0, 3), dtype=torch.int64)
    new = torch.ones(n, dtype=torch.bool)
    new[1:] = stream_id[1:] != stream_id[:-1]
    first = torch.nonzero(new).flatten()
    count = torch.diff(first, append=torch.tensor([n]))
    return torch.stack([first, count, first * LIZARD_BLOCK_SIZE], dim=1)


def stage_batch(batch: BlockBatch, device) -> dict:
    """Move a batch to `device` once: the four flat streams, the block
    table and the chain table, as the keyword arguments of lz_decode."""
    batch.validate()
    host = {name: getattr(batch, name) for name in STREAMS}
    host["blocks"] = batch.block_table()
    host["chains"] = chain_table(batch.stream_id)
    with profiling.span("stage", "device"):
        args = {name: t.to(device) for name, t in host.items()}
        args["family"] = batch.family_arg(device)
    profiling.count_bytes("h2d_bytes", *(
        t for t in args.values() if isinstance(t, torch.Tensor)))
    return args


def _check(flags, literals, off16, off24, blocks, chains, family):
    dev = flags.device
    for name, t in (("flags", flags), ("literals", literals),
                    ("off16", off16), ("off24", off24)):
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, flags on {dev}")
    for name, t, width in (("blocks", blocks, 8), ("chains", chains, 3)):
        if (t.dtype != torch.int64 or t.dim() != 2 or t.shape[1] != width
                or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous (n, {width}) int64 tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, flags on {dev}")
    if isinstance(family, torch.Tensor):
        if (family.dtype != torch.uint8 or family.shape != (blocks.shape[0],)
                or not family.is_contiguous()):
            raise ValueError("a per-block family must be a contiguous "
                             "(n_blocks,) uint8 tensor")
        if family.device != dev:
            raise ValueError(f"family is on {family.device}, flags on {dev}")
    elif family not in (0, 1):
        raise ValueError(f"family must be 0 (fastLZ4) or 1 (LIZv1), got {family}")


def _outputs(blocks, chains, device):
    n_blocks, n_chains = blocks.shape[0], chains.shape[0]
    out = torch.empty(n_blocks * LIZARD_BLOCK_SIZE, dtype=torch.uint8,
                      device=device)
    block_len = torch.empty(n_blocks, dtype=torch.int32, device=device)
    status = torch.empty(n_chains, dtype=torch.int32, device=device)
    return out, block_len, status


# meta columns of lz_decode_meta (per block: pass1's result, jump's rounds)
(META_STATUS, META_REACH, META_DEFERRED, META_DEFERRED_BYTES,
 META_ROUNDS) = range(5)
# the most inner blocks of one chain on the card: pass 2 keeps chain
# positions in 32 bits (csrc/lz_decode.cu)
MAX_CHAIN_BLOCKS = (1 << 32) // LIZARD_BLOCK_SIZE


def check_chain_blocks(chains, n_blocks: int) -> None:
    """Raise ValueError if a chain has more than MAX_CHAIN_BLOCKS inner
    blocks. No chain of chain_table's rows has more than n_blocks -
    n_chains + 1, so the table is read (a copy from the card) only when
    that bound does not settle it."""
    if n_blocks - chains.shape[0] + 1 <= MAX_CHAIN_BLOCKS:
        return
    longest = int(chains[:, 1].max())
    if longest > MAX_CHAIN_BLOCKS:
        raise ValueError(
            f"a chain of {longest} inner blocks: lz_decode on the card "
            f"decodes at most {MAX_CHAIN_BLOCKS} (4 GiB) in one chain")


def _launcher():
    """The C entry of csrc/lz_decode.cu: every pointer and the stream as
    c_void_p (an undeclared pointer would be cut to 32 bits)."""
    fn = _build.load("lz_decode").lz_decode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p,
                                            ctypes.c_int64, ctypes.c_void_p,
                                            ctypes.c_int]
                   + [ctypes.c_void_p] * 12)
    return fn


def lz_decode(flags, literals, off16, off24, blocks, chains, family):
    """Decode every chain of a staged batch (see stage_batch).

    `chains` rows are chain_table's: disjoint runs of blocks in block
    order; `family` is 0 (fastLZ4) or 1 (LIZv1) for every block, or a
    uint8 tensor of one per block. Returns (out uint8 [n_blocks *
    LIZARD_BLOCK_SIZE], block_len int32 [n_blocks], status int32
    [n_chains]). Chain c's bytes lie contiguously at out[chains[c, 2]:],
    its blocks' lengths in block_len; status 0 = ok, negative = corrupt
    (STATUS_TEXT), and then the lengths of the failing block and every
    later block of the chain are -1. Bytes past a chain's decoded length,
    and every byte of a corrupt chain, are undefined.

    CUDA tensors launch csrc/lz_decode.cu on the current stream without
    synchronising: two kernels when every chain is one block, five when a
    chain has more (counted as "lz_decode.kernel_launches", the calls as
    "lz_decode.launches"). Pass 2's scratch, for the
    non-first blocks of chains only, is 4 bytes per byte of those blocks
    plus 12 bytes per flags byte; a chain has at most MAX_CHAIN_BLOCKS
    blocks (else ValueError). CPU tensors run lz_decode_plain."""
    _check(flags, literals, off16, off24, blocks, chains, family)
    with profiling.span("lz_decode", "device"):
        if flags.device.type == "cpu":
            return lz_decode_plain(flags, literals, off16, off24, blocks,
                                   chains, family)
        return lz_decode_meta(flags, literals, off16, off24, blocks, chains,
                              family)[:3]


def lz_decode_meta(flags, literals, off16, off24, blocks, chains, family):
    """lz_decode on CUDA tensors, with a per-block record beside the
    outputs: (out, block_len, status, meta int32 [n_blocks, 5]), meta's
    columns META_* (pass1: the block's own parse status, the farthest reach
    of its cross-block matches, its deferred copies and their bytes; jump:
    its pointer-jumping rounds, 0 when pass 2 did not run; undefined for a
    block in no chain). Counts as one lz_decode call."""
    _check(flags, literals, off16, off24, blocks, chains, family)
    n_blocks, n_chains = blocks.shape[0], chains.shape[0]
    check_chain_blocks(chains, n_blocks)
    if flags.device.type != "cuda":
        raise ValueError(f"lz_decode runs on cuda or cpu, not {flags.device}")
    dev = flags.device
    out, block_len, status = _outputs(blocks, chains, dev)
    meta = torch.empty((n_blocks, 5), dtype=torch.int32, device=dev)
    if n_chains == 0 or n_blocks == 0:
        return out, block_len, status, meta
    i32 = dict(dtype=torch.int32, device=dev)
    bchain = torch.empty(n_blocks, **i32)
    start = torch.empty(n_blocks, dtype=torch.int64, device=dev)
    cinfo = torch.empty(n_chains, **i32)
    # pass 2, for the non-first blocks of chains (csrc/lz_decode.cu)
    n_scratch = max(n_blocks - n_chains, 0)
    recs = bitmaps = ptr = None
    if n_scratch:
        recs = torch.empty(3 * max(flags.numel(), 1), **i32)
        bitmaps = torch.empty(n_scratch * (LIZARD_BLOCK_SIZE // 32), **i32)
        ptr = torch.empty(n_scratch * LIZARD_BLOCK_SIZE, **i32)
    per_block = isinstance(family, torch.Tensor)
    launched = ctypes.c_int32(0)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(flags.data_ptr(), literals.data_ptr(), off16.data_ptr(),
                 off24.data_ptr(), blocks.data_ptr(), n_blocks,
                 chains.data_ptr(), n_chains,
                 family.data_ptr() if per_block else None,
                 0 if per_block else family,
                 out.data_ptr(), block_len.data_ptr(), status.data_ptr(),
                 meta.data_ptr(), recs.data_ptr() if n_scratch else None,
                 bitmaps.data_ptr() if n_scratch else None,
                 bchain.data_ptr(), start.data_ptr(), cinfo.data_ptr(),
                 ptr.data_ptr() if n_scratch else None,
                 ctypes.addressof(launched), stream)
    profiling.count("lz_decode.kernel_launches", launched.value)
    if err != 0:
        raise RuntimeError(f"lz_decode launch failed: cudaError {err}")
    profiling.count("lz_decode.launches")
    return out, block_len, status, meta


def chain_outputs(out, block_len, chains) -> list[torch.Tensor]:
    """The decoded bytes of each chain of an lz_decode result whose status
    is OK, as views of `out` on its device."""
    lens = block_len.cpu().tolist()
    return [out[base:base + sum(lens[first:first + count])]
            for first, count, base in chains.cpu().tolist()]


class _Corrupt(Exception):
    def __init__(self, code):
        self.code = code


def _ext(lit: bytes, lp: int, iend: int) -> tuple[int, int]:
    """Length extension at lit[lp] (doc/lizard_Block_format.md:91-96):
    byte <254 -> value; 254 -> LE16 follows; 255 -> LE24 follows. Returns
    (value, new lp); every byte read must lie before iend."""
    if lp > iend - 1:
        raise _Corrupt(ERR_LEN_EXT)
    first = lit[lp]
    need = 1 if first < 254 else (3 if first == 254 else 4)
    if lp + need > iend:
        raise _Corrupt(ERR_LEN_EXT)
    if first == 254:
        return lit[lp + 1] | (lit[lp + 2] << 8), lp + 3
    if first == 255:
        return lit[lp + 1] | (lit[lp + 2] << 8) | (lit[lp + 3] << 16), lp + 4
    return first, lp + 1


def lz_decode_plain(flags, literals, off16, off24, blocks, chains, family):
    """The plain PyTorch version of lz_decode: same inputs, same outputs.

    A Python loop over tokens (the streams are read as host bytes); literal
    runs are tensor slices, and matches gather the index tensor
    `start + arange(len) % off` from the output, on the inputs' device.
    The semantics and the order of the corruption checks are those of
    lizard_tpu/ref/block_decode.py (stricter only where that oracle would
    read past a stream's end)."""
    _check(flags, literals, off16, off24, blocks, chains, family)
    dev = flags.device
    out, block_len, status = _outputs(blocks, chains, dev)
    host = {n: t.cpu().numpy().tobytes() for n, t in
            zip(STREAMS, (flags, literals, off16, off24))}
    table = blocks.cpu().tolist()
    fams = (family.cpu().tolist() if isinstance(family, torch.Tensor)
            else [family] * len(table))
    lens = [-1] * len(table)
    codes = []
    for first, count, base in chains.cpu().tolist():
        op = 0                                    # chain-relative output
        code = OK
        for b in range(first, first + count):
            bstart = op
            try:
                op = _decode_block(host, table[b], fams[b], literals, out,
                                   base, op, bstart + LIZARD_BLOCK_SIZE)
            except _Corrupt as e:
                code = e.code
                break
            lens[b] = op - bstart
        codes.append(code)
    block_len.copy_(torch.tensor(lens, dtype=torch.int32))
    status.copy_(torch.tensor(codes, dtype=torch.int32))
    return out, block_len, status


def _decode_block(host, row, family, literals, out, base, op, bend):
    """One inner block: returns the chain-relative output position after
    it. out[base + p] holds chain byte p; bend caps the block's output.
    `host` holds the flat streams as bytes (for the token parse),
    `literals` the flat literals tensor (for the copies)."""
    f0, flen, l0, llen, s0, slen, t0, tlen = row
    fl = host["flags"][f0:f0 + flen]
    lit = host["literals"][l0:l0 + llen]
    o16 = host["off16"][s0:s0 + slen]
    o24 = host["off24"][t0:t0 + tlen]
    iend = llen
    lp = p16 = p24 = 0
    last_off = 0

    def put_literals(op, lp, n):
        if op + n > bend:
            raise _Corrupt(ERR_CAPACITY)
        if n:
            out[base + op:base + op + n] = literals[l0 + lp:l0 + lp + n]
        return op + n

    def put_match(op, off, n):
        if op + n > bend:
            raise _Corrupt(ERR_CAPACITY)
        if n:
            start = base + op - off
            if off >= n:
                out[base + op:base + op + n] = out[start:start + n]
            else:
                idx = start + torch.arange(n, device=out.device) % off
                out[base + op:base + op + n] = out[idx]
        return op + n

    for token in fl:
        if family == 0:
            # fastLZ4 (lizard_decompress_lz4.h): lengths and the LE16
            # offset are read from the literals stream
            length = token & RUN_MASK_LZ4
            if length == RUN_MASK_LZ4:
                if lp > iend - 5:
                    raise _Corrupt(ERR_LEN_EXT)
                ext, lp = _ext(lit, lp, iend)
                length += ext
            if lp + length > iend - (2 + 16):
                raise _Corrupt(ERR_LITERALS)
            op = put_literals(op, lp, length)
            lp += length
            off = lit[lp] | (lit[lp + 1] << 8)
            lp += 2
            if off == 0 or op - off < 0:
                raise _Corrupt(ERR_OFFSET)
            length = token >> RUN_BITS_LZ4
            if length == ML_MASK_LZ4:
                if lp > iend - 5:
                    raise _Corrupt(ERR_LEN_EXT)
                ext, lp = _ext(lit, lp, iend)
                length += ext
            op = put_match(op, off, length + MINMATCH)
            continue
        # LIZv1 (lizard_decompress_liz.h); last_off resets per inner block
        if token >= 32:
            length = token & MAX_SHORT_LITLEN
            if length == MAX_SHORT_LITLEN:
                ext, lp = _ext(lit, lp, iend)
                length += ext
            if lp > iend - 16 or lp + length > iend:
                raise _Corrupt(ERR_LITERALS)
            op = put_literals(op, lp, length)
            lp += length
            if token >> ML_RUN_BITS == 0:         # new 16-bit offset
                if p16 + 2 > len(o16):
                    raise _Corrupt(ERR_OFF16)
                last_off = o16[p16] | (o16[p16 + 1] << 8)
                p16 += 2
            length = (token >> RUN_BITS_LIZ) & MAX_SHORT_MATCHLEN
            if length == MAX_SHORT_MATCHLEN:
                ext, lp = _ext(lit, lp, iend)
                length += ext
        else:
            if token < LIZARD_LAST_LONG_OFF:      # ML = token+16, off24
                length = token + MM_LONGOFF
            else:                                 # token 31: ext ML first
                ext, lp = _ext(lit, lp, iend)
                length = ext + LIZARD_LAST_LONG_OFF + MM_LONGOFF
            if p24 > len(o24) - 3:
                raise _Corrupt(ERR_OFF24)
            last_off = o24[p24] | (o24[p24 + 1] << 8) | (o24[p24 + 2] << 16)
            p24 += 3
        if last_off == 0:
            if length != 0:
                raise _Corrupt(ERR_REP0)
        elif op - last_off < 0:
            raise _Corrupt(ERR_OFFSET)
        op = put_match(op, last_off, length)
    # last literals: whatever remains of the literals stream
    return put_literals(op, lp, iend - lp)


def raise_on_status(batch: BlockBatch, chains, status) -> None:
    """Raise CorruptError naming the stream of the first corrupt chain of
    an lz_decode result."""
    profiling.count_bytes("d2h_bytes", status)
    status = status.cpu()
    bad = torch.nonzero(status != OK).flatten()
    if bad.numel():
        c = int(bad[0])
        sid = int(batch.stream_id[int(chains[c, 0])])
        raise CorruptError(f"stream {sid}: {STATUS_TEXT[int(status[c])]}")


def read_blocks(batch: BlockBatch, args: dict, out, block_len,
                status, first: int = 0) -> list[bytes]:
    """The decoded bytes of the blocks from index `first` on of an
    lz_decode result, in batch order: one copy back to the host, of the
    span of `out` those blocks cover (blocks before `first`, such as a
    history that heads a chain, are not copied). Raises CorruptError on a
    corrupt chain. `args` is the staged batch the result came from."""
    with profiling.span("readback", "device"):
        chains = args["chains"]
        profiling.count_bytes("d2h_bytes", chains, block_len)
        chains = chains.cpu()
        raise_on_status(batch, chains, status)
        lens = block_len.cpu().tolist()
        spans = []                              # (output position, length)
        for c0, count, base in chains.tolist():
            pos = base
            for b in range(c0, c0 + count):
                if b >= first:
                    spans.append((pos, lens[b]))
                pos += lens[b]
        if not spans:
            return []
        lo, hi = spans[0][0], max(p + n for p, n in spans)
        profiling.count("d2h_bytes", hi - lo)
        data = out[lo:hi].cpu().numpy()
    with profiling.span("answer", "host"):
        return [data[p - lo:p - lo + n].tobytes() for p, n in spans]


def decode_batch_lanes(batch: BlockBatch, device=None,
                       first: int = 0) -> list[bytes]:
    """Decode a BlockBatch (fastLZ4 or LIZv1 codewords) on `device` (the
    card unless device="cpu"). Returns the decoded bytes of every block
    from index `first` on, in batch order (read_blocks). Raises
    CorruptError on a corrupt chain."""
    args = stage_batch(batch, resolve_device(device))
    return read_blocks(batch, args, *lz_decode(**args), first=first)


def join_streams(batch: BlockBatch, blocks: list[bytes],
                 n_streams: int) -> list[bytes]:
    """The decoded bytes of each of n_streams streams, from its blocks."""
    with profiling.span("answer", "host"):
        parts = [[] for _ in range(n_streams)]
        for sid, data in zip(batch.stream_id.tolist(), blocks):
            parts[sid].append(data)
        return [b"".join(p) for p in parts]


@profiling.traced("decompress_lanes", "host")
def decompress_lanes(streams: list[bytes], device=None,
                     entropy: str = "gpu") -> list[bytes]:
    """Decode independent compressed streams (either codeword family, all
    of one family) on `device`; returns the decoded bytes per stream.

    entropy="gpu" (the default) decodes the Huffman-coded streams of
    levels 30-49 with the Huff0 kernel straight into the LZ kernel's
    inputs (ops/fuse.py::decompress_lanes_fused); entropy="host" decodes
    them in the host split with the native Huff0 first. A batch with no
    Huffman stream takes the same path either way."""
    dev = resolve_device(device)
    if entropy == "gpu":
        # ops.fuse builds on this module, so it is imported here
        from lizard_tpu_torch.ops.fuse import decompress_lanes_fused
        return decompress_lanes_fused(streams, device=dev)
    if entropy != "host":
        raise ValueError(f"unknown entropy route {entropy!r}")
    batch = split_streams(streams, entropy="host")
    return join_streams(batch, decode_batch_lanes(batch, device=dev),
                        len(streams))
