# Frozen copy of lizard_tpu_torch/ref/huf.py at commit 0be7bf655f3d0745fc3f06a33be719434c2ddeea, with its imports
# pointing into h100_bench.reference. Later changes to the program do not reach it.
"""Huff0 + FSE decoding on the host: the port's copy of the header side of
lizard_tpu/ref/huf.py (bit-exact with the reference entropy backend).

The decode plan of ops/huf128.py needs `huf_read_stats` (the weights header,
raw 4-bit nibbles or FSE-compressed) and the canonical decode table of
`huf_build_dtable`; `huf_decompress` is the scalar 4-stream decoder, kept as
a second oracle for the tests. Semantics (reference sources):

- backward bitstream: lib/entropy/bitstream.h:255-338 (init from the last
  byte's end-mark bit; reads proceed from the high end downward; over-reads
  supply zero bits; a stream is valid iff exactly consumed)
- FSE NCount header:  lib/entropy/entropy_common.c:71-160
- FSE decode tables:  lib/entropy/fse_decompress.c:113-168
- Huffman weights:    lib/entropy/entropy_common.c:170-231 (headerByte>=128:
  raw 4-bit nibbles; else FSE-compressed; last weight implied)
- canonical table:    lib/entropy/huf_decompress.c:87-133
- 4-stream layout:    lib/entropy/huf_decompress.c:231-321 (6-byte jump
  table of 3 LE16 lengths; segmentSize=(dstSize+3)/4)
- entry special cases: lib/entropy/huf_decompress.c:833-845 (csize==dsize:
  stored; csize==1: RLE)
"""

from h100_bench.reference.errors import HufError

HUF_TABLELOG_MAX = 12
FSE_MIN_TABLELOG = 5
FSE_TABLELOG_ABSOLUTE_MAX = 15


class BitReader:
    """Backward bitstream: big-int model of BIT_DStream_t.

    `pos` counts remaining payload bits; reads take the top `n` bits.
    Over-reads (pos<0) supply zero bits, mirroring the C container shifts.
    """

    __slots__ = ("bits", "pos")

    def __init__(self, blob: bytes):
        if len(blob) < 1:
            raise HufError("empty bitstream")
        if blob[-1] == 0:
            raise HufError("missing end mark")
        self.bits = int.from_bytes(blob, "little")
        self.pos = self.bits.bit_length() - 1  # strip the end-mark bit

    def look(self, n: int) -> int:
        if n == 0:
            return 0
        if self.pos >= n:
            return (self.bits >> (self.pos - n)) & ((1 << n) - 1)
        # over-read: low bits are zeros
        avail = max(self.pos, 0)
        return ((self.bits & ((1 << avail) - 1)) << (n - avail)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos -= n

    def read(self, n: int) -> int:
        v = self.look(n)
        self.skip(n)
        return v

    @property
    def overflowed(self) -> bool:
        return self.pos < 0

    @property
    def exhausted_exactly(self) -> bool:
        return self.pos == 0


def _highbit32(v: int) -> int:
    return v.bit_length() - 1


# ---------------------------------------------------------------- FSE ------

def fse_read_ncount(src: bytes):
    """FSE_readNCount (entropy_common.c:71-160): returns
    (normalized_counts list, table_log, bytes_consumed)."""
    if len(src) < 4:
        raise HufError("ncount too small")
    # the C code's 32-bit sliding read, modelled by one big int over the
    # buffer; zero padding past the end is equivalent for valid headers
    # (the consumed-bytes check below catches overruns)
    total = int.from_bytes(src + b"\x00" * 8, "little")
    table_log = (total & 0xF) + FSE_MIN_TABLELOG
    if table_log > FSE_TABLELOG_ABSOLUTE_MAX:
        raise HufError("tableLog too large")
    bit = 4
    remaining = (1 << table_log) + 1
    threshold = 1 << table_log
    nb_bits = table_log + 1
    counts = []
    prev0 = False

    while remaining > 1 and len(counts) <= 255:
        if prev0:
            # runs of zero counts
            while (total >> bit) & 0xFFFF == 0xFFFF:
                counts.extend([0] * 24)
                bit += 16
            while (total >> bit) & 3 == 3:
                counts.extend([0] * 3)
                bit += 2
            counts.extend([0] * ((total >> bit) & 3))
            bit += 2
        maxv = (2 * threshold - 1) - remaining
        val = (total >> bit) & (threshold - 1)
        if val < maxv:
            count = val
            bit += nb_bits - 1
        else:
            count = (total >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= maxv
            bit += nb_bits
        count -= 1  # extra accuracy; -1 means "less than 1" (prob=-1)
        remaining -= -count if count < 0 else count
        counts.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1

    if remaining != 1:
        raise HufError("ncount corrupt")
    consumed = (bit + 7) >> 3
    if consumed > len(src):
        raise HufError("ncount overran")
    return counts, table_log, consumed


def fse_build_dtable(counts, table_log):
    """FSE_buildDTable (fse_decompress.c:113-168): list of
    (symbol, nb_bits, new_state)."""
    table_size = 1 << table_log
    high = table_size - 1
    symbols = [0] * table_size
    symbol_next = {}

    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            symbol_next[s] = 1
        else:
            symbol_next[s] = c

    step = (table_size >> 1) + (table_size >> 3) + 3
    mask = table_size - 1
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise HufError("fse table spread failed")

    table = []
    for u in range(table_size):
        s = symbols[u]
        next_state = symbol_next[s]
        symbol_next[s] += 1
        nb = table_log - _highbit32(next_state)
        table.append((s, nb, (next_state << nb) - table_size))
    return table


def fse_decompress(src: bytes, max_out: int) -> bytes:
    """FSE_decompress_wksp equivalent (fse_decompress.c:220-316)."""
    counts, table_log, n = fse_read_ncount(src)
    if table_log > 6:  # HUF weights cap (entropy_common.c:195)
        raise HufError("weights tableLog too large")
    table = fse_build_dtable(counts, table_log)
    br = BitReader(src[n:])
    states = [br.read(table_log), br.read(table_log)]
    out = bytearray()
    # strict alternation s1,s2,...; after a decode overflows the stream,
    # emit one symbol from the other state and stop
    cur = 0
    while True:
        if len(out) >= max_out:
            raise HufError("fse output too large")
        sym, nb, base = table[states[cur]]
        out.append(sym)
        states[cur] = base + br.read(nb)
        cur ^= 1
        if br.overflowed:
            out.append(table[states[cur]][0])
            break
    return bytes(out)


# ---------------------------------------------------------------- HUF ------

def huf_read_stats(src: bytes):
    """HUF_readStats (entropy_common.c:170-231): returns
    (weights list incl. implied last, table_log, bytes_consumed)."""
    if len(src) < 1:
        raise HufError("empty weights header")
    isize = src[0]
    if isize >= 128:
        # raw 4-bit nibbles
        osize = isize - 127
        isize = (osize + 1) // 2
        if isize + 1 > len(src):
            raise HufError("weights truncated")
        weights = [src[1 + i // 2] >> 4 if i % 2 == 0 else src[1 + i // 2] & 15
                   for i in range(osize)]
    else:
        if isize + 1 > len(src):
            raise HufError("weights truncated")
        weights = list(fse_decompress(src[1:1 + isize], 255))
    consumed = isize + 1

    total = 0
    for w in weights:
        if w >= HUF_TABLELOG_MAX:
            raise HufError("weight too large")
        total += (1 << w) >> 1
    if total == 0:
        raise HufError("all-zero weights")

    table_log = _highbit32(total) + 1
    if table_log > HUF_TABLELOG_MAX:
        raise HufError("huf tableLog too large")
    rest = (1 << table_log) - total
    if rest & (rest - 1):
        raise HufError("implied weight not a power of 2")
    weights.append(_highbit32(rest) + 1)

    rank1 = sum(1 for w in weights if w == 1)
    if rank1 < 2 or rank1 & 1:
        raise HufError("invalid weight distribution")
    return weights, table_log, consumed


def huf_build_dtable(weights, table_log):
    """X2 table (huf_decompress.c:111-130): dt[i] = (symbol, nbBits), as
    two bytearrays of 1 << table_log entries."""
    rank_next = [0] * (HUF_TABLELOG_MAX + 2)
    rank_count = [0] * (HUF_TABLELOG_MAX + 2)
    for w in weights:
        rank_count[w] += 1
    start = 0
    for n in range(1, table_log + 1):
        rank_next[n] = start
        start += rank_count[n] << (n - 1)

    size = 1 << table_log
    sym_arr = bytearray(size)
    bits_arr = bytearray(size)
    for sym, w in enumerate(weights):
        if w == 0:
            continue
        length = (1 << w) >> 1
        nb = table_log + 1 - w
        lo = rank_next[w]
        sym_arr[lo:lo + length] = bytes([sym]) * length
        bits_arr[lo:lo + length] = bytes([nb]) * length
        rank_next[w] += length
    return sym_arr, bits_arr


def _huf_decode_stream(br: BitReader, n_out: int, sym_arr, bits_arr,
                       table_log) -> bytes:
    out = bytearray(n_out)
    for i in range(n_out):
        v = br.look(table_log)
        out[i] = sym_arr[v]
        br.skip(bits_arr[v])
    if not br.exhausted_exactly:
        raise HufError("huf stream not exactly consumed")
    return bytes(out)


def huf_decompress(src: bytes, dst_size: int) -> bytes:
    """HUF_decompress (huf_decompress.c:833-845): 4-stream table decode with
    stored/RLE special cases."""
    if dst_size == 0:
        raise HufError("dst size 0")
    if len(src) > dst_size:
        raise HufError("csize > dsize")
    if len(src) == dst_size:
        return bytes(src)
    if len(src) == 1:
        return bytes([src[0]]) * dst_size

    weights, table_log, hsize = huf_read_stats(src)
    body = src[hsize:]
    if len(body) < 10:
        raise HufError("huf body too small")
    sym_arr, bits_arr = huf_build_dtable(weights, table_log)

    l1 = body[0] | (body[1] << 8)
    l2 = body[2] | (body[3] << 8)
    l3 = body[4] | (body[5] << 8)
    l4 = len(body) - 6 - l1 - l2 - l3
    if l4 < 0:
        raise HufError("jump table overflow")
    seg = (dst_size + 3) // 4
    sizes = [seg, seg, seg, dst_size - 3 * seg]
    if sizes[3] < 0:
        raise HufError("bad segmentation")
    out = bytearray()
    off = 6
    for ln, n_out in zip((l1, l2, l3, l4), sizes):
        br = BitReader(body[off:off + ln])
        out += _huf_decode_stream(br, n_out, sym_arr, bits_arr, table_log)
        off += ln
    return bytes(out)
